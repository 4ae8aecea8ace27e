"""ferreus_rbf: fast global RBF interpolation in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
``graphic-goose/ferreus_rbf_rs`` (Rust reference): O(N log N) black-box fast
multipole (BBFMM) kernel summation, FGMRES + multilevel overlapping
additive-Schwarz domain-decomposition solves of the dense symmetric RBF
system, and surface-following regularised marching tetrahedra isosurface
extraction:

* the octree is a *level-batched padded array* structure built on the host and
  shipped to the device as a static pytree (no hashmaps in the compute path),
* every FMM pass (P2M/M2M/M2L/L2L/P2P/M2P/P2L/L2P) is a batched einsum /
  matmul, with multi-RHS blocking throughout,
* the iterative solver's hot loop runs as jitted device code; setup-time
  combinatorics (tree build, domain decomposition, pivoted QR) stay on the
  host where they belong,
* multi-device scaling uses ``jax.sharding`` meshes (RHS- and cell-sharding),
  not a message-passing port.

All numerics are float64 (the reference is f64 end-to-end, and interpolation
parity to ~1e-8 requires it), so x64 mode is enabled at import.
"""

import os as _os

import jax as _jax

_jax.config.update("jax_enable_x64", True)
# True-f32 matmuls: on the GPU an f32 dot may run in TF32 (~1e-3 relative
# error), which would defeat the mixed-precision solver's f32 inner
# iterations. "highest" keeps full f32 products and accumulation.
_jax.config.update("jax_default_matmul_precision", "highest")


def _compile_cache_dir(environ=_os.environ):
    """Where the persistent compilation cache goes.

    ``None`` when ``JAX_COMPILATION_CACHE_DIR`` is set: JAX reads that
    variable itself and no other directory is set here. Otherwise one
    fixed directory inside the checkout (``<repo>/.jax_cache``, listed in
    ``.gitignore``), so a later process finds what an earlier one compiled.
    """
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    root = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    return _os.path.join(root, ".jax_cache")


_cache_dir = _compile_cache_dir()
if _cache_dir is not None:
    _jax.config.update("jax_compilation_cache_dir", _cache_dir)

from .interpolant_config import (  # noqa: E402
    Drift,
    FittingAccuracy,
    FittingAccuracyType,
    InterpolantSettings,
    RBFKernelType,
    SpheroidalOrder,
    get_min_drift,
)
from .config import (  # noqa: E402
    DDMParams,
    FmmCompressionType,
    FmmParams,
    Params,
    Solvers,
)
from .models.rbf import Coefficients, RBFInterpolator  # noqa: E402
from .models.global_trend import GlobalTrend, GlobalTrendTransform  # noqa: E402
from .models.test_functions import RBFTestFunctions  # noqa: E402
from .utils.common import (  # noqa: E402
    create_evaluation_grid,
    csv_to_point_arrays,
    generate_random_points,
    pad_and_snap_extents,
    point_arrays_to_csv,
)
from .progress import (  # noqa: E402
    Progress,
    ProgressMsg,
    closure_sink,
)
from .isosurfacing import BoundaryClosure, ClusterMethod, Mesh  # noqa: E402

__all__ = [
    "BoundaryClosure",
    "ClusterMethod",
    "Coefficients",
    "DDMParams",
    "Drift",
    "FittingAccuracy",
    "FittingAccuracyType",
    "FmmCompressionType",
    "FmmParams",
    "GlobalTrend",
    "GlobalTrendTransform",
    "InterpolantSettings",
    "Mesh",
    "Params",
    "Progress",
    "ProgressMsg",
    "RBFInterpolator",
    "RBFKernelType",
    "RBFTestFunctions",
    "Solvers",
    "SpheroidalOrder",
    "closure_sink",
    "create_evaluation_grid",
    "csv_to_point_arrays",
    "generate_random_points",
    "get_min_drift",
    "pad_and_snap_extents",
    "point_arrays_to_csv",
]

__version__ = "0.1.0"
