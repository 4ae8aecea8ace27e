"""Near field (P2P) of the FMM against a plain numpy f64 sum.

The single-device leaf pass runs the row-chunk scan (``form="rows"``); the
row-sharded leaf pass runs the bucketed-tile form (``form="tiles"``). Both
must reproduce the direct sum over each target leaf's u-list, for every
registry kernel: to f64 round-off in the f64 tier (the tiles hold f64
coordinates) and to f32 grade in the f32 tier.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from ferreus_rbf.config import FmmCompressionType, FmmParams
from ferreus_rbf.ops.fmm.api import FmmTree
from ferreus_rbf.ops.fmm.diagnostics import near_field_reference
from ferreus_rbf.ops.kernels import KernelParams, KernelType

# f32: each target sums ~10^3 terms rounded at 2^-24; 1/r^4 at the closest
# pairs amplifies coordinate rounding 4x (measured <= 1.4e-6 on the CPU).
TOL = {"f64": 1e-12, "f32": 1e-5}


@functools.lru_cache(maxsize=None)
def _case(kt):
    rng = np.random.default_rng(19)
    pts = rng.random((1500, 3))
    w = rng.standard_normal((1500, 2))
    params = FmmParams(interpolation_order=4, max_points_per_cell=48,
                       compression_type=FmmCompressionType.ACA, epsilon=1e-4)
    kp = KernelParams(kt, base_range=1.0, total_sill=0.7)
    tree = FmmTree(pts, 4, kp, adaptive_tree=True, sparse=True, params=params)
    tree.prepare_targets(pts, "src")
    return tree, w, near_field_reference(tree, w, pts)


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("kt", list(KernelType))
def test_near_field_forms_match_numpy(kt, prec):
    tree, w, ref = _case(kt)
    scale = np.max(np.abs(ref))
    for form in ("rows", "tiles"):
        got = np.asarray(tree.near_field_device(jnp.asarray(w), "src",
                                                precision=prec, form=form))
        assert got.shape == ref.shape
        err = np.max(np.abs(got - ref)) / scale
        assert err <= TOL[prec], (form, err)
