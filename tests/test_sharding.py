"""Multi-device (8-CPU virtual mesh) sharding tests.

SURVEY.md section 2.6/5.8: the reference's rayon shared-memory parallelism
maps to SPMD over a ``jax.sharding.Mesh``. These tests assert that the
sharded execution paths produce the SAME bits as single-device execution:
each internal point belongs to exactly one Schwarz domain (disjointness by
DDM construction), so the cross-device scatter-add only ever adds zeros to
a single contribution and f64 equality is exact.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import ferreus_rbf as frt
from ferreus_rbf.config import DDMParams, FmmCompressionType, FmmParams, Params
from ferreus_rbf.interpolant_config import (
    FittingAccuracy,
    FittingAccuracyType,
    InterpolantSettings,
    RBFKernelType,
)
from ferreus_rbf.ops.fmm.api import FmmTree
from ferreus_rbf.ops.kernels import KernelParams, KernelType
from ferreus_rbf.parallel import make_mesh, use_mesh
from ferreus_rbf.solver.ddm import DDMTree


@pytest.fixture(autouse=True)
def _eight_devices():
    """The tests build meshes of up to 8 devices: tests/conftest.py gives
    the CPU backend 8 virtual devices. Decided per test, never at import."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")


def _points(n=1100, seed=7):
    rng = np.random.default_rng(seed)
    return rng.random((n, 3))


def _settings():
    return InterpolantSettings(
        kernel_type=RBFKernelType.ThinPlateSpline,  # linear drift -> QTAQ k>0
        fitting_accuracy=FittingAccuracy(1e-5, FittingAccuracyType.Relative),
    )


def _ddm_params():
    return DDMParams(
        leaf_threshold=128, overlap_quota=0.5, coarse_ratio=0.5, coarse_threshold=300
    )


def test_solve_bucket_sharded_matches_single_device():
    """Schwarz fine-level solves: "sp"-sharded buckets == unsharded, bitwise."""
    pts = _points()
    settings = _settings()
    settings.set_basis_size(3)

    ddm_plain = DDMTree(pts, settings, _ddm_params(), factor_dtype=jnp.float64)
    mesh = make_mesh(8, ("sp", "rhs"))
    with use_mesh(mesh):
        ddm_shard = DDMTree(pts, settings, _ddm_params(), factor_dtype=jnp.float64)
    assert ddm_shard._sp > 1  # the mesh was picked up

    rng = np.random.default_rng(11)
    residual = rng.standard_normal((pts.shape[0] + settings.basis_size, 2))

    for lvl in range(len(ddm_plain.levels) - 1):
        out_plain = np.asarray(ddm_plain.solve_fine_level(lvl, residual))
        out_shard = np.asarray(ddm_shard.solve_fine_level(lvl, residual))
        assert np.array_equal(out_plain, out_shard), f"level {lvl} diverged"


def test_matvec_fused_with_mesh_replicated_weights():
    """FMM fused matvec: mesh-replicated weights == plain weights, bitwise."""
    pts = _points(n=900, seed=3)
    kparams = KernelParams(KernelType.ThinPlateSplineRbf, base_range=1.0, total_sill=1.0)
    params = FmmParams(
        interpolation_order=4,
        max_points_per_cell=96,
        compression_type=FmmCompressionType.ACA,
        epsilon=1e-5,
    )
    tree = FmmTree(pts, 4, kparams, adaptive_tree=True, sparse=True, params=params)
    tree.prepare_targets(pts, "src")

    rng = np.random.default_rng(5)
    w = rng.standard_normal((pts.shape[0], 2))

    vals_plain = np.asarray(tree.evaluate_device(jnp.asarray(w), "src"))

    mesh = make_mesh(8, ("sp", "rhs"))
    w_repl = jax.device_put(jnp.asarray(w), NamedSharding(mesh, P()))
    vals_mesh = np.asarray(tree.evaluate_device(w_repl, "src"))

    assert np.array_equal(vals_plain, vals_mesh)


def test_row_sharded_matvec_matches_single_device():
    """SURVEY §5.8(b): the FMM matvec's leaf pass row-sharded over "sp".

    Asserts (a) the sharded program at 4 devices == the same program on a
    1-device mesh, BITWISE (row partitioning does not change per-row
    reduction order); (b) it matches the standard unsharded matvec to f64
    round-off; (c) the per-device compiled program does measurably less
    work than the 1-device program (cost-analysis FLOPs shrink).
    """
    from ferreus_rbf.ops.fmm import api as fmm_api

    pts = _points(n=1600, seed=13)
    kparams = KernelParams(KernelType.CubicRbf, base_range=1.0, total_sill=1.0)
    params = FmmParams(
        interpolation_order=4,
        max_points_per_cell=64,
        compression_type=FmmCompressionType.ACA,
        epsilon=1e-5,
    )
    rng = np.random.default_rng(5)
    w = rng.standard_normal((pts.shape[0], 2))

    # standard unsharded matvec (no mesh captured)
    tree_plain = FmmTree(pts, 4, kparams, adaptive_tree=True, sparse=True, params=params)
    tree_plain.prepare_targets(pts, "src")
    assert tree_plain._mesh is None
    vals_plain = np.asarray(tree_plain.evaluate_device(jnp.asarray(w), "src"))

    mesh = make_mesh(8, ("sp", "rhs"))
    with use_mesh(mesh):
        tree = FmmTree(pts, 4, kparams, adaptive_tree=True, sparse=True, params=params)
    tree.prepare_targets(pts, "src")
    assert tree._mesh is not None  # the row-sharded route is active
    binned = tree._target_cache["src"]
    assert int(binned["tgt_idx"].shape[0]) % int(mesh.shape["sp"]) == 0

    vals_shard = np.asarray(tree.evaluate_device(jnp.asarray(w), "src"))
    scale = np.max(np.abs(vals_plain))
    # the sharded leaf pass contracts each row's u-list in one einsum while
    # the scan path sums width classes separately — same values, different
    # f64 reduction order; both read f64 coordinates
    assert np.max(np.abs(vals_shard - vals_plain)) <= 1e-12 * scale

    # bitwise: same sharded program on a single-device "sp" mesh
    mesh1 = make_mesh(1, ("sp",))
    args = (
        tree._dev, tree._tile_state(), jnp.asarray(w), binned["targets_pad"],
        binned["tgt_idx"],
        binned["tgt_mask"], binned["tcells"], binned["nbr_tab"],
        binned["wtab"], binned["inv_row"], binned["inv_slot"],
    )
    kw = dict(
        kparams=kparams, d=3, p=4, n_pad=binned["n_pad"], prec="f64",
        ecs=int(tree.params.eval_chunk_size),
    )
    v8, *_ = fmm_api._matvec_fused_sharded(tree._mesh, *args, **kw)
    v1, *_ = fmm_api._matvec_fused_sharded(mesh1, *args, **kw)
    assert np.array_equal(np.asarray(v8), np.asarray(v1))

    # per-device work shrinks: the lowered program contains a manual
    # (shard_map) computation whose row operands are "sp"-sharded and whose
    # per-device blocks carry R/n_sp rows — the leaf pass (P2P + M2P + L2P,
    # the dominant per-matvec cost) runs on 1/n_sp of the rows per device
    txt = fmm_api._matvec_fused_sharded.lower(tree._mesh, *args, **kw).as_text()
    nsp = int(tree._mesh.shape["sp"])
    r, t = int(binned["tgt_idx"].shape[0]), int(binned["tgt_idx"].shape[1])
    mcs = [l for l in txt.splitlines() if "manual_computation" in l]
    assert mcs and all('{"sp"}' in m for m in mcs)  # partitioned operands
    sigs = [m.split("manual_axes")[1] for m in mcs if "manual_axes" in m]
    # the LEAF shard_map's per-device tgt_idx block is (R/n_sp, T); no
    # manual computation carries a full unsharded (R, T) index table
    assert any(f"tensor<{r // nsp}x{t}xi" in s for s in sigs), mcs
    assert all(f"tensor<{r}x{t}xi" not in s for s in sigs)


def _clustered(n, d, seed):
    """A dense blob plus a sparse background: adaptive trees over it have
    leaves at several levels, hence w-lists (M2P) and x-lists (P2L)."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.random((3 * n // 4, d)) * 0.15,
                           rng.random((n - 3 * n // 4, d))])


@pytest.mark.parametrize("adaptive,d", [(True, 2), (True, 3), (False, 2), (False, 3)],
                         ids=["adaptive2d", "adaptive3d", "uniform2d", "uniform3d"])
def test_sharded_f64_matvec_matches_single_device(adaptive, d):
    """The row-sharded f64 matvec (8-device mesh) == the single-device one
    to f64 round-off, M2P included: every w-list cell is evaluated (no
    node-tile gate drops it) from f64 tiles. Uniform trees have leaves at
    one level only, hence no w-list."""
    pts = _clustered(1600, d, seed=23 + d)
    kparams = KernelParams(KernelType.LinearRbf)
    params = FmmParams(interpolation_order=4, max_points_per_cell=32,
                       compression_type=FmmCompressionType.ACA, epsilon=1e-4)
    w = np.random.default_rng(3).standard_normal((pts.shape[0], 2))

    tree_plain = FmmTree(pts, 4, kparams, adaptive_tree=adaptive, sparse=True,
                         params=params)
    tree_plain.prepare_targets(pts, "src")
    want = np.asarray(tree_plain.evaluate_device(jnp.asarray(w), "src"))

    with use_mesh(make_mesh(8, ("sp",))):
        tree = FmmTree(pts, 4, kparams, adaptive_tree=adaptive, sparse=True,
                       params=params)
    tree.prepare_targets(pts, "src")
    got = np.asarray(tree.evaluate_device(jnp.asarray(w), "src"))
    binned = tree._target_cache["src"]
    assert "nbr_tab" in binned  # the row-sharded route ran
    if adaptive:
        assert tree._wtile_cells.size and binned["wtab"] is not None
    else:
        assert tree.tree.w_pairs.shape[0] == 0 and binned["wtab"] is None
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))


def test_full_fit_sharded_matches_single_device():
    """End-to-end iterative fit under use_mesh == single-device fit."""
    pts = _points(n=1000, seed=9)
    vals = np.sin(3 * pts[:, 0]) * np.cos(2 * pts[:, 1]) + pts[:, 2] ** 2

    settings = _settings()
    params = Params(
        ddm_params=_ddm_params(),
        fmm_params=FmmParams(
            interpolation_order=4,
            max_points_per_cell=96,
            compression_type=FmmCompressionType.ACA,
            epsilon=1e-5,
        ),
        naive_solve_threshold=0,
        test_unique=False,
        mixed_precision=False,
        precond_factor_dtype="f64",
    )

    fit_plain = frt.RBFInterpolator(pts, vals, settings, params)

    mesh = make_mesh(8, ("sp", "rhs"))
    with use_mesh(mesh):
        fit_shard = frt.RBFInterpolator(pts, vals, settings, params)

    cp = fit_plain.coefficients.point_coefficients
    cs = fit_shard.coefficients.point_coefficients
    scale = np.max(np.abs(cp))
    assert np.max(np.abs(cp - cs)) <= 1e-12 * scale
    pp = fit_plain.coefficients.poly_coefficients
    ps = fit_shard.coefficients.poly_coefficients
    assert np.max(np.abs(pp - ps)) <= 1e-12 * max(np.max(np.abs(pp)), 1.0)

    # and the sharded fit actually interpolates
    resid = np.asarray(fit_shard.evaluate_at_source()).reshape(-1) - vals
    assert np.linalg.norm(resid) / np.linalg.norm(vals) < 1e-4
