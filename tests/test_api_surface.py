"""Public API surface tests: the standalone bbfmm module, telemetry, and
model round-trips with trend."""

import numpy as np

import ferreus_rbf as frt
from ferreus_rbf import bbfmm
from ferreus_rbf.utils import telemetry


def test_bbfmm_module_surface():
    rng = np.random.default_rng(0)
    pts = rng.random((800, 3))
    w = rng.standard_normal((800, 2))
    kp = bbfmm.KernelParams(
        bbfmm.FmmKernelType.SpheroidalRbf,
        spheroidal_order=bbfmm.SpheroidalOrder.Five,
        base_range=1.0,
        total_sill=0.8,
    )
    params = bbfmm.FmmParams(interpolation_order=4, max_points_per_cell=64,
                             compression_type=bbfmm.M2LCompressionType.SVD,
                             epsilon=1e-4)
    tree = bbfmm.FmmTree(pts, 4, kp, adaptive_tree=True, sparse=False, params=params)
    tree.set_weights(w)
    targets = rng.random((100, 3))
    vals = tree.evaluate(w, targets)
    assert vals.shape == (100, 2)
    vals2, grads = tree.evaluate_with_gradients(w, targets)
    assert grads.shape == (100, 6)
    np.testing.assert_allclose(vals, vals2)
    tree.set_local_coefficients(w)
    leaf_vals = tree.evaluate_leaves(w, targets)
    np.testing.assert_allclose(leaf_vals, vals, atol=1e-10)
    assert tree.source_points.shape == (800, 3)

    # laplacian kernel through the same surface
    kp2 = bbfmm.KernelParams(bbfmm.FmmKernelType.Laplacian)
    tree2 = bbfmm.FmmTree(pts, 4, kp2, params=params)
    tree2.set_weights(w)
    v = tree2.evaluate(w, targets)
    from ferreus_rbf.ops.kernels import KernelParams, KernelType, make_kernel
    want = np.asarray(make_kernel(KernelParams(KernelType.Laplacian), xp=np).pair(targets, pts)) @ w
    assert np.max(np.abs(v - want)) < 1e-2 * np.max(np.abs(want))


def test_telemetry_tracer():
    tracer = telemetry.enable_global_tracer()
    with telemetry.traced_stage("stage_a"):
        pass
    with tracer.stage("stage_b"):
        pass
    assert "stage_a" in tracer.totals and "stage_b" in tracer.totals
    assert "stage_a" in tracer.report()
    telemetry.disable_global_tracer()


def test_model_roundtrip_with_trend(tmp_path):
    rng = np.random.default_rng(1)
    pts = rng.random((300, 3))
    vals = frt.RBFTestFunctions.f4_3d(pts)
    trend = frt.GlobalTrend.three(20.0, 30.0, 10.0, 1.5, 1.2, 1.0)
    settings = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.Spheroidal,
                                       base_range=0.8, total_sill=0.7)
    rbfi = frt.RBFInterpolator(pts, vals, settings, global_trend=trend)
    path = tmp_path / "m.json"
    rbfi.save_model(path)
    loaded = frt.RBFInterpolator.load_model(path)
    targets = rng.random((40, 3))
    np.testing.assert_allclose(loaded.evaluate(targets), rbfi.evaluate(targets), rtol=1e-12)
    v1, g1 = rbfi.evaluate_with_gradients(targets)
    v2, g2 = loaded.evaluate_with_gradients(targets)
    np.testing.assert_allclose(g1, g2, rtol=1e-10)


def test_single_column_values_return_1d():
    """Single-RHS evaluate-family results are 1-D, like the reference's
    mat_to_numpy_scalar_or_matrix (python_bindings.rs:81-99); gradients
    stay 2-D; multi-RHS values stay 2-D."""
    import numpy as np

    import ferreus_rbf as frt

    pts = frt.generate_random_points(300, 2, seed=3)
    vals = frt.RBFTestFunctions.franke_2d(pts)
    assert vals.shape == (300,)
    settings = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.ThinPlateSpline)
    rbfi = frt.RBFInterpolator(pts, vals, settings)
    out = rbfi.evaluate(pts)
    assert out.shape == (300,)
    assert float(np.max(np.abs(out - vals))) < 1e-8
    src = rbfi.evaluate_at_source(add_nugget=True)
    assert src.shape == (300,)
    v, g = rbfi.evaluate_with_gradients(pts[:10])
    assert v.shape == (10,) and g.shape == (10, 2)
    two = np.stack([vals, 2.0 * vals], axis=1)
    rbfi2 = frt.RBFInterpolator(pts, two, settings)
    assert rbfi2.evaluate(pts).shape == (300, 2)
