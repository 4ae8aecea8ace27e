"""End-to-end dense-path interpolator tests (the de-facto acceptance test).

Ports the reference's doctest integration test (``ferreus_rbf/src/lib.rs:42-89``):
fit Franke 2D data and assert the max residual at the sources is below
tolerance; plus save/load round-trip, dedup, gradients, and trend handling.
"""

import numpy as np
import pytest

from ferreus_rbf import (
    FittingAccuracy,
    FittingAccuracyType,
    GlobalTrend,
    InterpolantSettings,
    Params,
    RBFInterpolator,
    RBFKernelType,
    RBFTestFunctions,
    generate_random_points,
)


def _fit_franke(kernel_type=RBFKernelType.ThinPlateSpline, n=400, **kwargs):
    points = generate_random_points(n, 2, seed=42)
    values = RBFTestFunctions.franke_2d(points)
    settings = InterpolantSettings(kernel_type=kernel_type, **kwargs)
    return RBFInterpolator(points, values, settings), points, values


@pytest.mark.parametrize(
    "kernel_type",
    [
        RBFKernelType.Linear,
        RBFKernelType.ThinPlateSpline,
        RBFKernelType.Cubic,
        RBFKernelType.Spheroidal,
    ],
)
def test_dense_fit_reproduces_data(kernel_type):
    rbfi, points, values = _fit_franke(kernel_type)
    fitted = rbfi.evaluate(points)
    assert np.max(np.abs(fitted - values)) < 1e-8


def test_fit_3d():
    points = generate_random_points(300, 3, seed=7)
    values = RBFTestFunctions.f1_3d(points)
    settings = InterpolantSettings(kernel_type=RBFKernelType.Linear)
    rbfi = RBFInterpolator(points, values, settings)
    fitted = rbfi.evaluate(points)
    assert np.max(np.abs(fitted - values)) < 1e-8


def test_fit_1d():
    points = np.linspace(0.0, 1.0, 64)[:, None]
    values = np.sin(points * 6.0)
    settings = InterpolantSettings(kernel_type=RBFKernelType.Cubic)
    rbfi = RBFInterpolator(points, values, settings)
    mid = np.linspace(0.05, 0.95, 31)[:, None]
    evaluated = rbfi.evaluate(mid)
    assert evaluated.shape == (31,)  # single column -> 1-D, like the reference
    np.testing.assert_allclose(evaluated, np.sin(mid[:, 0] * 6.0), atol=1e-4)


def test_nugget_smoothing():
    rbfi, points, values = _fit_franke(nugget=1e-2)
    # with nugget, evaluate_at_source(add_nugget=True) restores the data
    restored = rbfi.evaluate_at_source(add_nugget=True)
    assert np.max(np.abs(restored - values)) < 1e-8
    smoothed = rbfi.evaluate_at_source(add_nugget=False)
    assert np.max(np.abs(smoothed - values)) > 1e-6


def test_gradients_match_finite_difference():
    rbfi, _, _ = _fit_franke()
    rng = np.random.default_rng(3)
    targets = 0.1 + 0.8 * rng.random((20, 2))
    _, grads = rbfi.evaluate_with_gradients(targets)
    h = 1e-6
    for d in range(2):
        tp = targets.copy()
        tp[:, d] += h
        tm = targets.copy()
        tm[:, d] -= h
        fd = (rbfi.evaluate(tp) - rbfi.evaluate(tm)) / (2 * h)
        np.testing.assert_allclose(grads[:, d], fd, rtol=1e-5, atol=1e-7)


def test_duplicate_removal():
    points = generate_random_points(200, 2, seed=42)
    dup_points = np.concatenate([points, points[:50]], axis=0)
    dup_values = RBFTestFunctions.franke_2d(dup_points)
    settings = InterpolantSettings(kernel_type=RBFKernelType.ThinPlateSpline)
    rbfi = RBFInterpolator(dup_points, dup_values, settings)
    assert rbfi.points.shape[0] == 200


def test_save_load_roundtrip(tmp_path):
    rbfi, points, values = _fit_franke()
    path = tmp_path / "model.json"
    rbfi.save_model(path)
    loaded = RBFInterpolator.load_model(path)
    np.testing.assert_allclose(loaded.evaluate(points), rbfi.evaluate(points), rtol=1e-14)


def test_load_rejects_bad_format(tmp_path):
    import json

    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"format": "other", "version": 1}))
    with pytest.raises(ValueError, match="unsupported format"):
        RBFInterpolator.load_model(path)

    path.write_text(json.dumps({"format": "ferreus_rbf.json", "version": 99}))
    with pytest.raises(ValueError, match="unsupported version"):
        RBFInterpolator.load_model(path)


def test_global_trend_fit():
    rng = np.random.default_rng(5)
    points = rng.random((300, 3))
    values = RBFTestFunctions.f1_3d(points)
    settings = InterpolantSettings(kernel_type=RBFKernelType.Linear)
    trend = GlobalTrend.three(
        dip=30.0, dip_direction=45.0, pitch=10.0,
        major_ratio=2.0, semi_major_ratio=1.5, minor_ratio=1.0,
    )
    rbfi = RBFInterpolator(points, values, settings, global_trend=trend)
    fitted = rbfi.evaluate(points)
    assert np.max(np.abs(fitted - values)) < 1e-8
    # gradients still finite-difference correct under the trend Jacobian
    targets = 0.2 + 0.6 * rng.random((10, 3))
    _, grads = rbfi.evaluate_with_gradients(targets)
    h = 1e-6
    for d in range(3):
        tp = targets.copy()
        tp[:, d] += h
        tm = targets.copy()
        tm[:, d] -= h
        fd = (rbfi.evaluate(tp) - rbfi.evaluate(tm)) / (2 * h)
        np.testing.assert_allclose(grads[:, d], fd, rtol=1e-4, atol=1e-6)


def test_absolute_tolerance_config():
    settings = InterpolantSettings(
        kernel_type=RBFKernelType.ThinPlateSpline,
        fitting_accuracy=FittingAccuracy(tolerance=0.01, tolerance_type=FittingAccuracyType.Absolute),
    )
    points = generate_random_points(200, 2, seed=42)
    values = RBFTestFunctions.franke_2d(points)
    rbfi = RBFInterpolator(points, values, settings)
    assert np.max(np.abs(rbfi.evaluate(points) - values)) < 0.01


def test_multi_rhs():
    points = generate_random_points(200, 2, seed=42)
    v1 = RBFTestFunctions.franke_2d(points)[:, None]
    v2 = np.sin(points[:, :1] * 5.0)
    values = np.concatenate([v1, v2], axis=1)
    settings = InterpolantSettings(kernel_type=RBFKernelType.ThinPlateSpline)
    rbfi = RBFInterpolator(points, values, settings)
    fitted = rbfi.evaluate(points)
    assert fitted.shape == (200, 2)
    assert np.max(np.abs(fitted - values)) < 1e-8


def test_params_builder_surface():
    params = Params.builder(RBFKernelType.Cubic).naive_solve_threshold(100).build()
    assert params.fmm_params.interpolation_order == 11
    assert params.naive_solve_threshold == 100
    assert params.fmm_params.epsilon == 1e-11
