"""Kernel function unit tests: formulas, gradients, host/device agreement."""

import numpy as np
import pytest

from ferreus_rbf.ops.kernels import (
    KernelParams,
    KernelType,
    kernel_phi,
    make_kernel,
)

ALL_KERNELS = list(KernelType)


def params_for(kt: KernelType) -> KernelParams:
    return KernelParams(kernel_type=kt, base_range=2.0, total_sill=1.5)


@pytest.mark.parametrize("kt", ALL_KERNELS)
def test_phi_matches_formula(kt):
    p = params_for(kt)
    # Coincidence cutoff is r^2 <= eps (i.e. r <~ 1.5e-8), the convention the
    # reference uses on its gradient path (``rbf_kernels.rs:95-99``); samples
    # sit clear of the cutoff on both sides.
    r = np.array([0.0, 1e-7, 0.1, 0.5, 1.0, 3.0, 10.0])
    got = np.asarray(kernel_phi(r, p, xp=np))

    def expected_one(ri):
        if kt == KernelType.LinearRbf:
            return -ri
        if kt == KernelType.ThinPlateSplineRbf:
            return 0.0 if ri < 1e-10 else ri**2 * np.log(ri)
        if kt == KernelType.CubicRbf:
            return ri**3
        if kt == KernelType.Laplacian:
            return 0.0 if ri < 1e-10 else 1.0 / ri
        if kt == KernelType.OneOverR2:
            return 0.0 if ri < 1e-10 else 1.0 / ri**2
        if kt == KernelType.OneOverR4:
            return 0.0 if ri < 1e-10 else 1.0 / ri**4
        # spheroidal: piecewise closed form
        from ferreus_rbf.ops.kernels import SPHEROIDAL_CONSTANTS, _SPHEROIDAL_ORDER

        order = _SPHEROIDAL_ORDER[kt]
        c = SPHEROIDAL_CONSTANTS[order]
        pw = {3: 1, 5: 2, 7: 3, 9: 4}[order]
        s = c.range_scaling / p.base_range
        if (s * ri) ** 2 <= c.inflexion_point**2:
            return p.total_sill - p.total_sill * c.linear_slope * s * ri
        t = 1.0 + (s * ri) ** 2
        return p.total_sill * c.inv_y_intercept / (t**pw * np.sqrt(t))

    want = np.array([expected_one(ri) for ri in r])
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-300)


@pytest.mark.parametrize("kt", ALL_KERNELS)
def test_gradient_matches_finite_difference(kt):
    p = params_for(kt)
    kernel = make_kernel(p, xp=np)
    rng = np.random.default_rng(0)
    t = rng.random((12, 3)) * 2.0
    s = rng.random((1, 3))

    _, grad = kernel.pair_with_grad(t, s)
    grad = grad[:, 0, :]

    h = 1e-7
    for d in range(3):
        tp = t.copy()
        tp[:, d] += h
        tm = t.copy()
        tm[:, d] -= h
        fd = (kernel.pair(tp, s)[:, 0] - kernel.pair(tm, s)[:, 0]) / (2 * h)
        np.testing.assert_allclose(grad[:, d], fd, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("kt", ALL_KERNELS)
def test_coincident_points_gradient_is_zero(kt):
    kernel = make_kernel(params_for(kt), xp=np)
    pts = np.array([[0.3, 0.4, 0.5]])
    _, grad = kernel.pair_with_grad(pts, pts)
    np.testing.assert_array_equal(grad, np.zeros_like(grad))


@pytest.mark.parametrize("kt", ALL_KERNELS)
def test_host_device_agree(kt):
    """numpy and jnp closures are the same f64 math."""
    import jax.numpy as jnp

    p = params_for(kt)
    rng = np.random.default_rng(1)
    t = rng.random((20, 3))
    s = rng.random((15, 3))
    k_np = make_kernel(p, xp=np).pair(t, s)
    k_jnp = np.asarray(make_kernel(p, xp=jnp).pair(t, s))
    # XLA may fuse the distance reduction with FMAs; agreement is to a few ulp.
    # (atol covers kernels crossing zero, e.g. TPS near r = 1).
    np.testing.assert_allclose(k_np, k_jnp, rtol=1e-13, atol=1e-14)


def test_kernel_params_validation():
    with pytest.raises(ValueError):
        KernelParams(kernel_type=KernelType.LinearRbf, base_range=0.0)
    with pytest.raises(ValueError):
        KernelParams(kernel_type=KernelType.LinearRbf, base_range=1.0, total_sill=2.0)


@pytest.mark.parametrize("kt", ALL_KERNELS)
def test_device_phi_at_tiny_r2_matches_numpy(kt):
    """f64 phi and gradient factor on the device path agree with the numpy
    twin down to r^2 = 1e-40: plain f64 sqrt / rsqrt / division, with no
    clamp of tiny distances."""
    import jax.numpy as jnp

    p = params_for(kt)
    r2 = np.concatenate([np.logspace(-40, -20, 21), [1e-16, 1e-8, 0.25, 4.0]])
    dev = make_kernel(p)
    host = make_kernel(p, xp=np)
    for fn_dev, fn_host in ((dev.phi_r2, host.phi_r2),
                            (dev.grad_scale_r2, host.grad_scale_r2)):
        got = np.asarray(fn_dev(jnp.asarray(r2)))
        want = fn_host(r2)
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=0.0)
    if kt == KernelType.LinearRbf:
        # phi(r) = -r to the last bit for r^2 down to 1e-40, below the
        # smallest normal f32
        np.testing.assert_allclose(
            np.asarray(dev.phi_r2(jnp.asarray(r2[:21]))), -np.sqrt(r2[:21]),
            rtol=1e-15)
