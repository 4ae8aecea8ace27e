"""Radial kernel functions phi(r) and their analytic gradients.

Mirrors the kernel registry of the reference
(``ferreus_rbf_utils/src/rbf_kernels.rs``, ``non_rbf_kernels.rs``,
``constants.rs``, ``utils.rs:558-571``): ten kernels —

* LinearRbf              phi(r) = -r
* ThinPlateSplineRbf     phi(r) = r^2 ln r            (0 at r = 0)
* CubicRbf               phi(r) = r^3
* Spheroidal{3,5,7,9}Rbf piecewise near-linear / far-decay with calibrated
                         constants (``constants.rs:21-50``)
* Laplacian              phi(r) = 1/r                 (0 at r = 0)
* OneOverR2              phi(r) = 1/r^2               (0 at r = 0)
* OneOverR4              phi(r) = 1/r^4               (0 at r = 0)

Design: kernels are *vectorised closures over squared distance*. Every
caller (dense A-matrix build, FMM P2P tiles, M2L operator generation)
computes a batched ``r2`` tensor and maps ``phi_r2`` / ``grad_scale_r2`` over
it — there is no per-pair scalar dispatch anywhere. The same formula source
serves both backends: ``make_kernel(params)`` builds jnp (device) closures
for the jitted compute path, ``make_kernel(params, xp=numpy)`` builds the
host-side twin used by setup-time factorisations; both evaluate the same
f64 expressions with plain sqrt / rsqrt / division.

Gradients follow the reference convention: grad phi(t - s) = (t - s) * g(r2)
with g returned by ``grad_scale_r2`` (see e.g. ``rbf_kernels.rs:265-300``).
``r2 <= eps`` is treated as coincident (value/gradient conventions identical
to the reference, incl. TPS -> 0 and Laplacian -> 0).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

_EPS = float(np.finfo(np.float64).eps)


class KernelType(enum.Enum):
    """The ten kernels of the reference registry (``utils.rs:558-571``)."""

    LinearRbf = "LinearRbf"
    ThinPlateSplineRbf = "ThinPlateSplineRbf"
    CubicRbf = "CubicRbf"
    Spheroidal3Rbf = "Spheroidal3Rbf"
    Spheroidal5Rbf = "Spheroidal5Rbf"
    Spheroidal7Rbf = "Spheroidal7Rbf"
    Spheroidal9Rbf = "Spheroidal9Rbf"
    Laplacian = "Laplacian"
    OneOverR2 = "OneOverR2"
    OneOverR4 = "OneOverR4"


@dataclasses.dataclass(frozen=True)
class KernelParams:
    """Uniform runtime kernel configuration (``kernel_helpers.rs:17-36``).

    ``base_range`` and ``total_sill`` only affect spheroidal kernels.
    """

    kernel_type: KernelType
    base_range: float = 1.0
    total_sill: float = 1.0

    def __post_init__(self):
        if not self.base_range > 0.0:
            raise ValueError("base_range must be > 0")
        if not self.total_sill <= self.base_range:
            raise ValueError("total_sill must be <= base_range")


@dataclasses.dataclass(frozen=True)
class SpheroidalConstants:
    """Calibrated spheroidal family constants (``constants.rs:13-50``)."""

    inflexion_point: float
    linear_slope: float
    range_scaling: float
    inv_y_intercept: float


SPHEROIDAL_CONSTANTS = {
    3: SpheroidalConstants(0.5000000000, 0.7500000000, 2.6798340586, 0.8734640537),
    5: SpheroidalConstants(0.4082482905, 1.0206207262, 1.5822795750, 0.8575980168),
    7: SpheroidalConstants(0.3535533906, 1.2374368671, 1.2008676644, 0.8494862533),
    9: SpheroidalConstants(0.3162277660, 1.4230249471, 1.0000000000, 0.8445585690),
}

_SPHEROIDAL_POW = {3: 1, 5: 2, 7: 3, 9: 4}

_SPHEROIDAL_ORDER = {
    KernelType.Spheroidal3Rbf: 3,
    KernelType.Spheroidal5Rbf: 5,
    KernelType.Spheroidal7Rbf: 7,
    KernelType.Spheroidal9Rbf: 9,
}


class Kernel:
    """A concrete kernel: vectorised phi(r2) and gradient factor g(r2).

    grad phi evaluated at displacement d = t - s is ``d * grad_scale_r2(|d|^2)``.
    ``supports_gradients`` mirrors the reference's optional
    ``evaluate_value_gradient`` (all ten registry kernels support gradients;
    kept as a flag so user kernels may opt out, matching
    ``FmmError::KernelDoesNotSupportGradients`` semantics).
    """

    def __init__(
        self,
        phi_r2: Callable,
        grad_scale_r2: Callable,
        xp,
        supports_gradients: bool = True,
        homogeneity: float | None = None,
        dtype=None,
    ):
        self.phi_r2 = phi_r2
        self.grad_scale_r2 = grad_scale_r2
        self.xp = xp
        self.dtype = dtype if dtype is not None else xp.float64
        self.supports_gradients = supports_gradients
        # Homogeneity degree n such that phi(a*r) = a^n phi(r); None when the
        # kernel is not homogeneous (spheroidal) or log-homogeneous (TPS).
        self.homogeneity = homogeneity

    def phi(self, r):
        r = self.xp.asarray(r, dtype=self.dtype)
        return self.phi_r2(r * r)

    def pair_r2(self, targets, sources):
        """Pairwise squared distances r2[i, j] = |t_i - s_j|^2."""
        xp = self.xp
        t = xp.asarray(targets, dtype=self.dtype)
        s = xp.asarray(sources, dtype=self.dtype)
        diff = t[..., :, None, :] - s[..., None, :, :]
        return xp.sum(diff * diff, axis=-1)

    def pair(self, targets, sources):
        """Dense kernel block K[i, j] = phi(|t_i - s_j|)."""
        return self.phi_r2(self.pair_r2(targets, sources))

    def pair_with_grad(self, targets, sources):
        """Dense block and gradient block.

        Returns ``(K, G)`` with ``K[i, j] = phi(|t_i - s_j|)`` and
        ``G[i, j, d] = d/dt_d phi(t_i - s_j)``.
        """
        xp = self.xp
        t = xp.asarray(targets, dtype=self.dtype)
        s = xp.asarray(sources, dtype=self.dtype)
        diff = t[..., :, None, :] - s[..., None, :, :]
        r2 = xp.sum(diff * diff, axis=-1)
        k = self.phi_r2(r2)
        g = self.grad_scale_r2(r2)
        return k, diff * g[..., None]


def _safe_sqrt(xp, r2):
    return xp.sqrt(xp.maximum(r2, 0.0))


def _safe_log_r(xp, r2):
    # log(r) = 0.5*log(r2), guarded so masked-out lanes never produce NaN.
    return 0.5 * xp.log(xp.where(r2 > _EPS, r2, 1.0))


def _rsqrt(xp, x):
    return jax.lax.rsqrt(x) if xp is jnp else 1.0 / np.sqrt(x)


def _safe_inv_r(xp, r2):
    mask = r2 > _EPS
    return xp.where(mask, _rsqrt(xp, xp.where(mask, r2, 1.0)), 0.0)


def _linear(xp) -> Kernel:
    # phi(r) = -r; grad = -d/r (``rbf_kernels.rs:25-57``).
    def phi_r2(r2):
        return -_safe_sqrt(xp, r2)

    def grad(r2):
        return -_safe_inv_r(xp, r2)

    return Kernel(phi_r2, grad, xp, homogeneity=1.0)


def _tps(xp) -> Kernel:
    # phi(r) = r^2 ln r (0 at 0); grad factor = 2 ln r + 1
    # (``rbf_kernels.rs:69-106``).
    def phi_r2(r2):
        return xp.where(r2 > _EPS, r2 * _safe_log_r(xp, r2), 0.0)

    def grad(r2):
        return xp.where(r2 > _EPS, 2.0 * _safe_log_r(xp, r2) + 1.0, 0.0)

    return Kernel(phi_r2, grad, xp)


def _cubic(xp) -> Kernel:
    # phi(r) = r^3; grad factor = 3 r (``rbf_kernels.rs:118-152``).
    def phi_r2(r2):
        return r2 * _safe_sqrt(xp, r2)

    def grad(r2):
        return xp.where(r2 > _EPS, 3.0 * _safe_sqrt(xp, r2), 0.0)

    return Kernel(phi_r2, grad, xp, homogeneity=3.0)


def _spheroidal(xp, order: int, base_range: float, total_sill: float) -> Kernel:
    # Piecewise near/far form (``rbf_kernels.rs:215-300``):
    #   near (s^2 r^2 <= ip^2): total_sill - total_sill*linear_slope*s * r
    #   far:                    total_sill*inv_y_intercept / (t^POW sqrt(t)),
    #                           t = 1 + (s r)^2,  s = range_scaling/base_range
    c = SPHEROIDAL_CONSTANTS[order]
    pw = _SPHEROIDAL_POW[order]
    s = c.range_scaling / base_range
    s2 = s * s
    ip2 = c.inflexion_point * c.inflexion_point
    near_slope = total_sill * c.linear_slope * s
    far_coef = total_sill * c.inv_y_intercept

    def phi_r2(r2):
        sr2 = s2 * r2
        near = total_sill - near_slope * _safe_sqrt(xp, r2)
        t = 1.0 + sr2  # >= 1
        far = far_coef / (t**pw * xp.sqrt(t))
        return xp.where(sr2 <= ip2, near, far)

    def grad(r2):
        sr2 = s2 * r2
        near_g = -near_slope * _safe_inv_r(xp, r2)
        p = pw + 0.5
        t = 1.0 + sr2
        # t^(p+1) = t^(pw+1) * sqrt(t) with integer pw
        far_g = -2.0 * p * s2 * far_coef / (t ** (pw + 1) * xp.sqrt(t))
        g = xp.where(sr2 <= ip2, near_g, far_g)
        return xp.where(r2 > _EPS, g, 0.0)

    return Kernel(phi_r2, grad, xp)


def _inverse_power(xp, p: int) -> Kernel:
    # phi(r) = 1/r^p (0 at 0); grad factor = -p / r^(p+2)
    # (``non_rbf_kernels.rs``).
    def _inv_pow(r2, q):
        """r^-q (q possibly half-integer) where r2 > eps, else 0."""
        mask = r2 > _EPS
        safe = xp.where(mask, r2, 1.0)
        whole = 1.0 / safe ** (q // 2) if q // 2 else 1.0
        half = _rsqrt(xp, safe) if q % 2 else 1.0
        return xp.where(mask, whole * half, 0.0)

    def phi_r2(r2):
        return _inv_pow(r2, p)

    def grad(r2):
        return -p * _inv_pow(r2, p + 2)

    return Kernel(phi_r2, grad, xp, homogeneity=-float(p))


def make_kernel(params: KernelParams, xp=jnp, dtype=None) -> Kernel:
    """KernelParams -> concrete kernel (mirrors ``KernelFromParams``).

    ``xp=jnp`` (default) builds device closures; ``xp=numpy`` the host twin.
    ``dtype=jnp.float32`` builds the reduced-precision variant used by the
    mixed-precision solver's inner iterations.
    """
    kt = params.kernel_type
    if kt == KernelType.LinearRbf:
        k = _linear(xp)
    elif kt == KernelType.ThinPlateSplineRbf:
        k = _tps(xp)
    elif kt == KernelType.CubicRbf:
        k = _cubic(xp)
    elif kt in _SPHEROIDAL_ORDER:
        k = _spheroidal(xp, _SPHEROIDAL_ORDER[kt], params.base_range, params.total_sill)
    elif kt == KernelType.Laplacian:
        k = _inverse_power(xp, 1)
    elif kt == KernelType.OneOverR2:
        k = _inverse_power(xp, 2)
    elif kt == KernelType.OneOverR4:
        k = _inverse_power(xp, 4)
    else:
        raise ValueError(f"Unknown kernel type {kt}")
    if dtype is not None:
        k.dtype = dtype
    return k


def kernel_phi(r, params: KernelParams, xp=jnp):
    """Evaluate phi(r) for the configured kernel (``utils.rs:541``)."""
    return make_kernel(params, xp).phi(r)
