"""Iterative fit orchestration: FMM matvec + DDM/Schwarz + FGMRES.

Maps the large-N branch of ``rbf.rs::setup_and_solve`` (``rbf.rs:456-576``)
and the implicit saddle-point operator ``fast_matrix_vector_product``
(``rbf.rs:1338-1379``): the action of [[A + nu*I, P], [P^T, 0]] is computed
as (FMM matvec at the source points) + nugget*w + P c, with the constraint
block handled by the preconditioner's orthogonalisation; the system is
solved per RHS column with restarted FGMRES (20 x 5) or the stationary DDM
iteration, both right-preconditioned by the multilevel Schwarz hierarchy.

Everything in the hot loop is device-resident: weight/residual vectors,
the FMM passes (with per-level cached target binnings), the batched Schwarz
leaf solves, the polynomial block, and the FGMRES basis. Only per-iteration
scalars (Givens/Gram-Schmidt coefficients, residual norms) and the small
coarse-domain rows cross the host boundary.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..config import Solvers
from ..ops.fmm.api import FmmTree
from ..ops.polynomials import evaluate_monomials
from ..utils import telemetry
from ..utils.telemetry import traced_stage
from . import fgmres as solvers
from .ddm import DDMTree
from .schwarz import schwarz_preconditioner


class DeviceSystem:
    """The device-resident saddle-point operator + Schwarz preconditioner."""

    def __init__(self, rbfi):
        points = rbfi.points
        settings = rbfi.interpolant_settings
        params = rbfi.params
        self.n, _d = points.shape
        self.m = settings.basis_size
        self.settings = settings

        with traced_stage("fmm_tree_build"):
            self.fmm_tree = FmmTree(
                points,
                params.fmm_params.interpolation_order,
                settings.kernel_params(),
                adaptive_tree=True,
                sparse=True,
                params=params.fmm_params,
            )
        with traced_stage("prepare_targets_all"):
            self.fmm_tree.prepare_targets(points, "__all__")

        self.monomial_matrix = None
        self.monomial_dev = None
        self.ortho_poly = None
        if self.m != 0:
            monomial_points = (
                rbfi.global_trend.inverse_transform_points(points)
                if rbfi.global_trend is not None
                else points
            )
            self.monomial_matrix = evaluate_monomials(
                monomial_points,
                settings.polynomial_degree,
                self.m,
                rbfi.translation_factor,
                rbfi.scale_factor,
            )
            self.monomial_dev = jnp.asarray(self.monomial_matrix)
            self.ortho_poly, _ = np.linalg.qr(self.monomial_matrix)

        import jax.numpy as _jnp

        factor_dtype = (
            _jnp.float32 if params.precond_factor_dtype == "f32" else _jnp.float64
        )
        with traced_stage("ddm_tree_build"):
            self.ddm_tree = DDMTree(
                points, settings, params.ddm_params, rbfi.global_trend,
                factor_dtype=factor_dtype,
            )

        # per-level target binnings + device index arrays for the restricted
        # matvecs the Schwarz sweep issues
        with traced_stage("prepare_targets_levels"):
            self._level_idx = {}
            n = points.shape[0]
            for i, level in enumerate(self.ddm_tree.levels[:-1]):
                idx = level.point_indices
                if idx.size == n and np.array_equal(idx, np.arange(n)):
                    # level 0's active set IS all points: reuse the "__all__"
                    # binning instead of duplicating ~400 MB of target tables
                    # at 3M points
                    self.fmm_tree._target_cache[("lvl", i)] = (
                        self.fmm_tree._target_cache["__all__"]
                    )
                else:
                    self.fmm_tree.prepare_targets(points[idx], ("lvl", i))
                self._level_idx[i] = jnp.asarray(idx)
            coarse_idx = self.ddm_tree.levels[-1].point_indices
            self.fmm_tree.prepare_targets(points[coarse_idx], ("lvl", "coarse"))
            self._level_idx["coarse"] = jnp.asarray(coarse_idx)

        self.nugget = settings.nugget

    # -- operators ---------------------------------------------------------
    def matvec(self, w, precision="f64"):
        """Full system operator, device in -> device out ((n+m, nrhs))."""
        w = jnp.asarray(w)
        wp = w[: self.n]
        vals = self.fmm_tree.evaluate_device(wp, "__all__", precision=precision)
        top = vals + self.nugget * wp
        if self.monomial_dev is not None:
            top = top + self.monomial_dev @ w[self.n :]
            return jnp.concatenate([top, jnp.zeros((self.m, w.shape[1]))])
        return top

    def matvec_f32(self, w):
        return self.matvec(w, precision="f32")

    def matvec_partial(self, w, level_key, precision="f32"):
        """Operator restricted to one Schwarz level's rows.

        Preconditioner-internal residual updates default to f32: a flexible
        (right-preconditioned) Krylov method tolerates an inexact M.
        """
        if level_key is None:
            return self.matvec(w)
        w = jnp.asarray(w)
        wp = w[: self.n]
        idx = self._level_idx[level_key]
        vals = self.fmm_tree.evaluate_device(wp, ("lvl", level_key), precision=precision)
        rows = vals + self.nugget * wp[idx]
        if self.monomial_dev is not None:
            rows = rows + self.monomial_dev[idx] @ w[self.n :]
        out = jnp.zeros_like(w)
        return out.at[idx].set(rows)

    def precon(self, residuals):
        return schwarz_preconditioner(
            residuals, self.ddm_tree, self.matvec_partial, self.settings, self.ortho_poly
        )


def iterative_fit(rbfi):
    """Fit ``rbfi`` (an RBFInterpolator mid-construction) iteratively."""
    from ..models.rbf import Coefficients

    values = rbfi.point_values
    settings = rbfi.interpolant_settings
    params = rbfi.params
    num_cols = values.shape[1]

    with traced_stage("system_setup"):
        system = DeviceSystem(rbfi)
    n, m = system.n, system.m

    rhs = values
    if m != 0:
        rhs = np.concatenate([values, np.zeros((m, num_cols))])

    point_coefficients = np.zeros((n, num_cols))
    poly_coefficients = np.zeros((m, num_cols)) if m else None

    # Device-resident restart cycles (lax.while_loop inner loop, one host
    # transfer per restart) whenever the whole preconditioner is traceable;
    # env override FERREUS_RBF_FUSED=0 keeps the per-iteration host loop.
    import os

    fs = None
    if params.solver_type == Solvers.FGMRES and os.environ.get(
        "FERREUS_RBF_FUSED", "1"
    ) not in ("0", "false", "False"):
        from . import fused as fused_mod

        with traced_stage("fused_system_build"):
            fs_try = fused_mod.FusedSystem(system)
        if fs_try.ok:
            fs = fs_try

    for col in range(num_cols):
        b = jnp.asarray(rhs[:, col : col + 1])
        with traced_stage("solve_column"):
            sol = _solve_one_column(rbfi, system, fs, b, settings, params)
        sol = np.asarray(sol)
        point_coefficients[:, col] = sol[:n, 0]
        if m:
            poly_coefficients[:, col] = sol[n:, 0]

    # One-M-step preconditioner diagnostic:
    # stashed as a callable on the interpolator instead of running inline,
    # so the fit wall-clock stays raw (the bench invokes it AFTER taking
    # fit_s; every program it dispatches is already compiled by then). It
    # spends one preconditioner application + two matvecs to record (a) the
    # one-M-step residual reduction at both precision tiers — separating
    # "M is weak" from "A is inaccurate at this tier" — and (b) the
    # f32-vs-f64 operator discrepancy on z = M b, the vector the solver
    # actually feeds the operator.
    def _m_step_diagnostic(_system=system, _rhs=rhs):
        b0 = jnp.asarray(_rhs[:, :1])
        nb = max(float(jnp.linalg.norm(b0)), 1e-300)
        z = _system.precon(b0)
        az32 = _system.matvec(z, precision="f32")
        az64 = _system.matvec(z)
        r32 = float(jnp.linalg.norm(b0 - az32)) / nb
        r64 = float(jnp.linalg.norm(b0 - az64)) / nb
        disc = float(jnp.linalg.norm(az32 - az64)) / max(
            float(jnp.linalg.norm(az64)), 1e-300)
        out = {
            "one_m_step_residual_f32": float(f"{r32:.3e}"),
            "one_m_step_residual_f64grade": float(f"{r64:.3e}"),
            "matvec_tier_discrepancy_on_Mb": float(f"{disc:.3e}"),
        }
        if telemetry.global_tracer() is not None:
            telemetry.record_event("m_step", out)
        return out

    rbfi.m_step_diagnostic = _m_step_diagnostic

    return Coefficients(point_coefficients, poly_coefficients)


def _solve_one_column(rbfi, system, fs, b, settings, params):
    if fs is not None:
        from . import fused as fused_mod

        if params.mixed_precision:
            return fused_mod.refined_fgmres_fused(
                fs,
                b,
                max_outer_iterations=20,
                max_inner_iterations=5,
                tolerance=settings.fitting_accuracy,
                callback=rbfi.progress_callback,
            )
        return fused_mod.fgmres_fused(
            fs,
            b,
            prec="f64",
            max_outer_iterations=20,
            max_inner_iterations=5,
            tolerance=settings.fitting_accuracy,
            callback=rbfi.progress_callback,
        )
    if params.solver_type == Solvers.FGMRES:
        if params.mixed_precision:
            return solvers.refined_fgmres_device(
                system.matvec,
                system.matvec_f32,
                b,
                m=system.precon,
                max_outer_iterations=20,
                max_inner_iterations=5,
                tolerance=settings.fitting_accuracy,
                callback=rbfi.progress_callback,
            )
        return solvers.fgmres_device(
            system.matvec,
            b,
            m=system.precon,
            max_outer_iterations=20,
            max_inner_iterations=5,
            tolerance=settings.fitting_accuracy,
            callback=rbfi.progress_callback,
        )
    return solvers.schwarz_ddm_solver_device(
        system.matvec,
        b,
        m=system.precon,
        max_iterations=100,
        tolerance=settings.fitting_accuracy,
        callback=rbfi.progress_callback,
    )
