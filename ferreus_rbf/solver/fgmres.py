"""Flexible GMRES and the stationary Schwarz-DDM iteration.

Ports the solver semantics of ``ferreus_rbf/src/iterative_solvers.rs``:
restarted FGMRES (Saad) with right preconditioning, modified Gram-Schmidt,
Givens rotations (LAPACK dlartg behaviour), and the reference's exact
stopping rules — Absolute -> max-norm of the initial residual as beta and
|g| directly; Relative -> l2 norm and |g|/beta (``iterative_solvers.rs:
38-173``). The driver loop runs on the host (it is a handful of
O(n)-vector operations per iteration); the heavy operators — the FMM matvec
and the Schwarz preconditioner — execute on the device.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np

from ..interpolant_config import FittingAccuracy, FittingAccuracyType
from ..progress import Progress, SolverIteration, emit, progress_from_rel
from ..utils.telemetry import record_event


def givens_rotation(f: float, g: float):
    """(c, s, r) with [c s; -s c] [f; g] = [r; 0] (dlartg semantics)."""
    safmin = np.finfo(np.float64).tiny
    safmax = np.finfo(np.float64).max
    rtmin = math.sqrt(safmin)
    rtmax = math.sqrt(safmax / 2.0)

    if g == 0.0:
        return 1.0, 0.0, f
    if f == 0.0:
        return 0.0, math.copysign(1.0, g), abs(g)

    f1, g1 = abs(f), abs(g)
    if rtmin <= f1 < rtmax and rtmin <= g1 < rtmax:
        r = math.copysign(math.sqrt(f * f + g * g), f)
        return f1 / abs(r), g / r, r
    u = min(max(max(f1, g1), safmin), safmax)
    fs, gs = f / u, g / u
    mag = math.sqrt(fs * fs + gs * gs)
    r = math.copysign(mag, f) * u
    return abs(fs) / mag, gs / mag, r


def fgmres(
    a: Callable[[np.ndarray], np.ndarray],
    b: np.ndarray,
    m: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    x0: Optional[np.ndarray] = None,
    max_outer_iterations: int = 20,
    max_inner_iterations: int = 5,
    tolerance: FittingAccuracy = None,
    callback: Optional[Progress] = None,
) -> np.ndarray:
    """Solve A x = b by restarted right-preconditioned flexible GMRES."""
    tolerance = tolerance or FittingAccuracy()
    b = np.asarray(b, np.float64).reshape(-1, 1)
    n = b.shape[0]
    x = np.zeros((n, 1)) if x0 is None else np.asarray(x0, np.float64).copy()

    r = b - a(x)
    if tolerance.tolerance_type == FittingAccuracyType.Absolute:
        beta = np.max(np.abs(r[:, 0]))
    else:
        beta = np.linalg.norm(r[:, 0])
    if beta == 0.0:
        return x

    iteration = 1
    mi = max_inner_iterations

    for _outer in range(max_outer_iterations):
        v = np.zeros((n, mi + 1))
        h = np.zeros((mi + 1, mi))
        z = np.zeros((n, mi))
        g = np.zeros(mi + 1)
        cs = np.zeros(mi)
        sn = np.zeros(mi)

        r_norm = np.linalg.norm(r)
        v[:, 0] = r[:, 0] / r_norm
        g[0] = r_norm

        for j in range(mi):
            w = m(v[:, j : j + 1]) if m is not None else v[:, j : j + 1].copy()
            z[:, j] = w[:, 0]
            wj = a(w)[:, 0]

            # modified Gram-Schmidt
            for i in range(j + 1):
                hij = float(v[:, i] @ wj)
                h[i, j] = hij
                wj = wj - v[:, i] * hij
            norm = np.linalg.norm(wj)
            h[j + 1, j] = norm

            for i in range(j):
                temp = cs[i] * h[i, j] + sn[i] * h[i + 1, j]
                h[i + 1, j] = -sn[i] * h[i, j] + cs[i] * h[i + 1, j]
                h[i, j] = temp

            c, s, _ = givens_rotation(h[j, j], h[j + 1, j])
            h[j, j] = c * h[j, j] + s * h[j + 1, j]
            h[j + 1, j] = 0.0
            temp = c * g[j] + s * g[j + 1]
            g[j + 1] = -s * g[j] + c * g[j + 1]
            g[j] = temp
            cs[j], sn[j] = c, s

            if norm != 0.0:
                v[:, j + 1] = wj / norm

            if tolerance.tolerance_type == FittingAccuracyType.Absolute:
                res_norm = abs(g[j + 1])
            else:
                res_norm = abs(g[j + 1]) / beta

            emit(
                callback,
                SolverIteration(
                    iter=iteration,
                    residual=res_norm,
                    progress=progress_from_rel(res_norm, beta, tolerance.tolerance),
                ),
            )

            if res_norm < tolerance.tolerance:
                x = x + _solution(h, g, z, j + 1)
                return x
            iteration += 1

        x = x + _solution(h, g, z, mi)
        r = b - a(x)
        if tolerance.tolerance_type == FittingAccuracyType.Absolute:
            res_norm = np.max(np.abs(r))
        else:
            res_norm = np.linalg.norm(r) / beta
        if res_norm < tolerance.tolerance:
            break

    return x


def _solution(h, g, z, i):
    import scipy.linalg

    y = scipy.linalg.solve_triangular(h[:i, :i], g[:i], lower=False)
    return (z[:, :i] @ y)[:, None]


def fgmres_device(
    a,
    b,
    m=None,
    x0=None,
    max_outer_iterations: int = 20,
    max_inner_iterations: int = 5,
    tolerance: FittingAccuracy = None,
    callback: Optional[Progress] = None,
    stall_cycle_factor: float = None,
):
    """Device-resident FGMRES: identical semantics to :func:`fgmres`, but
    ``a``/``m`` map device arrays to device arrays and the Krylov basis stays
    on the device. Per inner iteration only the Gram-Schmidt coefficient column and
    the basis-vector norm are pulled to the host (two small transfers), so
    the hot loop is dominated by the operator applications.

    ``stall_cycle_factor`` (optional): return early when a full restart
    cycle fails to shrink the residual below ``factor *`` its cycle-start
    value — used by the refined wrapper's f32 rounds, where an operator at
    its accuracy floor would otherwise grind out every remaining restart
    making no progress (at 3M points: ~100 iterations x ~20 s each)."""
    import jax.numpy as jnp

    tolerance = tolerance or FittingAccuracy()
    b = jnp.asarray(b).reshape(-1, 1)
    n = b.shape[0]
    x = jnp.zeros((n, 1)) if x0 is None else jnp.asarray(x0)

    r = b - a(x)
    if tolerance.tolerance_type == FittingAccuracyType.Absolute:
        beta = float(jnp.max(jnp.abs(r)))
    else:
        beta = float(jnp.linalg.norm(r))
    if beta == 0.0:
        return x

    iteration = 1
    mi = max_inner_iterations

    for _outer in range(max_outer_iterations):
        h = np.zeros((mi + 1, mi))
        g = np.zeros(mi + 1)
        cs = np.zeros(mi)
        sn = np.zeros(mi)

        r_norm = float(jnp.linalg.norm(r))
        v = [r[:, 0] / r_norm]
        z = []
        g[0] = r_norm

        breakdown_at = None
        for j in range(mi):
            w = m(v[j][:, None]) if m is not None else v[j][:, None]
            z.append(w[:, 0])
            wj = a(w)[:, 0]

            # classical Gram-Schmidt with one re-orthogonalisation pass
            # (CGS2): batched device matmuls instead of the host path's
            # sequential MGS updates, with orthogonality loss bounded like
            # MGS ("twice is enough") — so iteration counts track the host
            # reference even on ill-conditioned systems (see
            # tests/test_solver.py::test_device_fgmres_matches_host_mgs_iterations)
            vmat = jnp.stack(v, axis=1)  # (n, j+1)
            hcol1 = vmat.T @ wj
            wj = wj - vmat @ hcol1
            hcol2 = vmat.T @ wj
            wj = wj - vmat @ hcol2
            hcol = np.asarray(hcol1 + hcol2)
            norm = float(jnp.linalg.norm(wj))
            h[: j + 1, j] = hcol
            h[j + 1, j] = norm

            for i in range(j):
                temp = cs[i] * h[i, j] + sn[i] * h[i + 1, j]
                h[i + 1, j] = -sn[i] * h[i, j] + cs[i] * h[i + 1, j]
                h[i, j] = temp

            c, s, _ = givens_rotation(h[j, j], h[j + 1, j])
            h[j, j] = c * h[j, j] + s * h[j + 1, j]
            h[j + 1, j] = 0.0
            temp = c * g[j] + s * g[j + 1]
            g[j + 1] = -s * g[j] + c * g[j + 1]
            g[j] = temp
            cs[j], sn[j] = c, s

            if norm != 0.0:
                v.append(wj / norm)
            else:
                v.append(wj)

            if tolerance.tolerance_type == FittingAccuracyType.Absolute:
                res_norm = abs(g[j + 1])
            else:
                res_norm = abs(g[j + 1]) / beta

            emit(
                callback,
                SolverIteration(
                    iter=iteration,
                    residual=res_norm,
                    progress=progress_from_rel(res_norm, beta, tolerance.tolerance),
                ),
            )

            if res_norm < tolerance.tolerance:
                breakdown_at = j + 1
                break
            iteration += 1

        i = breakdown_at if breakdown_at is not None else mi
        import scipy.linalg

        y = scipy.linalg.solve_triangular(h[:i, :i], g[:i], lower=False)
        zmat = jnp.stack(z[:i], axis=1)
        x = x + (zmat @ jnp.asarray(y))[:, None]

        if breakdown_at is not None:
            return x

        r = b - a(x)
        r_l2 = float(jnp.linalg.norm(r))
        if tolerance.tolerance_type == FittingAccuracyType.Absolute:
            res_norm = float(jnp.max(jnp.abs(r)))
        else:
            res_norm = r_l2 / beta
        if res_norm < tolerance.tolerance:
            break
        # r_norm is the cycle-start l2 residual (set before the inner loop)
        if stall_cycle_factor is not None and r_l2 > stall_cycle_factor * r_norm:
            record_event("stall_exit", {
                "cycle_start_l2": float(f"{r_norm:.3e}"),
                "cycle_end_l2": float(f"{r_l2:.3e}"),
                "factor": stall_cycle_factor,
            })
            break

    return x


def refined_fgmres_device(
    a_f64,
    a_f32,
    b,
    m=None,
    max_outer_iterations: int = 20,
    max_inner_iterations: int = 5,
    tolerance: FittingAccuracy = None,
    callback: Optional[Progress] = None,
    max_refinements: int = 8,
    history: Optional[list] = None,
):
    """Mixed-precision FGMRES with f64 iterative refinement.

    ``history`` (optional list): receives one dict per refinement round —
    ``{"round", "residual", "inner_tier"}`` with the f64 outer residual at
    the round start and the precision tier the inner Krylov solve ran at
    ("f32" or "f64") — the stall/escalation telemetry the bench captures.

    The inner Krylov iterations run with the cheaper float32 operator
    ``a_f32`` (whose ~1e-6
    relative error caps what one inner solve can achieve), while the OUTER
    loop computes exact f64 residuals with ``a_f64`` and re-solves for the
    correction — classical iterative refinement. Stopping is measured on the
    f64 residual with the reference's exact semantics (Absolute -> max-norm,
    Relative -> l2/beta), so the converged solution matches the pure-f64
    solve at the requested tolerance.
    """
    import jax.numpy as jnp

    tolerance = tolerance or FittingAccuracy()
    b = jnp.asarray(b).reshape(-1, 1)
    x = jnp.zeros_like(b)

    if tolerance.tolerance_type == FittingAccuracyType.Absolute:
        beta = float(jnp.max(jnp.abs(b)))
    else:
        beta = float(jnp.linalg.norm(b))
    if beta == 0.0:
        return x

    # each f32 inner solve can reliably reduce its own residual ~1e-5
    inner_drop = 1e-5

    # Refinement contracts only while kappa(A) * eps_inner < 1. For stiff
    # systems (e.g. 2D thin-plate-spline, whose spectrum on the
    # poly-orthogonal complement decays fast) the f32 operator noise gets
    # amplified through the near-singular modes: each round solves
    # A dx = (noise) whose true solution has a HUGE norm, and the iterate
    # diverges geometrically. When a round fails to contract, escalate the
    # inner operator to the f64 matvec; if it still fails to contract,
    # return the best iterate seen.
    inner_op = a_f32
    escalated = False
    prev_res = np.inf
    best_res = np.inf
    best_x = x

    for _refine in range(max_refinements):
        r = b - a_f64(x)
        if tolerance.tolerance_type == FittingAccuracyType.Absolute:
            res = float(jnp.max(jnp.abs(r)))
            rel = res / max(beta, 1e-300)
        else:
            res = float(jnp.linalg.norm(r)) / beta
            rel = res
        if res < best_res:
            best_res = res
            best_x = x
        if res < tolerance.tolerance:
            break
        if res > 0.5 * prev_res:
            if not escalated:
                inner_op = a_f64
                escalated = True
                x = best_x  # restart refinement from the best point
                r = b - a_f64(x)
                res = best_res
            else:
                break  # not contracting even with the f64 inner
        prev_res = res

        # inner relative tolerance: enough to finish if possible, else the
        # f32 floor
        remaining = tolerance.tolerance / max(res, 1e-300)
        if tolerance.tolerance_type == FittingAccuracyType.Absolute:
            # absolute outer tolerance -> relative inner target on r
            remaining = tolerance.tolerance / max(float(jnp.linalg.norm(r)), 1e-300)
        inner_tol = max(inner_drop if not escalated else 1e-9, 0.3 * remaining)
        event = {
            "round": _refine,
            "residual": float(f"{res:.3e}"),
            "inner_tier": "f64" if escalated else "f32",
        }
        if history is not None:
            history.append(event)
        record_event("refine_round", event)
        dx = fgmres_device(
            inner_op,
            r,
            m=m,
            max_outer_iterations=max_outer_iterations,
            max_inner_iterations=max_inner_iterations,
            tolerance=FittingAccuracy(inner_tol, FittingAccuracyType.Relative),
            callback=callback,
            # f32 rounds: bail out of a restart cycle that did not halve the
            # residual — the f32 operator is at its accuracy floor and the
            # remaining restarts would grind without progress (escalation to
            # the f64-grade inner handles it). The escalated op runs with
            # the full restart budget.
            stall_cycle_factor=None if escalated else 0.5,
        )
        x = x + dx

    # final bookkeeping: the last update may have overshot on a stiff
    # system; return the best verified iterate
    r = b - a_f64(x)
    if tolerance.tolerance_type == FittingAccuracyType.Absolute:
        res = float(jnp.max(jnp.abs(r)))
    else:
        res = float(jnp.linalg.norm(r)) / beta
    final = min(res, best_res)
    record_event("solve_done", {
        "residual": float(f"{final:.3e}"),
        "tolerance": tolerance.tolerance,
        "converged": bool(final < tolerance.tolerance),
        "escalated": escalated,
    })
    return x if res <= best_res else best_x


def schwarz_ddm_solver_device(
    matvec,
    rhs,
    m=None,
    max_iterations: int = 100,
    tolerance: FittingAccuracy = None,
    callback: Optional[Progress] = None,
):
    """Device-resident stationary iteration s += M(r); r = b - A s."""
    import jax.numpy as jnp

    tolerance = tolerance or FittingAccuracy()
    rhs = jnp.asarray(rhs).reshape(-1, 1)
    rg = rhs
    sg = jnp.zeros_like(rhs)

    if tolerance.tolerance_type == FittingAccuracyType.Absolute:
        beta = float(jnp.max(jnp.abs(rg)))
    else:
        beta = float(jnp.linalg.norm(rg))
    res_norm = beta
    iteration = 0

    if m is None:
        return sg

    while res_norm > tolerance.tolerance and iteration < max_iterations:
        sg = sg + m(rg)
        rg = rhs - matvec(sg)
        if tolerance.tolerance_type == FittingAccuracyType.Absolute:
            res_norm = float(jnp.max(jnp.abs(rg)))
        else:
            res_norm = float(jnp.linalg.norm(rg)) / beta
        iteration += 1
        emit(
            callback,
            SolverIteration(
                iter=iteration,
                residual=res_norm,
                progress=progress_from_rel(res_norm, beta, tolerance.tolerance),
            ),
        )

    return sg


def schwarz_ddm_solver(
    matvec: Callable[[np.ndarray], np.ndarray],
    rhs: np.ndarray,
    m: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    max_iterations: int = 100,
    tolerance: FittingAccuracy = None,
    callback: Optional[Progress] = None,
) -> np.ndarray:
    """Stationary iteration s += M(r); r = b - A s (``iterative_solvers.rs:234``)."""
    tolerance = tolerance or FittingAccuracy()
    rhs = np.asarray(rhs, np.float64).reshape(-1, 1)
    rg = rhs.copy()
    sg = np.zeros_like(rhs)

    if tolerance.tolerance_type == FittingAccuracyType.Absolute:
        beta = np.max(np.abs(rg[:, 0]))
    else:
        beta = np.linalg.norm(rg[:, 0])
    res_norm = beta
    iteration = 0

    if m is None:
        return sg

    while res_norm > tolerance.tolerance and iteration < max_iterations:
        sg = sg + m(rg)
        rg = rhs - matvec(sg)
        if tolerance.tolerance_type == FittingAccuracyType.Absolute:
            res_norm = np.max(np.abs(rg))
        else:
            res_norm = np.linalg.norm(rg) / beta
        iteration += 1
        emit(
            callback,
            SolverIteration(
                iter=iteration,
                residual=res_norm,
                progress=progress_from_rel(res_norm, beta, tolerance.tolerance),
            ),
        )

    return sg
