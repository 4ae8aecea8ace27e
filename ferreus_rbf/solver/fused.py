"""Device-resident FGMRES: the whole restarted inner Krylov loop as ONE
jitted program.

The per-iteration host round trips of ``fgmres_device`` (a CGS2 coefficient
column + a basis norm, each a device-to-host sync) disappear: the inner
loop runs in a ``lax.while_loop`` with on-device CGS2, Givens
rotations (dlartg semantics) and stopping tests, so the host sees ONE small
transfer per restart cycle. Semantics match ``fgmres_device`` /
``ferreus_rbf/src/iterative_solvers.rs:38-173``: restarted right-
preconditioned flexible GMRES, Absolute -> max-norm beta + |g| stopping,
Relative -> l2 + |g|/beta.

Requires the whole preconditioner to be traceable. The fine Schwarz levels
already are (batched bucket solves); the coarse domain's host direct solve
is replaced by shipping its Cholesky factor to the device once
(``DDMTree.coarse_device_arrays``). When the coarse factorisation fell back
to LDL (numerically indefinite — rare), the fused path reports unavailable
and callers keep the per-iteration host loop.
"""

from __future__ import annotations

from functools import partial as _partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..interpolant_config import FittingAccuracy, FittingAccuracyType
from ..progress import SolverIteration, emit, progress_from_rel
from ..ops.fmm import api as fmm_api
from ..utils.memory import fused_factor_budget_bytes
from ..utils.telemetry import record_event
from .ddm import _solve_bucket


def _givens_device(f, g):
    """(c, s, r) with dlartg semantics, branchless (cf. fgmres.givens_rotation)."""
    d = jnp.hypot(f, g)  # overflow-safe sqrt(f^2 + g^2)
    sgnf = jnp.where(f >= 0.0, 1.0, -1.0)
    sgng = jnp.where(g >= 0.0, 1.0, -1.0)
    c = jnp.where(g == 0.0, 1.0, jnp.where(f == 0.0, 0.0, jnp.abs(f) / d))
    s = jnp.where(g == 0.0, 0.0, jnp.where(f == 0.0, sgng, g * sgnf / d))
    r = jnp.where(g == 0.0, f, jnp.where(f == 0.0, jnp.abs(g), sgnf * d))
    return c, s, r


def _freeze(obj):
    """Recursively hashable view of nested dict/list/array metadata."""
    if isinstance(obj, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(v) for v in obj)
    if isinstance(obj, np.ndarray):
        return (obj.shape, str(obj.dtype), obj.tobytes())
    return obj


# statics-signature -> _FusedOps. Reusing the ops object across fits reuses
# its jitted cycle CLOSURES, so jax's in-process pjit cache hits: a fresh
# closure per fit would re-trace and re-load its executables from the
# persistent compile cache on every warm fit. _FusedOps holds statics
# only — no device arrays — so the cache pins no device memory.
_OPS_CACHE: dict = {}
_OPS_CACHE_MAX = 16


class _FusedOps:
    """The static half of a fused system: everything the traced operators
    close over EXCEPT the device arrays (those travel in the ``state``
    pytree argument). Two fits with equal statics + equal state treedef get
    the very same ops object and therefore the same jitted cycle."""

    def __init__(self, n, m, nugget, kparams, d, p, ecs,
                 n_fine, coarse_k, coarse_poly, bucket_k, bmeta):
        self.n = n
        self.m = m
        self.nugget = nugget
        self.kparams = kparams
        self.d = d
        self.p = p
        self.ecs = ecs
        self.n_fine = n_fine
        self.coarse_k = coarse_k
        self.coarse_poly = coarse_poly
        self._bucket_k = bucket_k
        self._bmeta = bmeta
        self._cycles = {}

    @staticmethod
    def _k(key):
        """Pytree-safe dict key (tuples collide with jax's key sorting)."""
        return str(key)

    # ----------------------------------------------------- pure operators
    def _fmm_eval(self, state, wp, key, prec):
        arrs = state["binned"][key]
        meta = self._bmeta[key]
        vals, _m, _l, _w = fmm_api._matvec_fused(
            state["dev"], wp,
            arrs["targets_pad"], arrs["tgt_idx"], arrs["tgt_mask"], arrs["tcells"],
            arrs["p2p_groups"], arrs["m2p_groups"],
            arrs["inv_row"], arrs["inv_slot"],
            kparams=self.kparams, d=self.d, p=self.p, n_pad=meta["n_pad"],
            p2p_meta=meta["p2p_meta"], m2p_meta=meta["m2p_meta"],
            prec=prec, ecs=self.ecs,
        )
        return vals[: meta["ntargets"]]

    def matvec(self, state, w, prec):
        wp = w[: self.n]
        vals = self._fmm_eval(state, wp, self._k("__all__"), prec)
        top = vals + self.nugget * wp
        if self.m:
            top = top + state["monomial"] @ w[self.n:]
            return jnp.concatenate([top, jnp.zeros((self.m, w.shape[1]))])
        return top

    def _matvec_partial(self, state, w, level_key):
        wp = w[: self.n]
        idx = state["lvl_idx"][self._k(level_key)]
        vals = self._fmm_eval(state, wp, self._k(("lvl", level_key)), "f32")
        rows = vals + self.nugget * wp[idx]
        if self.m:
            rows = rows + state["monomial"][idx] @ w[self.n:]
        return jnp.zeros_like(w).at[idx].set(rows)

    def _solve_fine(self, state, i, residual):
        n_out = self.n + self.m
        out = jnp.zeros((n_out, residual.shape[1]), jnp.float64)
        for arrs, k in zip(state["ddm"][i], self._bucket_k[i]):
            out = out + _solve_bucket(
                residual, arrs["pts_idx"], arrs["mask"], arrs["internal"],
                arrs["q_top"], arrs["chol"], k=k, n_out=n_out,
            )
        return out

    def _solve_coarse(self, state, residual, add_poly):
        c = state["coarse"]
        k = self.coarse_k
        gathered = residual[c["idx"]]
        rhs = c["q_top"].T @ gathered[:k] + gathered[k:] if k else gathered
        y = jax.scipy.linalg.solve_triangular(c["chol"], rhs, lower=True)
        gamma = jax.scipy.linalg.solve_triangular(c["chol"].T, y, lower=False)
        coeffs = jnp.concatenate([c["q_top"] @ gamma, gamma]) if k else gamma
        out = jnp.zeros_like(residual).at[c["idx"]].set(coeffs)
        if self.coarse_poly and add_poly:
            resid = gathered[:k] - c["a_special"] @ coeffs
            out = out.at[self.n:].set(c["inv_special"] @ resid)
        return out

    def precon(self, state, rg):
        """Multilevel Schwarz, traceable (cf. schwarz.schwarz_preconditioner)."""
        sl = jnp.zeros_like(rg)
        if self.n_fine > 0:
            for i in range(self.n_fine):
                # matvec(0) == 0: skip the first restricted matvec
                res = rg if i == 0 else rg - self._matvec_partial(state, sl, i)
                s1 = self._solve_fine(state, i, res)
                if self.m:
                    q = state["ortho_q"]
                    proj = q.T @ s1[: self.n]
                    s1 = s1.at[: self.n].add(-(q @ proj))
                sl = sl + s1
                res = rg - self._matvec_partial(state, sl, "coarse")
                sl = sl + self._solve_coarse(state, res, add_poly=(i == self.n_fine - 1))
        else:
            sl = sl + self._solve_coarse(state, rg, add_poly=True)
        return sl

    # ------------------------------------------------------- fused cycle
    def cycle_fn(self, prec, tol_abs, mi):
        """One restart cycle (mi inner iterations in a while_loop) as a
        jitted function of (state, b, x, r, beta, tol) -> (x, r, stats).

        ``stats`` packs [res_g, res_r, jf, hist...] into ONE f64 vector so
        the host loop makes a single device pull per cycle instead of four
        scalar syncs."""
        key = (prec, bool(tol_abs), int(mi))
        if key in self._cycles:
            return self._cycles[key]
        n_tot = self.n + self.m

        @jax.jit
        def cycle(state, b, x, r, beta, tol):
            r_norm = jnp.linalg.norm(r)
            v0 = jnp.where(r_norm > 0.0, r[:, 0] / r_norm, r[:, 0])
            V = jnp.zeros((n_tot, mi + 1), jnp.float64).at[:, 0].set(v0)
            Z = jnp.zeros((n_tot, mi), jnp.float64)
            H = jnp.zeros((mi + 1, mi), jnp.float64)
            g = jnp.zeros(mi + 1, jnp.float64).at[0].set(r_norm)
            cs = jnp.zeros(mi, jnp.float64)
            sn = jnp.zeros(mi, jnp.float64)
            hist = jnp.zeros(mi, jnp.float64)

            def cond(carry):
                _V, _Z, _H, _g, _cs, _sn, j, res, _hist = carry
                return (j < mi) & (res >= tol)

            def body(carry):
                V, Z, H, g, cs, sn, j, _res, hist = carry
                vj = lax.dynamic_slice_in_dim(V, j, 1, axis=1)
                w = self.precon(state, vj)
                Z = lax.dynamic_update_slice_in_dim(Z, w, j, axis=1)
                wj = self.matvec(state, w, prec)[:, 0]
                # CGS2 over the masked basis (cols <= j); "twice is enough"
                colmask = (jnp.arange(mi + 1) <= j).astype(jnp.float64)
                h1 = (V.T @ wj) * colmask
                wj = wj - V @ h1
                h2 = (V.T @ wj) * colmask
                wj = wj - V @ h2
                norm = jnp.linalg.norm(wj)
                hcol = (h1 + h2).at[j + 1].set(norm)

                def rot(i, hc):
                    t1 = cs[i] * hc[i] + sn[i] * hc[i + 1]
                    t2 = -sn[i] * hc[i] + cs[i] * hc[i + 1]
                    on = i < j
                    return hc.at[i].set(jnp.where(on, t1, hc[i])).at[i + 1].set(
                        jnp.where(on, t2, hc[i + 1])
                    )

                hcol = lax.fori_loop(0, mi, rot, hcol)
                c, s, _r = _givens_device(hcol[j], hcol[j + 1])
                hcol = hcol.at[j].set(c * hcol[j] + s * hcol[j + 1]).at[j + 1].set(0.0)
                gj, gj1 = g[j], g[j + 1]
                g = g.at[j].set(c * gj + s * gj1).at[j + 1].set(-s * gj + c * gj1)
                cs = cs.at[j].set(c)
                sn = sn.at[j].set(s)
                H = lax.dynamic_update_slice_in_dim(H, hcol[:, None], j, axis=1)
                vnew = jnp.where(norm != 0.0, wj / norm, wj)
                V = lax.dynamic_update_slice_in_dim(V, vnew[:, None], j + 1, axis=1)
                res = jnp.abs(g[j + 1]) if tol_abs else jnp.abs(g[j + 1]) / beta
                hist = hist.at[j].set(res)
                return V, Z, H, g, cs, sn, j + 1, res, hist

            init = (V, Z, H, g, cs, sn, jnp.int32(0), jnp.float64(jnp.inf), hist)
            V, Z, H, g, cs, sn, jf, res_g, hist = lax.while_loop(cond, body, init)

            # masked back-substitution: unit diagonal + zero rhs beyond jf
            pad = (jnp.arange(mi) >= jf).astype(jnp.float64)
            Hs = H[:mi, :mi] + jnp.diag(pad)
            gs = jnp.where(jnp.arange(mi) < jf, g[:mi], 0.0)
            y = jax.scipy.linalg.solve_triangular(Hs, gs, lower=False)
            x = x + Z @ y[:, None]
            r = b - self.matvec(state, x, prec)
            res_r = (
                jnp.max(jnp.abs(r)) if tol_abs else jnp.linalg.norm(r) / beta
            )
            stats = jnp.concatenate([
                jnp.stack([res_g, res_r, jf.astype(jnp.float64)]), hist])
            return x, r, stats

        self._cycles[key] = cycle
        return cycle


class FusedSystem:
    """Pure-functional view of a ``DeviceSystem``: every device array in one
    pytree (``self.state``), every static on a ``_FusedOps`` (shared across
    fits with equal statics) — so the operators and the full FGMRES cycle
    can be traced into a single program, and repeat fits reuse it."""

    _k = staticmethod(_FusedOps._k)

    def __init__(self, system):
        tree = system.fmm_tree
        self.n = system.n
        self.m = system.m
        self.nugget = system.nugget
        self.kparams = tree.kernel_params
        self.d = tree.d
        self.p = tree.p
        self.ecs = int(tree.params.eval_chunk_size)
        ddm = system.ddm_tree
        self.n_fine = len(ddm.levels) - 1

        coarse = ddm.coarse_device_arrays()
        self.ok = coarse is not None
        if not self.ok:
            return

        # Memory gate: one while-loop body holds every level's batched
        # triangular solves (XLA InvertDiagBlocksLowerTriangular + remat
        # copies of the (nb, S, S) blocks) live at once — ~9x the factor
        # bytes. Past fused_factor_budget_bytes() of factors the
        # per-iteration compute dwarfs the per-iteration dispatch latency
        # the fused cycle exists to hide, so the host restart loop is the
        # right mode.
        # Recompute-from-points buckets (storage-free Schwarz at >= ~3M pts)
        # re-assemble and re-factor inside each application — tracing that
        # into one while-loop body would hold the full per-chunk assembly
        # transients live across the cycle; keep the host restart loop.
        if any(
            b.get("recompute")
            for level in ddm.levels[:-1]
            if level.device is not None
            for b in level.device.buckets
        ):
            self.ok = False
            return
        factor_bytes = sum(
            int(np.prod(b["chol"].shape)) * b["chol"].dtype.itemsize
            for level in ddm.levels[:-1]
            if level.device is not None
            for b in level.device.buckets
        )
        if factor_bytes > fused_factor_budget_bytes():
            self.ok = False
            return

        state = {"dev": tree._dev, "binned": {}, "coarse": coarse[0]}
        self.coarse_k = coarse[1]
        self.coarse_poly = coarse[2]

        # target binnings (arrays incl. the near-field scan tables, which
        # serve both precisions) + their statics
        self._bmeta = {}
        keys = ["__all__"] + [("lvl", i) for i in range(self.n_fine)] + [("lvl", "coarse")]
        for key in keys:
            binned = tree._ensure_scan_tables(tree._target_cache[key])
            state["binned"][self._k(key)] = {
                k: binned[k]
                for k in ("targets_pad", "tgt_idx", "tgt_mask", "tcells",
                          "inv_row", "inv_slot", "p2p_groups", "m2p_groups")
            }
            self._bmeta[self._k(key)] = {
                "n_pad": binned["n_pad"],
                "ntargets": binned["ntargets"],
                "m2p_meta": binned["m2p_meta"],
                "p2p_meta": binned["p2p_meta"],
            }

        if system.monomial_dev is not None:
            state["monomial"] = system.monomial_dev
            state["ortho_q"] = jnp.asarray(system.ortho_poly)
        else:
            state["monomial"] = None
            state["ortho_q"] = None
        state["lvl_idx"] = {self._k(k): v for k, v in system._level_idx.items()}

        # fine Schwarz levels: arrays per bucket; k (static) kept separately
        state["ddm"] = []
        bucket_k = []
        for level in ddm.levels[:-1]:
            larr, lk = [], []
            for bucket in level.device.buckets:
                larr.append({k: bucket[k] for k in ("pts_idx", "mask", "internal", "q_top", "chol")})
                lk.append(bucket["k"])
            state["ddm"].append(larr)
            bucket_k.append(tuple(lk))
        bucket_k = tuple(bucket_k)

        self.state = state
        sig = (
            self.n, self.m, float(self.nugget), self.kparams, self.d, self.p,
            self.ecs, self.n_fine, self.coarse_k, bool(self.coarse_poly), bucket_k,
            _freeze(self._bmeta), jax.tree_util.tree_structure(state),
        )
        ops = _OPS_CACHE.get(sig)
        if ops is None:
            if len(_OPS_CACHE) >= _OPS_CACHE_MAX:
                _OPS_CACHE.pop(next(iter(_OPS_CACHE)))
            ops = _FusedOps(
                self.n, self.m, self.nugget, self.kparams, self.d, self.p,
                self.ecs, self.n_fine, self.coarse_k, self.coarse_poly, bucket_k, self._bmeta,
            )
            _OPS_CACHE[sig] = ops
        self.ops = ops

    # thin delegates: the traced operators live on the shared _FusedOps
    def matvec(self, state, w, prec):
        return self.ops.matvec(state, w, prec)

    def precon(self, state, rg):
        return self.ops.precon(state, rg)

    def cycle_fn(self, prec, tol_abs, mi):
        return self.ops.cycle_fn(prec, tol_abs, mi)


def fgmres_fused(
    fs: FusedSystem,
    b,
    prec,
    max_outer_iterations: int = 20,
    max_inner_iterations: int = 5,
    tolerance: FittingAccuracy = None,
    callback=None,
    x0=None,
):
    """Restarted FGMRES over fused device cycles; one host pull per restart.

    Same stopping semantics as :func:`..fgmres.fgmres_device` (which remains
    the reference host-loop implementation and the fallback when the system
    is not fully traceable).
    """
    tolerance = tolerance or FittingAccuracy()
    tol_abs = tolerance.tolerance_type == FittingAccuracyType.Absolute
    b = jnp.asarray(b).reshape(-1, 1)
    state = fs.state
    mi = max_inner_iterations

    if x0 is None:
        # A(0) == 0 exactly (the operator is linear), so r0 = b — skip the
        # initial matvec dispatch
        x = jnp.zeros_like(b)
        r = b
    else:
        x = jnp.asarray(x0)
        r = b - fs.matvec(state, x, prec)
    beta = float(jnp.max(jnp.abs(r)) if tol_abs else jnp.linalg.norm(r))
    if beta == 0.0:
        return x

    cycle = fs.cycle_fn(prec, tol_abs, mi)
    beta_dev = jnp.float64(beta)
    tol_dev = jnp.float64(tolerance.tolerance)
    iteration = 1
    for _outer in range(max_outer_iterations):
        x, r, stats = cycle(state, b, x, r, beta_dev, tol_dev)
        # ONE synchronisation point per restart cycle: stats packs
        # [res_g, res_r, jf, hist...] so this is a single device pull
        stats = np.asarray(stats)
        res_g, res_r, jf = float(stats[0]), float(stats[1]), int(stats[2])
        hist = stats[3:]
        for j in range(jf):
            emit(callback, SolverIteration(
                iter=iteration,
                residual=float(hist[j]),
                progress=progress_from_rel(float(hist[j]), beta, tolerance.tolerance),
            ))
            iteration += 1
        if res_g < tolerance.tolerance:
            return x
        if res_r < tolerance.tolerance:
            return x
    return x


def refined_fgmres_fused(
    fs: FusedSystem,
    b,
    max_outer_iterations: int = 20,
    max_inner_iterations: int = 5,
    tolerance: FittingAccuracy = None,
    callback=None,
    max_refinements: int = 8,
):
    """Mixed-precision iterative refinement over fused device cycles.

    Same escalation logic as :func:`..fgmres.refined_fgmres_device`: f32
    inner Krylov solves, exact f64 outer residuals, escalation of the
    inner operator to the f64 matvec when a round fails to contract,
    best-iterate bookkeeping for stiff systems.
    """
    tolerance = tolerance or FittingAccuracy()
    tol_abs = tolerance.tolerance_type == FittingAccuracyType.Absolute
    b = jnp.asarray(b).reshape(-1, 1)
    x = jnp.zeros_like(b)
    state = fs.state

    beta = float(jnp.max(jnp.abs(b)) if tol_abs else jnp.linalg.norm(b))
    if beta == 0.0:
        return x

    inner_drop = 1e-5
    inner_prec = "f32"
    escalated = False
    prev_res = np.inf
    best_res = np.inf
    best_x = x

    for _refine in range(max_refinements):
        r = b - fs.matvec(state, x, "f64")
        if tol_abs:
            res = float(jnp.max(jnp.abs(r)))
        else:
            res = float(jnp.linalg.norm(r)) / beta
        if res < best_res:
            best_res = res
            best_x = x
        if res < tolerance.tolerance:
            break
        if res > 0.5 * prev_res:
            if not escalated:
                inner_prec = "f64"
                escalated = True
                x = best_x  # restart refinement from the best point
                r = b - fs.matvec(state, x, "f64")
                res = best_res
            else:
                break  # not contracting even with the f64 inner
        prev_res = res

        remaining = tolerance.tolerance / max(res, 1e-300)
        if tol_abs:
            remaining = tolerance.tolerance / max(float(jnp.linalg.norm(r)), 1e-300)
        inner_tol = max(inner_drop if not escalated else 1e-9, 0.3 * remaining)
        record_event("refine_round", {
            "round": _refine,
            "residual": float(f"{res:.3e}"),
            "inner_tier": "f64" if escalated else "f32",
        })
        dx = fgmres_fused(
            fs,
            r,
            prec=inner_prec,
            max_outer_iterations=max_outer_iterations,
            max_inner_iterations=max_inner_iterations,
            tolerance=FittingAccuracy(inner_tol, FittingAccuracyType.Relative),
            callback=callback,
        )
        x = x + dx

    r = b - fs.matvec(state, x, "f64")
    if tol_abs:
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
