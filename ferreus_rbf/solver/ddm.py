"""Multilevel overlapping domain decomposition for Schwarz preconditioning.

Maps ``ferreus_rbf/src/preconditioning/domain_decomposition.rs`` (Beatson/
Light/Billings 2000; Haase et al. 2018): per level, recursive median split
along the longest axis into leaf domains of ~``leaf_threshold`` points;
per leaf, the coarse set is a centroid-closest seed plus farthest-point
sampling of ``coarse_ratio`` of the internal points, and the overlap is the
nearest neighbouring-internal points ranked by point-to-AABB distance;
levels recurse on the coarse sets until ``coarse_threshold``, which gets a
single directly-factored coarse domain (with the polynomial tail when a
drift is present).

Host/device split: the decomposition combinatorics (median splits, FPS,
AABB neighbour search, pivoted-QR special points) run on the host; the
expensive part — assembling and Cholesky-factoring every leaf's QTAQ system
and back-solving them each iteration — is batched on the device. Leaves are
grouped into (padded-size, rank) buckets so each bucket is one stacked
``cholesky``/``triangular_solve``. Factors can be held in f32:
right-preconditioned *flexible* GMRES tolerates an inexact preconditioner,
and halving factor memory doubles the problem size that fits on the
device.
"""

from __future__ import annotations

import dataclasses
from functools import partial as _partial

import numpy as np
import jax
import jax.numpy as jnp
import scipy.linalg

from ..config import DDMParams
from ..interpolant_config import InterpolantSettings
from ..ops.kernels import make_kernel
from ..ops.polynomials import (
    evaluate_lagrange_polynomials,
    evaluate_monomials,
    get_lagrange_coefficients,
)
from ..parallel.sharding import active_mesh, shard_axis_size
from ..utils.common import farthest_point_sampling, get_cheb_cube_scaling_factors
from ..utils.memory import ddm_factor_budget_bytes
from ..utils.telemetry import traced_stage
from .domain import Domain, _rank_from_pivoted_qr

_RANK_TOL = 1e-10


@dataclasses.dataclass
class LeafPlan:
    """Host-side description of one overlapping leaf domain."""

    point_indices: np.ndarray  # QTAQ order: special points first
    internal_mask: np.ndarray
    extents: np.ndarray
    q_top: np.ndarray | None  # (k, n-k) or None when no drift
    rank: int


@dataclasses.dataclass
class LevelBuckets:
    """Device solve plan for one level: leaves grouped by (padded n, rank)."""

    buckets: list  # of dict(pts_idx, mask, internal, q_top, chol)


class Level:
    def __init__(self, point_indices: np.ndarray):
        self.point_indices = np.asarray(point_indices, np.int64)
        self.leaf_plans: list[LeafPlan] = []
        self.device: LevelBuckets | None = None
        self.recompute = False  # factors rebuilt per application (10M path)


def _next_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _leaf_qtaq_structure(points, indices, internal_mask, settings, global_trend):
    """Special-point selection + Q_top for one leaf (host; mirrors
    ``domain.rs:164-327`` without assembling A)."""
    dpts = points[indices]
    translation, scale = get_cheb_cube_scaling_factors(dpts)
    mpts = (
        global_trend.inverse_transform_points(dpts) if global_trend is not None else dpts
    )
    monomials = evaluate_monomials(
        mpts, settings.polynomial_degree, settings.basis_size, translation, scale
    )
    _, rc, piv = scipy.linalg.qr(monomials, mode="economic", pivoting=True)
    rank = _rank_from_pivoted_qr(rc)
    cols = np.sort(piv[:rank])
    frm = monomials[:, cols]
    _, _, piv2 = scipy.linalg.qr(frm.T, mode="economic", pivoting=True)
    special = np.sort(piv2[:rank])
    is_special = np.zeros(indices.size, bool)
    is_special[special] = True
    non_special = np.nonzero(~is_special)[0]
    order = np.concatenate([special, non_special])
    lagrange = get_lagrange_coefficients(frm[special])
    q_top = -evaluate_lagrange_polynomials(frm[non_special], lagrange).T
    return indices[order], internal_mask[order], q_top, rank


@_partial(jax.jit, donate_argnums=(0,))
def _write_chunk(buf, part, lo):
    """In-place (donated) write of a factor chunk into the full batch."""
    return jax.lax.dynamic_update_slice_in_dim(buf, part, lo, axis=0)


@_partial(jax.jit, static_argnames=("kparams", "nugget", "k", "dtype"))
def _factor_bucket(pts, mask, q_top, *, kparams, nugget, k, dtype):
    """Batched QTAQ assembly + Cholesky for one (S, k) bucket.

    pts (nb, S, d); mask (nb, S); q_top (nb, k, S-k). Padded rows/cols are
    replaced by identity so the padded system stays SPD.
    """
    # Factor in the precision the SOLVES run in: with f32 factors the whole
    # assembly + Cholesky pipeline runs f32. The f32 assembly's ~1e-7 relative error is
    # irrelevant to a preconditioner whose application is f32 anyway;
    # breakdown (sqrt of a negative on a near-singular block) yields NaN
    # rows that the existing host LDL rescue re-factors. A tiny
    # scale-relative jitter keeps borderline blocks SPD in f32.
    ct = jnp.float64 if dtype == jnp.float64 else jnp.float32
    kernel = make_kernel(kparams, dtype=ct)
    pts = pts.astype(ct)
    a = kernel.pair(pts, pts)
    s = pts.shape[1]
    eye = jnp.eye(s, dtype=ct)
    if ct == jnp.float32:
        scale = jnp.max(jnp.abs(a), axis=(1, 2), keepdims=True)
        a = a + (3e-7 * scale) * eye
    a = a + jnp.asarray(nugget, ct) * eye
    outer = mask[:, :, None] & mask[:, None, :]
    a = jnp.where(outer, a, eye[None])
    if k:
        q_top = q_top.astype(ct)
        a11 = a[:, :k, :k]
        a12 = a[:, :k, k:]
        a21 = a[:, k:, :k]
        a22 = a[:, k:, k:]
        lhs = (
            jnp.einsum("bkm,bkl,bln->bmn", q_top, a11, q_top)
            + jnp.einsum("bkm,bkn->bmn", q_top, a12)
            + jnp.einsum("bmk,bkn->bmn", a21, q_top)
            + a22
        )
    else:
        lhs = a
    chol = jnp.linalg.cholesky(lhs)
    if ct == jnp.float32:
        # Device-side rescue rung: conditionally-PD kernels (TPS: zero
        # diagonal) assemble QTAQ blocks whose leading minors can go
        # negative under f32 rounding — at 10k TPS-2D a handful of domains
        # failed EVERY fit, and the host LDL rescue costs a full factor-set
        # pull + host refactor per fit. Where a
        # block's factor has NaNs, substitute the factor of a stronger
        # diagonally-shifted block (1e-4 relative): the shift perturbs only
        # the PRECONDITIONER (FGMRES is flexible), and one extra batched
        # Cholesky is noise next to the assembly einsums. Blocks that fail
        # even shifted still fall through to the host LDL rescue.
        bad = jnp.isnan(chol).any(axis=(1, 2))
        sdim = lhs.shape[1]
        dmag = jnp.max(jnp.abs(lhs), axis=(1, 2), keepdims=True)
        chol2 = jnp.linalg.cholesky(
            lhs + (1e-4 * dmag) * jnp.eye(sdim, dtype=ct))
        chol = jnp.where(bad[:, None, None], chol2, chol)
    return chol.astype(dtype)


@_partial(jax.jit, static_argnames=("k", "n_out"))
def _solve_bucket(residual, pts_idx, mask, internal, q_top, chol, *, k, n_out):
    """Batched local solves; returns the scattered internal coefficients.

    residual (n_total, nrhs); output (n_out, nrhs) with internal-point rows
    filled (disjoint across domains by DDM construction).
    """
    nrhs = residual.shape[1]
    d = residual[pts_idx] * mask[..., None]  # (nb, S, nrhs)
    if k:
        rhs = jnp.einsum("bkm,bkr->bmr", q_top, d[:, :k]) + d[:, k:]
    else:
        rhs = d
    # Solve in the factors' own precision: FGMRES is flexible, so an f32
    # preconditioner application is fine, and upcasting the factors to f64
    # would double their memory.
    st = chol.dtype
    y = jax.scipy.linalg.solve_triangular(chol, rhs.astype(st), lower=True)
    gamma = jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(chol, -1, -2), y, lower=False
    ).astype(jnp.float64)
    if k:
        lam = jnp.concatenate([jnp.einsum("bkm,bmr->bkr", q_top, gamma), gamma], axis=1)
    else:
        lam = gamma
    out = jnp.zeros((n_out + 1, nrhs), jnp.float64)
    idx = jnp.where(internal & mask, pts_idx, n_out).reshape(-1)
    out = out.at[idx].add(lam.reshape(-1, nrhs), mode="drop")
    return out[:n_out]


@_partial(jax.jit, static_argnames=("kparams", "nugget", "k", "n_out", "dtype"))
def _factor_solve_bucket(residual, pts_all, pts_idx, mask, internal, q_top,
                         *, kparams, nugget, k, n_out, dtype):
    """Recompute-from-points Schwarz solve: assemble + factor + solve in ONE
    program, storing nothing between applications.

    When the finest level's stored Cholesky factors outgrow the factor
    budget even at the 128-point leaf floor, shrinking leaves further
    collapses the preconditioner's contraction. Re-factoring per
    application instead costs ~nb * S^3/3 f32 FLOPs and keeps leaves at
    FULL strength with zero resident factor bytes. The reference has no
    analogue (its shared-memory rayon build holds all factors,
    ``domain_decomposition.rs:314``); this trades FLOPs for device
    memory. Non-SPD blocks (NaN factors) drop their domain's
    contribution for this application instead of the stored path's host
    LDL rescue.
    """
    pts = pts_all[pts_idx]
    chol = _factor_bucket(
        pts, mask, q_top, kparams=kparams, nugget=nugget, k=k, dtype=dtype
    )
    bad = jnp.isnan(chol).any(axis=(1, 2))
    spk = chol.shape[1]
    chol = jnp.where(bad[:, None, None], jnp.eye(spk, dtype=chol.dtype)[None], chol)
    internal = internal & ~bad[:, None]
    return _solve_bucket(
        residual, pts_idx, mask, internal, q_top, chol, k=k, n_out=n_out
    )


class DDMTree:
    """The multilevel overlapping decomposition, finest level first."""

    def __init__(
        self,
        points: np.ndarray,
        interpolant_settings: InterpolantSettings,
        ddm_params: DDMParams,
        global_trend=None,
        factor_dtype=jnp.float64,
    ):
        self.points = np.asarray(points, np.float64)
        self.settings = interpolant_settings
        self.params = ddm_params
        self.global_trend = global_trend
        self.factor_dtype = factor_dtype
        self.levels: list[Level] = []
        # Multi-chip: when a mesh is active (parallel.use_mesh), the Schwarz
        # leaf buckets are committed with their domain axis sharded over
        # "sp", so the batched back-solves partition across devices.
        self.mesh = active_mesh()
        self._sp = shard_axis_size(self.mesh, "sp")
        self._build()

    def _leaf_threshold_for(self, m: int) -> int:
        """Per-LEVEL leaf threshold: the largest power of two <= the user
        cap whose stored factors fit this level's share of the factor
        budget (``utils.memory.ddm_factor_budget_bytes``: a fixed share of
        the device's memory).

        A level of m points stores ~ m * S * (1+q)^2 * itemsize of
        Cholesky factors (LINEAR in leaf size S) — the reference default
        (1024) wants ~9 GB in f32 for the finest level alone at 1M points.
        Sizing PER LEVEL instead of globally (halving one global
        leaf_threshold) is what keeps the multilevel
        preconditioner strong at scale: the finest level is memory-bound
        to small domains, but each coarser level has coarse_ratio x fewer
        points and can afford proportionally larger ones. The global
        shrink left EVERY level with ~128-point domains at >= 2M points
        and the measured first-iteration contraction collapsed (60k:
        ~200x, 1M: ~6x, 2.5M: 1.06x — stagnation). Env override
        FERREUS_RBF_DDM_MEM_GB sets the budget in GB.
        """
        import os

        env = os.environ.get("FERREUS_RBF_DDM_MEM_GB")
        budget = float(env) * 1e9 if env else ddm_factor_budget_bytes()
        bytes_per = 4 if self.factor_dtype == jnp.float32 else 8
        q2 = (1.0 + self.params.overlap_quota) ** 2
        # this level's share: 40% of the budget (levels shrink by
        # coarse_ratio, so the sum over levels stays ~within budget)
        cap = int(0.4 * budget / max(m * q2 * bytes_per, 1.0))
        leaf = self.params.leaf_threshold
        # Recompute-from-points mode: when the budget cannot fit even the
        # 128-point leaf floor — the regime where floor-sized leaves
        # collapse the multilevel contraction and the fit stalls
        # — keep FULL-strength leaves and rebuild the level's factors per
        # application instead of storing them (_factor_solve_bucket).
        # FERREUS_RBF_DDM_RECOMPUTE=0 restores shrink-to-fit; =1 forces
        # recompute whenever the cap falls below the user leaf.
        rc_env = os.environ.get("FERREUS_RBF_DDM_RECOMPUTE", "auto")
        if rc_env not in ("0", "false", "False") and (
            cap < min(128, leaf)
            or (rc_env in ("1", "true", "True") and cap < leaf)
        ):
            return leaf, True
        while leaf > 128 and leaf > cap:
            leaf //= 2
        return leaf, False

    # -------------------------------------------------------------- build
    def _build(self):
        pts = self.points
        n, d = pts.shape
        p = self.params
        active = np.arange(n)

        while active.size > p.coarse_threshold:
            level = Level(active)
            leaf_t, level.recompute = self._leaf_threshold_for(active.size)
            # --- recursive median split (FIFO, like the reference) -------
            with traced_stage("ddm_split"):
                queue = [(active, self._extents_of(active))]
                leaves_raw = []
                while queue:
                    idx, ext = queue.pop(0)
                    cur = pts[idx]
                    spans = cur.max(axis=0) - cur.min(axis=0)
                    axis = int(np.argmax(spans))
                    order = np.argsort(cur[:, axis], kind="stable")
                    mid = idx.size // 2
                    left = np.sort(idx[order[:mid]])
                    right = np.sort(idx[order[mid:]])
                    mid_coord = pts[idx[order[mid]], axis]
                    lext = ext.copy()
                    lext[axis + d] = mid_coord
                    rext = ext.copy()
                    rext[axis] = mid_coord
                    if idx.size * (1.0 + p.overlap_quota) >= 2.0 * leaf_t:
                        queue.append((left, lext))
                        queue.append((right, rext))
                    else:
                        leaves_raw.append((left, lext))
                        leaves_raw.append((right, rext))

            nleaves = len(leaves_raw)
            num_coarse = int(
                np.ceil(np.ceil(active.size * p.coarse_ratio) / nleaves)
            )

            # --- coarse point selection per leaf --------------------------
            with traced_stage("ddm_coarse_sel"):
                coarse_all = []
                for idx, _ext in leaves_raw:
                    internal_points = pts[idx]
                    sample = min(idx.size, num_coarse)
                    center = internal_points.mean(axis=0)
                    dist = np.linalg.norm(internal_points - center, axis=1)
                    seed = int(np.argmin(dist))
                    sel = farthest_point_sampling(internal_points, sample, seed)
                    coarse_all.append(np.sort(idx[sel]))

            # --- overlap from neighbouring leaves' internal points --------
            with traced_stage("ddm_overlap_qtaq"):
                exts = np.stack([ext for _idx, ext in leaves_raw])
                lo, hi = exts[:, :d], exts[:, d:]
                # AABB intersection (touching counts), excluding self
                inter = np.all(
                    (lo[:, None, :] <= hi[None, :, :]) & (hi[:, None, :] >= lo[None, :, :]),
                    axis=2,
                )
                np.fill_diagonal(inter, False)

                plans = []
                for i, (idx, ext) in enumerate(leaves_raw):
                    nbr = np.nonzero(inter[i])[0]
                    nbr_idx = (
                        np.concatenate([leaves_raw[j][0] for j in nbr])
                        if nbr.size
                        else np.zeros(0, np.int64)
                    )
                    num_overlap = int(np.ceil(idx.size * 2 * p.overlap_quota))
                    if nbr_idx.size:
                        clipped = np.clip(pts[nbr_idx], ext[:d], ext[d:])
                        dist = np.linalg.norm(pts[nbr_idx] - clipped, axis=1)
                        take = np.argsort(dist, kind="stable")[:num_overlap]
                        overlap_idx = nbr_idx[take]
                    else:
                        overlap_idx = np.zeros(0, np.int64)
                    all_idx = np.concatenate([idx, overlap_idx])
                    internal = np.concatenate(
                        [np.ones(idx.size, bool), np.zeros(overlap_idx.size, bool)]
                    )
                    if self.settings.basis_size != 0:
                        all_idx, internal, q_top, rank = _leaf_qtaq_structure(
                            pts, all_idx, internal, self.settings, self.global_trend
                        )
                    else:
                        q_top, rank = None, 0
                    plans.append(
                        LeafPlan(all_idx, internal, ext, q_top, rank)
                    )

            level.leaf_plans = plans
            with traced_stage("ddm_factorise"):
                self._factorise_level(level)
            self.levels.append(level)
            active = np.sort(np.concatenate(coarse_all))

        # --- coarse level: one direct domain (host) -----------------------
        coarse_level = Level(active)
        dom = Domain(active.copy())
        dom.internal_points_mask = np.ones(active.size, bool)
        dom.factorise(
            pts, self.settings, self.settings.basis_size != 0, self.global_trend
        )
        coarse_level.coarse_domain = dom
        self.levels.append(coarse_level)

    def _extents_of(self, idx):
        sel = self.points[idx]
        return np.concatenate([sel.min(axis=0), sel.max(axis=0)])

    # ---------------------------------------------------------- device plan
    def _factorise_level(self, level: Level):
        """Group leaves into (S, k) buckets; batched factor on device."""
        kparams = self.settings.kernel_params()
        nugget = self.settings.nugget
        groups = {}
        for plan in level.leaf_plans:
            s_pad = _next_multiple(max(plan.point_indices.size, 8), 64)
            groups.setdefault((s_pad, plan.rank), []).append(plan)

        buckets = []
        recompute = bool(getattr(level, "recompute", False))
        for (s_pad, k), plans in groups.items():
            nb = len(plans)
            pts_idx = np.zeros((nb, s_pad), np.int64)
            mask = np.zeros((nb, s_pad), bool)
            internal = np.zeros((nb, s_pad), bool)
            q_top = np.zeros((nb, k, s_pad - k))
            for b, plan in enumerate(plans):
                npts = plan.point_indices.size
                pts_idx[b, :npts] = plan.point_indices
                mask[b, :npts] = True
                internal[b, :npts] = plan.internal_mask
                if k:
                    q_top[b, :, : npts - k] = plan.q_top
            if recompute:
                bucket = {
                    "pts_idx": pts_idx,
                    "mask": mask,
                    "internal": internal,
                    "q_top": q_top,
                    "k": k,
                }
                committed = self._commit_bucket(bucket)
                committed["recompute"] = True
                committed["s_pad"] = s_pad
                buckets.append(committed)
                continue
            pts_b = self.points[pts_idx]
            # Factor in fixed-size batch chunks: assembling every domain's
            # (S, S) system at once scales as nb*S^2 temporaries (55 GB at
            # 200k points). Chunk size targets ~2 GB of
            # assembly temporaries; pow2-fixed so one program serves all
            # chunks, with the last chunk padded by repeating row 0 (its
            # factors are discarded).
            per_dom = s_pad * s_pad * 8 * 6  # A + QTAQ temps + cholesky ws
            cap = max(1, int(2e9 // per_dom))
            nb_chunk = 1 << (cap.bit_length() - 1)
            if nb_chunk >= nb:
                chol = _factor_bucket(
                    jnp.asarray(pts_b),
                    jnp.asarray(mask),
                    jnp.asarray(q_top),
                    kparams=kparams,
                    nugget=nugget,
                    k=k,
                    dtype=self.factor_dtype,
                )
            else:
                # Accumulate chunks into a DONATED buffer (in-place update):
                # collecting per-chunk outputs and concatenating keeps 2x
                # the factor set live (at 2.2M points a 4.5 GB f32 factor
                # batch would need 9 GB during the concat spike).
                chol = jnp.zeros(
                    (nb, s_pad - k, s_pad - k), self.factor_dtype)
                for lo in range(0, nb, nb_chunk):
                    hi = min(lo + nb_chunk, nb)
                    sel = np.arange(lo, hi)
                    if hi - lo < nb_chunk:
                        sel = np.concatenate(
                            [sel, np.zeros(nb_chunk - (hi - lo), np.int64)])
                    part = _factor_bucket(
                        jnp.asarray(pts_b[sel]),
                        jnp.asarray(mask[sel]),
                        jnp.asarray(q_top[sel]),
                        kparams=kparams,
                        nugget=nugget,
                        k=k,
                        dtype=self.factor_dtype,
                    )[: hi - lo]
                    chol = _write_chunk(chol, part, lo)
            # Factors stay device-resident: pulling (nb, S, S) to host just
            # for the NaN check would copy the whole factor set both ways.
            # One scalar any-NaN reduction decides.
            if bool(jnp.any(jnp.isnan(chol))):
                # numerically indefinite bucket: re-factor the offending
                # domains on the host with the LDL fallback (``domain.rs:63``)
                chol = np.array(chol)  # writable host copy for the rescue
                bad = np.nonzero(np.isnan(chol).any(axis=(1, 2)))[0]
                chol = self._host_refactor(plans, chol, bad, k)
            bucket = {
                "pts_idx": pts_idx,
                "mask": mask,
                "internal": internal,
                "q_top": q_top,
                "chol": chol,
                "k": k,
            }
            committed = self._commit_bucket(bucket)
            committed["recompute"] = False
            buckets.append(committed)
        level.device = LevelBuckets(buckets)

    def _commit_bucket(self, bucket):
        """Put one bucket's arrays on device; shard over "sp" when meshed.

        Padded domains repeat domain 0 with ``internal=False`` so the padded
        solves run (identically on every shard) but scatter nothing.
        """
        k = bucket.pop("k")
        sp = self._sp
        nb = bucket["pts_idx"].shape[0]
        pad = (-nb) % sp
        if pad:
            for key, a in bucket.items():
                xp = jnp if isinstance(a, jnp.ndarray) else np
                a = xp.concatenate([a, xp.repeat(a[:1], pad, axis=0)])
                if key == "internal":
                    a = np.asarray(a)
                    a[nb:] = False
                bucket[key] = a
        if sp > 1:
            from jax.sharding import NamedSharding, PartitionSpec

            out = {
                key: jax.device_put(
                    jnp.asarray(a),
                    NamedSharding(
                        self.mesh, PartitionSpec("sp", *([None] * (a.ndim - 1)))
                    ),
                )
                for key, a in bucket.items()
            }
        else:
            out = {key: jnp.asarray(a) for key, a in bucket.items()}
        out["k"] = k
        return out

    def _host_refactor(self, plans, chol, bad, k):
        """Host fallback for non-SPD leaves: dense Cholesky with jitter."""
        from ..ops.dense import get_a_matrix_symmetric_solver

        kparams = self.settings.kernel_params()
        for b in bad:
            plan = plans[b]
            dpts = self.points[plan.point_indices]
            a = np.asarray(
                get_a_matrix_symmetric_solver(dpts, kparams, self.settings.nugget, xp=np)
            )
            if k:
                q = plan.q_top
                a11, a12 = a[:k, :k], a[:k, k:]
                a21, a22 = a[k:, :k], a[k:, k:]
                lhs = q.T @ (a11 @ q) + q.T @ a12 + a21 @ q + a22
            else:
                lhs = a
            # symmetric-indefinite rescue: add a tiny diagonal shift
            shift = 1e-12 * max(np.abs(np.diag(lhs)).max(), 1.0)
            for _ in range(8):
                try:
                    l = np.linalg.cholesky(lhs + shift * np.eye(lhs.shape[0]))
                    break
                except np.linalg.LinAlgError:
                    shift *= 10.0
            else:
                # genuinely indefinite block (the reference escalates
                # Llt -> Lblt here, domain.rs:63): clip the spectrum to an
                # SPD floor and factor that — the block is only a
                # preconditioner, so nearest-SPD is legitimate and this
                # path cannot fail.
                ew, ev = np.linalg.eigh((lhs + lhs.T) / 2.0)
                floor = 1e-12 * max(float(ew.max()), 1.0)
                l = np.linalg.cholesky(
                    (ev * np.maximum(ew, floor)) @ ev.T
                    + floor * np.eye(lhs.shape[0])
                )
            npad = chol.shape[1]
            l_pad = np.eye(npad, dtype=chol.dtype)
            l_pad[: l.shape[0], : l.shape[1]] = l
            chol[b] = l_pad
        return chol

    # ------------------------------------------------------------- solves
    def solve_fine_level(self, level_idx: int, residual: np.ndarray) -> np.ndarray:
        """All leaf solves of one level; returns internal-row coefficients."""
        level = self.levels[level_idx]
        res = jnp.asarray(residual)
        if self._sp > 1:
            from jax.sharding import NamedSharding, PartitionSpec

            res = jax.device_put(res, NamedSharding(self.mesh, PartitionSpec()))
        n_out = residual.shape[0]
        out = jnp.zeros((n_out, residual.shape[1]), jnp.float64)
        for bucket in level.device.buckets:
            if bucket.get("recompute"):
                out = self._solve_recompute_bucket(bucket, res, out, n_out)
                continue
            nb = int(bucket["chol"].shape[0])
            s_pad = int(bucket["chol"].shape[1])
            # Bound the batched triangular-solve temps: XLA materialises
            # inverted diagonal blocks ~ the batch's factor bytes, so one
            # 24k-domain call at 3M points (6.4 GB of f32 factors) doubles
            # its footprint. 1 GB chunks keep the solve
            # temps bounded; sharded buckets stay whole (their domain axis
            # is already partitioned over "sp").
            bytes_per = s_pad * s_pad * bucket["chol"].dtype.itemsize
            chunk = nb if self._sp > 1 else max(
                1, min(nb, (1 << 30) // max(bytes_per, 1)))
            for lo in range(0, nb, chunk):
                hi = min(lo + chunk, nb)
                out = out + _solve_bucket(
                    res,
                    bucket["pts_idx"][lo:hi],
                    bucket["mask"][lo:hi],
                    bucket["internal"][lo:hi],
                    bucket["q_top"][lo:hi],
                    bucket["chol"][lo:hi],
                    k=bucket["k"],
                    n_out=n_out,
                )
        return out  # device array; callers pull to host only when needed

    def _solve_recompute_bucket(self, bucket, res, out, n_out):
        """Assemble + factor + solve one storage-free bucket, chunked so the
        per-chunk (c, S, S) assembly/factor transients stay ~2 GB."""
        if not hasattr(self, "_pts_dev") or self._pts_dev is None:
            self._pts_dev = jnp.asarray(self.points)
        nb = int(bucket["pts_idx"].shape[0])
        s_pad = int(bucket["s_pad"])
        bytes_per = s_pad * s_pad * 8 * 6  # A + QTAQ temps + cholesky ws
        chunk = max(1, min(nb, int(2e9) // max(bytes_per, 1)))
        chunk = 1 << (chunk.bit_length() - 1)
        for lo in range(0, nb, chunk):
            hi = min(lo + chunk, nb)
            out = out + _factor_solve_bucket(
                res,
                self._pts_dev,
                bucket["pts_idx"][lo:hi],
                bucket["mask"][lo:hi],
                bucket["internal"][lo:hi],
                bucket["q_top"][lo:hi],
                kparams=self.settings.kernel_params(),
                nugget=self.settings.nugget,
                k=bucket["k"],
                n_out=n_out,
                dtype=self.factor_dtype,
            )
        return out

    def coarse_device_arrays(self):
        """Device-resident coarse solve data for the fused FGMRES cycle.

        Returns (arrays, k, solve_for_poly) with arrays = {idx, q_top, chol,
        a_special, inv_special} as device arrays, or None when the coarse
        factorisation fell back to LDL (numerically indefinite — the fused
        path is then unavailable and callers keep the host loop).
        """
        dom: Domain = self.levels[-1].coarse_domain
        if not dom.is_spd:
            return None
        k = dom.num_special
        nc = dom.num_points
        arrays = {
            "idx": jnp.asarray(dom.overlapping_point_indices),
            "chol": jnp.asarray(dom.cholesky_lower()),
            "q_top": jnp.asarray(
                dom.q_matrix_top if dom.q_matrix_top is not None
                else np.zeros((0, nc))
            ),
            "a_special": jnp.asarray(
                dom.a_special_points_rows if dom.a_special_points_rows is not None
                else np.zeros((k, nc))
            ),
            "inv_special": jnp.asarray(
                scipy.linalg.lu_solve(dom._special_point_lu, np.eye(k))
                if dom._special_point_lu is not None
                else np.zeros((k, k))
            ),
        }
        return arrays, k, dom.solve_for_poly

    def solve_coarse(self, residual, add_poly: bool):
        """Direct coarse solve; optionally returns the polynomial tail.

        Device-friendly: only the coarse-domain rows cross the host boundary
        (the coarse factorisation is a host direct solve); the scatter back
        happens on the device.
        """
        coarse = self.levels[-1]
        dom: Domain = coarse.coarse_domain
        if not hasattr(coarse, "_idx_dev"):
            coarse._idx_dev = jnp.asarray(dom.overlapping_point_indices)
        gathered = np.asarray(jnp.asarray(residual)[coarse._idx_dev])
        sol = dom.solve_gathered(gathered)
        n_total = residual.shape[0]
        out = jnp.zeros((n_total, residual.shape[1]), jnp.float64)
        out = out.at[coarse._idx_dev].set(jnp.asarray(sol.point_coefficients))
        if dom.solve_for_poly and add_poly and sol.poly_coefficients is not None:
            m = sol.poly_coefficients.shape[0]
            out = out.at[-m:].set(jnp.asarray(sol.poly_coefficients))
        return out
