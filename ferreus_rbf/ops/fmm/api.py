"""FmmTree: the user-facing BBFMM evaluator.

Public surface mirrors ``ferreus_bbfmm::FmmTree`` (``bbfmm.rs:257-616``):
``set_weights`` (upward pass), ``evaluate`` / ``evaluate_with_gradients``
(downward + leaf pass), ``set_local_coefficients`` (full-tree downward pass,
amortised for repeated evaluation) and ``evaluate_leaves`` /
``evaluate_leaves_with_gradients`` (leaf pass only). Multi-RHS throughout.

Execution model:

* the octree, interaction lists and bucket/padding layout are built once on
  the host (``tree.py``) as flat index arrays;
* multipole/local coefficients live on device as one (ncells, p^d, nrhs)
  tensor;
* every pass is a batched einsum/gather pipeline jitted once per tree:
  P2M/L2P contract padded leaf-bucket weight tensors, M2M/L2L are 2^d
  (p^d, p^d) matmuls per level, M2L gathers permuted multipole columns per
  (level, reference-vector) group and applies the compressed (U, V^T) pair
  as two big matmuls, and the near-field P2P contracts phi(r2) tiles
  against source weights in fixed-size chunks;
* every pass runs in one of two precisions: ``"f64"`` (the reference's
  arithmetic) or ``"f32"`` (the mixed-precision solver's inner matvec);
* target batches are bucketed per leaf on the host with power-of-two shape
  quantisation so repeated calls (isosurfacing wavefronts, solver matvecs)
  reuse compiled programs; plan arrays are passed to the jitted passes as a
  pytree argument (not closure constants) to keep HLO small;
* the rayon-and-raw-pointer scatters of the reference become ``.at[].add``
  over disjoint or duplicate index sets.
"""

from __future__ import annotations

from functools import partial as _partial

import numpy as np
import jax
import jax.numpy as jnp

from ...config import FmmCompressionType, FmmParams
from ..kernels import Kernel, KernelParams, make_kernel
from . import cheb, m2l, tree as tree_mod
from .tree import Octree, PointOutsideTreeError, calculate_tree_center_and_radius

__all__ = ["FmmTree", "PointOutsideTreeError", "KernelDoesNotSupportGradientsError"]

PRECISIONS = ("f32", "f64")


def _check_precision(prec: str) -> None:
    if prec not in PRECISIONS:
        raise ValueError(
            f"precision must be one of {PRECISIONS}, got {prec!r}"
        )


def _ctype(prec: str):
    return jnp.float32 if prec == "f32" else jnp.float64


class KernelDoesNotSupportGradientsError(ValueError):
    def __init__(self):
        super().__init__(
            "FMM evaluation failed: gradient evaluation requested but kernel "
            "does not support gradients"
        )


def _next_pow2(n) -> int:
    n = int(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _chunk_m2l_level(u_stack, vt_stack, src_tab, level_cells, nnodes,
                     src_cells):
    """Device M2L level entry, target-slot layout, chunked over target slots.

    ``src_tab`` is (g, C): for m2l vector id g and target slot c it holds
    the LOCAL index into ``src_cells`` of the source cell (sentinel = the
    zero pad row) — well-defined because a vector id names a unique
    relative offset, so each (vid, tgt) pair has at most one source. This
    shape lets the downward pass reduce the vid axis INSIDE one dot_general
    (no per-pair intermediate, no non-unique scatter). The slot axis is
    split into chunks so the gathered (g, C_chunk, p^d, r) multipole
    transient stays bounded in device memory.
    """
    g, c_pad = src_tab.shape
    # elements per chunked gather: bounds the (g, C_chunk, p^d, r)
    # transient of one scan step, whatever the level's slot count
    budget = 1 << 23
    c_chunk = max(16, budget // max(g * nnodes, 1))
    c_chunk = 1 << (int(c_chunk).bit_length() - 1)
    c_chunk = min(c_chunk, c_pad)
    nchunk = (c_pad + c_chunk - 1) // c_chunk
    if c_pad % c_chunk:  # c_pad is pow2 and c_chunk <= c_pad, so it divides
        raise AssertionError((c_pad, c_chunk))
    src_r = src_tab.reshape(g, nchunk, c_chunk).transpose(1, 0, 2)
    return (
        jnp.asarray(u_stack),
        None if vt_stack is None else jnp.asarray(vt_stack),
        jnp.asarray(np.ascontiguousarray(src_r)),
        jnp.asarray(src_cells),
        jnp.asarray(level_cells),
    )


# --------------------------------------------------------------------- jitted
# Module-level pass functions: all tree-specific data arrives in the `dev`
# pytree argument; only the kernel closures / dimensionality arrive statically.


def _weight_tiles(dev, weights, ct):
    """(nsl+1, smax, nrhs) per-leaf weight tiles gathered from the user's
    weight array in ONE gather (zero weights in pad slots and in the
    sentinel tile nsl); shared by P2M, P2L and the tiled near field."""
    return jnp.where(
        dev["src_bucket_mask"][..., None],
        weights.astype(ct)[dev["src_tile_orig_idx"]],
        ct(0.0),
    )


def _p2m_apply(mult, xs, pts_c, nodes_t, *, d, ct, w_sorted=None):
    """Shared P2M body: anterpolate + contract each leaf chunk of ``xs``
    (idx, msk, ctr, len, cells[, wb]) into ``mult`` (scan when >1 chunk).
    Used by :func:`_upward` (full scan) and :func:`_sharded_upward` (each
    device's chunk slice)."""

    def p2m_chunk(mult_acc, sl):
        idx, msk, ctr, ln, cells = sl[:5]
        w_t, _ = cheb.anterpolation_weights(
            pts_c[idx], ctr.astype(ct), ln.astype(ct), nodes_t, d, xp=jnp
        )
        # Mask pad SLOTS on the weight side too: their garbage points sit
        # far outside the cell and the Chebyshev extrapolation explodes
        # (observed 1.7e11) — harmless against zero wb in exact
        # arithmetic, but not worth the rounding.
        w_t = jnp.where(msk[..., None], w_t, ct(0.0))
        if len(sl) == 6:
            wb = sl[5]  # pre-gathered, already masked
        else:
            wb = jnp.where(msk[..., None], w_sorted[idx].astype(ct), ct(0.0))
        contrib = jnp.einsum("lsp,lsr->lpr", w_t, wb)
        return mult_acc.at[cells].add(contrib, mode="drop"), None

    if xs[0].shape[0] == 1:
        mult, _ = p2m_chunk(mult, tuple(a[0] for a in xs))
    else:
        mult, _ = jax.lax.scan(p2m_chunk, mult, xs)
    return mult


def _m2m_apply(dev, mult, *, ct):
    """Shared bottom-up M2M sweep, one parent-major group per level.

    ``mult`` carries the zero sentinel row (index ncells) that absent
    children gather. Each parent contracts all its children in one einsum
    over (octant, node) and is written by ONE unique-index add — no
    duplicate-index scatter, so the sweep is deterministic on backends
    whose duplicate-index scatter-adds run in arbitrary order."""
    m2m_c = dev["m2m_ops"].astype(ct)
    for parents, children in dev["m2m_groups"]:
        x = mult[children]  # (P, 2^d, p^d, r)
        contrib = jnp.einsum("opq,Poqr->Ppr", m2m_c, x)
        mult = mult.at[parents].add(contrib, unique_indices=True)
    return mult


@_partial(jax.jit, static_argnames=("prec",))
def _upward(dev, weights, w_tiles=None, *, prec="f64"):
    """weights (N, nrhs), original point order -> (multipole, w_sorted).

    ``prec="f32"`` runs P2M/M2M in float32 (mixed-precision inner matvec).
    The multipole expansion is upcast on return so downstream code always
    sees f64.

    P2M anterpolation weights are computed ON THE FLY per leaf chunk (a
    precomputed (nsl, smax, p^d) table costs 7.8 GB at 1M points) — the
    Chebyshev recurrences are a tiny fraction of the contraction cost.
    """
    ct = _ctype(prec)
    w_sorted = weights[dev["point_order"]]
    ncells = dev["cell_centers"].shape[0]
    nnodes = dev["m2m_ops"].shape[1]
    d = dev["cell_centers"].shape[1]
    nodes_t = dev["nodes_t"].astype(ct)
    pts_c = dev["pts_sorted"].astype(ct)
    mult = jnp.zeros((ncells + 1, nnodes, weights.shape[1]), ct)

    idx_r, msk_r, ctr_r, len_r, cells_r = dev["p2m_scan"]
    xs = (idx_r, msk_r, ctr_r, len_r, cells_r)

    # Pre-gathered weight tiles (the fused matvec's ONE consolidated
    # gather) replace the per-chunk w_sorted[idx] gathers; reshaped into
    # the p2m scan's (nchunk, chunk, smax, r) layout by contiguous pad.
    if w_tiles is not None:
        # src_bucket_idx carries the zero-weight sentinel as its LAST row;
        # the p2m scan covers only the true leaves
        nsl = dev["src_bucket_idx"].shape[0] - 1
        nsl_pad = idx_r.shape[0] * idx_r.shape[1]
        wb_all = w_tiles[:nsl].astype(ct)
        if nsl_pad > nsl:
            wb_all = jnp.pad(wb_all, ((0, nsl_pad - nsl), (0, 0), (0, 0)))
        xs = xs + (wb_all.reshape((idx_r.shape[0], idx_r.shape[1]) + wb_all.shape[1:]),)

    mult = _p2m_apply(mult, xs, pts_c, nodes_t, d=d, ct=ct, w_sorted=w_sorted)
    # the pad-leaf sentinel row is still zero: M2M's absent children
    # gather it; dropped afterwards
    mult = _m2m_apply(dev, mult, ct=ct)[:-1]
    return mult.astype(jnp.float64), w_sorted


def _sharded_upward(mesh, dev, weights, w_tiles, *, prec):
    """P2M with the leaf-chunk axis partitioned over "sp"; M2M replicated.

    P2M is leaf-parallel exactly like the near field (the reference's
    rayon leaf loop, ``bbfmm.rs:669-682``): each device anterpolates its
    own slice of the (nchunk, chunk) leaf tables into a local multipole
    accumulator and ONE ``psum`` over "sp" merges them — each leaf cell is
    written by exactly one chunk row, so every cell's value is produced by
    a single device and the psum adds it to zeros: n-device results stay
    BITWISE equal to the 1-device program. The psum moves the
    (ncells+1, p^d, nrhs) array (a few MB at 1M points) between devices
    once per matvec. M2M stays replicated: it touches ~1/2^d of the cells
    with einsums too small to win back a collective.
    """
    from jax.sharding import PartitionSpec as P

    ct = _ctype(prec)
    w_sorted = weights[dev["point_order"]]
    ncells = dev["cell_centers"].shape[0]
    nnodes = dev["m2m_ops"].shape[1]
    d = dev["cell_centers"].shape[1]
    nodes_t = dev["nodes_t"].astype(ct)
    pts_c = dev["pts_sorted"].astype(ct)

    idx_r, msk_r, ctr_r, len_r, cells_r = dev["p2m_scan"]
    nchunk, chunk = idx_r.shape[0], idx_r.shape[1]
    nsp = int(mesh.shape["sp"])
    ncp = -(-nchunk // nsp) * nsp  # pad chunks so the axis divides the mesh

    nsl = dev["src_bucket_idx"].shape[0] - 1
    wb_all = w_tiles[:nsl].astype(ct)
    if ncp * chunk > nsl:
        wb_all = jnp.pad(wb_all, ((0, ncp * chunk - nsl), (0, 0), (0, 0)))
    wb_r = wb_all.reshape((ncp, chunk) + wb_all.shape[1:])

    def _padc(a, const):
        if ncp == nchunk:
            return a
        pad = [(0, ncp - nchunk)] + [(0, 0)] * (a.ndim - 1)
        return jnp.pad(a, pad, constant_values=const)

    # pad-chunk values mirror the plan's sentinel rows (api plan build):
    # idx 0, mask False, centre/length 1, cell = the dropped sentinel row
    xs = (_padc(idx_r, 0), _padc(msk_r, False), _padc(ctr_r, 1.0),
          _padc(len_r, 1.0), _padc(cells_r, ncells), wb_r)

    def block(*xs_b):
        mult0 = jnp.zeros((ncells + 1, nnodes, weights.shape[1]), ct)
        mult_loc = _p2m_apply(mult0, xs_b, pts_c, nodes_t, d=d, ct=ct)
        return jax.lax.psum(mult_loc, "sp")

    mult = jax.shard_map(
        block, mesh=mesh, in_specs=(P("sp"),) * 6, out_specs=P(),
        check_vma=False,
    )(*xs)
    mult = _m2m_apply(dev, mult, ct=ct)[:-1]  # see _upward
    return mult.astype(jnp.float64), w_sorted


def _m2l_slots(u_c, vt_c, x):
    """M2L for a block of target slots: ``x`` (g, c, p^d|k, r) gathered
    source multipoles -> (c, p^d, r) local contributions, contracting BOTH
    the vector-id and rank axes in one dot:
    y[c, p, r] = sum_{g,k} U[g,p,k] (Vt[g] x[g, c])[k, r]."""
    z = x if vt_c is None else jnp.einsum("gkq,gcqr->gckr", vt_c, x)
    y = jax.lax.dot_general(
        u_c, z, dimension_numbers=(((0, 2), (0, 2)), ((), ()))
    )
    return y.transpose(1, 0, 2)


@_partial(jax.jit, static_argnames=("kparams", "prec"))
def _downward(dev, mult, w_sorted, w_tiles=None, *, kparams, prec="f64"):
    """Full-tree downward pass: M2L + P2L, then L2L top-down.

    ``prec="f32"`` runs the M2L/P2L/L2L matmuls in float32 (the
    mixed-precision solver's inner-iteration mode). The result is upcast
    at the end so downstream code always sees f64.
    """
    ct = _ctype(prec)
    mult_c = mult.astype(ct)
    local = jnp.zeros((mult_c.shape[0] + 1,) + mult_c.shape[1:], ct)
    # One fused contraction per level, scanned over target-slot chunks
    # (memory-bounded; see _chunk_m2l_level). Groups are per m2l *vector id*
    # with the symmetry permutation pre-folded into (U, Vt) at plan time
    # (see _build_plan) — no runtime permutation gathers. The target-slot
    # layout reduces the vid axis inside the dot_general, so no per-pair
    # (g, m, p^d, r) intermediate is written and the only scatter is one
    # unique-index add of the finished level block.
    mult_pad = jnp.concatenate(
        [mult_c, jnp.zeros((1,) + mult_c.shape[1:], ct)], axis=0
    )
    for u_stack, vt_stack, src_r, src_cells, level_cells in dev["m2l_levels"]:
        u_c = u_stack.astype(ct)  # (g, p^d, k)
        vt_c = None if vt_stack is None else vt_stack.astype(ct)  # (g, k, p^d)
        # Each level gathers its sources ONCE into a compact (S+1, p^d, r)
        # block (sentinel = the zero pad row); slot chunks then re-gather
        # from the compact block, not the whole-tree multipole table.
        mult_src = mult_pad[src_cells]

        def _level_chunk(_, src_c, u_c=u_c, vt_c=vt_c, mult_src=mult_src):
            return None, _m2l_slots(u_c, vt_c, mult_src[src_c])

        if src_r.shape[0] == 1:
            _, y_all = _level_chunk(None, src_r[0])
        else:
            _, y_c = jax.lax.scan(_level_chunk, None, src_r)
            y_all = y_c.reshape((-1,) + y_c.shape[2:])
        local = local.at[level_cells].add(y_all, mode="drop", unique_indices=True)

    return _downward_tail(dev, local, w_sorted, w_tiles, kparams=kparams, prec=prec)


def _downward_tail(dev, local, w_sorted, w_tiles=None, *, kparams, prec="f64"):
    """P2L (x-list) + top-down L2L on a populated local table.

    ``local`` arrives with the pad-target sentinel row still attached
    ((ncells + 1) rows — as the M2L loop or :func:`_sharded_m2l` leaves
    it); returns the finished (ncells, p^d, r) f64 local expansions.
    """
    ct = _ctype(prec)
    kernel = make_kernel(kparams, dtype=ct)
    local = local[:-1]  # drop the pad-target sentinel row

    p2l = dev["p2l"]
    if p2l is not None:
        # target-major, scanned over target chunks: each x-list target
        # contracts its (padded) source leaves in one einsum and is written
        # by ONE unique-index add (deterministic; see _m2m_apply). Pad
        # targets carry distinct out-of-range indices and are dropped.
        def p2l_chunk(loc, sl):
            tgt, src_rows, centers, lengths = sl  # (c,), (c, k), (c, d), (c,)
            nodes_scaled = cheb.scale_nodes_to_cell(dev["nodes_nd"], centers, lengths, xp=jnp)
            sidx = dev["src_bucket_idx"][src_rows]  # (c, k, smax)
            smask = dev["src_bucket_mask"][src_rows]
            spts = dev["pts_sorted"][sidx]
            k = jnp.where(smask[:, :, None, :],
                          kernel.pair(nodes_scaled[:, None], spts), ct(0.0))
            if w_tiles is not None:
                wvals = w_tiles[src_rows].astype(ct)  # pre-masked
            else:
                wvals = jnp.where(smask[..., None], w_sorted[sidx].astype(ct), ct(0.0))
            y = jnp.einsum("ckps,cksr->cpr", k, wvals)
            return loc.at[tgt].add(y, mode="drop", unique_indices=True), None

        if p2l[0].shape[0] == 1:
            local, _ = p2l_chunk(local, tuple(a[0] for a in p2l))
        else:
            local, _ = jax.lax.scan(p2l_chunk, local, p2l)

    m2m_c = dev["m2m_ops"].astype(ct)
    for ch_t, pa_t in dev["l2l_groups"]:
        x = local[pa_t]  # (2^d, cmax, p^d, r); pads gather row 0
        contrib = jnp.einsum("opq,ocpr->ocqr", m2m_c, x)
        local = local.at[ch_t].add(contrib, mode="drop")  # pads scatter-drop
    return local.astype(jnp.float64)


def _l2p_impl(dev, targets, tgt_idx, tgt_mask, tcells, local, *, d, p, with_grads, prec="f64", ecs=1024):
    """L2P scanned over target-row chunks: the anterpolation-weight
    transient is (chunk, T, p^d), not (all rows, T, p^d) — the full table
    is ~4 GB at 1M targets with p=7. ``ecs`` (FmmParams.eval_chunk_size)
    linearly scales the transient budget; 1024 is the reference default."""
    ct = _ctype(prec)
    nodes_t = dev["nodes_t"].astype(ct)
    tpts = targets[tgt_idx]
    rows, t = tgt_idx.shape
    nnodes = local.shape[-2]
    # budget 1<<23 elements per chunk for the (chunk, T, p^d) weights
    chunk = max(8, ((1 << 23) * max(int(ecs), 1) // 1024) // max(t * nnodes, 1))
    chunk = 1 << (int(chunk).bit_length() - 1)
    chunk = min(chunk, rows)  # rows is pow2-padded, so chunk divides it

    def l2p_chunk(_, sl):
        tp, tc = sl
        centers = dev["cell_centers"][tc].astype(ct)
        lengths = dev["cell_lengths"][tc].astype(ct)
        loc = local[tc].astype(ct)
        w_t, dw_t = cheb.anterpolation_weights(
            tp.astype(ct), centers, lengths, nodes_t, d,
            xp=jnp, with_gradients=with_grads
        )
        # the f32 tier accumulates the whole leaf pass in f32 (halves the
        # memory traffic of the adds + the unbucket gather)
        vals = jnp.einsum("ltp,lpr->ltr", w_t, loc)
        if with_grads:
            grads = jnp.einsum("ltdp,lpr->ltrd", dw_t, loc).astype(jnp.float64)
        else:
            grads = jnp.zeros(vals.shape + (d,), jnp.float64)
        return None, (vals, grads)

    if chunk == rows:
        _, (vals_b, grads_b) = l2p_chunk(None, (tpts, tcells))
    else:
        nch = rows // chunk
        resh = lambda a: a.reshape((nch, chunk) + a.shape[1:])
        _, (v, g) = jax.lax.scan(l2p_chunk, None, (resh(tpts), resh(tcells)))
        vals_b = v.reshape((rows,) + v.shape[2:])
        grads_b = g.reshape((rows,) + g.shape[2:])
    return tpts, vals_b, grads_b


def _near_field_class(
    kernel, with_grads, ct,
    tpts, src_coords, src_vals, rows, idx_tab, mask_tab, chunk,
):
    """One width class of the near field, scanned over ROW CHUNKS with the
    source gathers INSIDE the scan body — the fully-gathered (R, S, d+nrhs)
    tables are multi-GB at 1M points, so only one chunk is ever live.

    ``src_coords`` is either a (N, d) coordinate table (P2P: the sorted
    points) or a ``(centers, lengths, nodes_nd)`` tuple (M2P): the flat
    per-cell Chebyshev node table is (ncells * p^d, d) f64 — 1.4 GB at 10M
    points — so M2P nodes are recomputed per gathered index instead of
    stored (bitwise equal: same ``center + (length/2) * node`` f64 ops)."""
    virtual_nodes = isinstance(src_coords, tuple)
    if virtual_nodes:
        centers64, lengths64, nodes_nd64 = src_coords
        nnodes = nodes_nd64.shape[0]
    else:
        coords_c = src_coords.astype(ct)
    vals_c = src_vals.astype(ct)

    def body(_, xs):
        rws, sidx, smask = xs
        if virtual_nodes:
            c_idx = sidx // nnodes
            sp = (centers64[c_idx]
                  + (lengths64[c_idx][..., None] * 0.5)
                  * nodes_nd64[sidx % nnodes]).astype(ct)
        else:
            sp = coords_c[sidx]  # (chunk, S, d)
        wv = jnp.where(smask[..., None], vals_c[sidx], ct(0.0))
        tp = tpts[rws].astype(ct)
        if with_grads:
            k, g = kernel.pair_with_grad(tp, sp)
            k = jnp.where(smask[:, None, :], k, 0.0)
            g = jnp.where(smask[:, None, :, None], g, 0.0)
            vals = jnp.einsum("cts,csr->ctr", k, wv)
            grads = jnp.einsum("ctsd,csr->ctrd", g, wv)
            return None, (vals, grads)
        k = jnp.where(smask[:, None, :], kernel.pair(tp, sp), 0.0)
        vals = jnp.einsum("cts,csr->ctr", k, wv)
        return None, (vals, jnp.zeros(vals.shape + (tp.shape[-1],), ct))

    r = rows.shape[0]
    nc = r // chunk
    if nc <= 1:
        _, (vals, grads) = body(None, (rows, idx_tab, mask_tab))
        return vals, grads
    resh = lambda a: a.reshape((nc, chunk) + a.shape[1:])
    _, (vals, grads) = jax.lax.scan(
        body, None, (resh(rows), resh(idx_tab), resh(mask_tab))
    )
    return vals.reshape((r,) + vals.shape[2:]), grads.reshape((r,) + grads.shape[2:])


def _near_field_rows(kernel, with_grads, ct, tpts, src_coords, src_vals,
                     groups, meta, vals_b, grads_b):
    """Add every width class of one near-field leg (P2P or M2P) into the
    bucket rows. Rows of one class are disjoint, so the adds are
    unique-index scatters of finished rows."""
    for (rows, idx_tab, mask_tab), (_w_class, chunk) in zip(groups, meta):
        vals, grads = _near_field_class(
            kernel, with_grads, ct, tpts, src_coords, src_vals,
            rows, idx_tab, mask_tab, chunk,
        )
        vals_b = vals_b.at[rows].add(vals.astype(vals_b.dtype), mode="drop", unique_indices=True)
        if with_grads:
            grads_b = grads_b.at[rows].add(grads.astype(jnp.float64), mode="drop", unique_indices=True)
    return vals_b, grads_b


@_partial(jax.jit, static_argnames=("kparams", "d", "p", "n_pad", "p2p_meta", "m2p_meta", "with_grads", "prec", "ecs"))
def _leaf_all(
    dev, targets, tgt_idx, tgt_mask, tcells, local, mult, w_sorted,
    p2p_groups, m2p_groups, inv_row, inv_slot,
    *, kparams, d, p, n_pad,
    p2p_meta, m2p_meta, with_grads, prec="f64", ecs=1024,
):
    """The whole leaf pass as ONE compiled program.

    L2P is a direct bucket einsum. The near field is target-row-major: each
    target bucket row owns the concatenation of its u-list source points
    (P2P) and of its w-list cells' Chebyshev nodes (M2P), padded to a
    power-of-two width class and scanned in row chunks. No scatter appears
    in any loop.
    """
    ct = _ctype(prec)
    kernel = make_kernel(kparams, dtype=ct)
    # named scopes: stable names for the passes in profiler traces
    with jax.named_scope("l2p"):
        tpts, vals_b, grads_b = _l2p_impl(
            dev, targets, tgt_idx, tgt_mask, tcells, local, d=d, p=p,
            with_grads=with_grads, prec=prec, ecs=ecs
        )
    with jax.named_scope("p2p"):
        vals_b, grads_b = _near_field_rows(
            kernel, with_grads, ct, tpts, dev["pts_sorted"], w_sorted,
            p2p_groups, p2p_meta, vals_b, grads_b,
        )
    # M2P over concatenated w-cell Chebyshev-node tables
    with jax.named_scope("m2p"):
        vals_b, grads_b = _near_field_rows(
            kernel, with_grads, ct, tpts,
            (dev["cell_centers"], dev["cell_lengths"], dev["nodes_nd"]),
            mult.reshape(-1, mult.shape[-1]), m2p_groups, m2p_meta, vals_b, grads_b,
        )
    return _unbucket_impl(
        inv_row, inv_slot, vals_b, grads_b, n_pad=n_pad, d=d, with_grads=with_grads
    )


@_partial(jax.jit, static_argnames=("kparams", "d", "p", "n_pad", "p2p_meta", "m2p_meta", "prec", "ecs"))
def _matvec_fused(
    dev, weights, targets, tgt_idx, tgt_mask, tcells, p2p_groups, m2p_groups,
    inv_row, inv_slot, *, kparams, d, p, n_pad, p2p_meta, m2p_meta, prec,
    ecs=1024
):
    """Upward + downward + leaf pass as ONE program (one dispatch per
    solver matvec).

    The weight TILES (bucketed per-leaf layout) are gathered ONCE from the
    user's weight array through the composed sorted->original index and
    shared by P2M and P2L.
    """
    w_tiles = _weight_tiles(dev, weights, _ctype(prec))
    with jax.named_scope("upward"):
        mult, w_sorted = _upward(dev, weights, w_tiles, prec=prec)
    with jax.named_scope("downward"):
        local = _downward(dev, mult, w_sorted, w_tiles, kparams=kparams, prec=prec)
    vals, _ = _leaf_all(
        dev, targets, tgt_idx, tgt_mask, tcells, local, mult, w_sorted,
        p2p_groups, m2p_groups, inv_row, inv_slot,
        kparams=kparams,
        d=d, p=p, n_pad=n_pad, p2p_meta=p2p_meta, m2p_meta=m2p_meta,
        with_grads=False, prec=prec, ecs=ecs,
    )
    return vals, mult, local, w_sorted


def _p2p_bucketed_xla(kernel, tpts, src_tiles, w_tiles, nbr_blk, ct, ecs):
    """Near field over the bucketed tile layout in plain XLA.

    The row-sharded leaf pass's formulation: for each target row gather
    its U neighbour tiles from the (L+1, ...) bucketed tables and contract
    in one einsum. ``tpts`` (Rb, T, d); ``src_tiles`` (L+1, d, S) f64
    coordinates, cast to ``ct`` here; ``w_tiles`` (L+1, nrhs, S)
    zero-weight padded (incl. the sentinel row); ``nbr_blk`` (U, Rb).
    Returns (Rb, T, nrhs) in ``ct``. Per-row reduction order is
    row-independent, so any row partitioning of the same inputs is bitwise
    identical.
    """
    u, rb = nbr_blk.shape
    t = tpts.shape[1]
    d = tpts.shape[2]
    s = src_tiles.shape[2]
    nbr_rows = nbr_blk.T  # (Rb, U)

    # bound the (c, T, U*S) phi transient like the scan paths do
    budget = (1 << 22) * max(int(ecs), 1) // 1024
    chunk = max(1, budget // max(t * u * s, 1))
    chunk = 1 << (int(chunk).bit_length() - 1)
    chunk = min(chunk, rb)

    coords = src_tiles.astype(ct)
    weights = w_tiles.astype(ct)

    def body(_, sl):
        tp, nbr_c = sl  # (c, T, d), (c, U)
        c = tp.shape[0]
        sp = coords[nbr_c]  # (c, U, d, S)
        wv = weights[nbr_c]  # (c, U, nrhs, S)
        spc = sp.transpose(0, 2, 1, 3).reshape(c, d, u * s)
        wvc = wv.transpose(0, 2, 1, 3).reshape(c, wv.shape[2], u * s)
        r2 = None
        for i in range(d):
            dd = tp[:, :, i, None].astype(ct) - spc[:, i, None, :]
            r2 = dd * dd if r2 is None else r2 + dd * dd
        k = kernel.phi_r2(r2)  # (c, T, U*S)
        vals = jnp.einsum("cts,crs->ctr", k, wvc)
        return None, vals

    if chunk == rb:
        _, vals = body(None, (tpts, nbr_rows))
        return vals
    nc = rb // chunk
    resh = lambda a: a.reshape((nc, chunk) + a.shape[1:])
    _, vals = jax.lax.scan(body, None, (resh(tpts), resh(nbr_rows)))
    return vals.reshape((rb,) + vals.shape[2:])


@_partial(jax.jit, static_argnames=("kparams", "d", "n_pad", "p2p_meta", "prec"))
def _near_field_scan_only(dev, weights, targets, tgt_idx, p2p_groups,
                          inv_row, inv_slot, *, kparams, d, n_pad, p2p_meta,
                          prec):
    """The P2P leg of :func:`_leaf_all` alone (row-chunk scan form)."""
    ct = _ctype(prec)
    w_sorted = weights[dev["point_order"]]
    vals_b = jnp.zeros(tgt_idx.shape + (weights.shape[1],), ct)
    vals_b, _ = _near_field_rows(
        make_kernel(kparams, dtype=ct), False, ct, targets[tgt_idx],
        dev["pts_sorted"], w_sorted, p2p_groups, p2p_meta, vals_b, None,
    )
    return _unbucket_impl(inv_row, inv_slot, vals_b, None, n_pad=n_pad, d=d,
                          with_grads=False)[0]


@_partial(jax.jit, static_argnames=("kparams", "d", "n_pad", "prec", "ecs"))
def _near_field_tiles_only(dev, tiles, weights, targets, tgt_idx, nbr_tab,
                           inv_row, inv_slot, *, kparams, d, n_pad, prec,
                           ecs=1024):
    """The P2P leg of :func:`_matvec_fused_sharded` alone (tile form),
    unsharded."""
    ct = _ctype(prec)
    w_tiles = _weight_tiles(dev, weights, ct).transpose(0, 2, 1)
    vals_b = _p2p_bucketed_xla(
        make_kernel(kparams, dtype=ct), targets[tgt_idx], tiles["src_tiles"],
        w_tiles, nbr_tab, ct, ecs,
    )
    return _unbucket_impl(inv_row, inv_slot, vals_b, None, n_pad=n_pad, d=d,
                          with_grads=False)[0]


@_partial(jax.jit, static_argnames=("mesh", "kparams", "d", "p", "n_pad", "prec", "ecs"))
def _matvec_fused_sharded(
    mesh, dev, tiles, weights, targets, tgt_idx, tgt_mask, tcells, nbr_tab,
    wtab, inv_row, inv_slot, *, kparams, d, p, n_pad, prec, ecs=1024,
):
    """Upward + downward + ROW-SHARDED leaf pass as one program.

    SURVEY §5.8(b): the per-iteration dominant cost — the near field (P2P +
    M2P) and L2P over the target bucket rows — is partitioned over the
    mesh's "sp" axis with ``jax.shard_map``; each device owns R/n_sp rows
    of the bucketed layout (targets, neighbour-table columns, outputs) and
    reads the replicated leaf/node tile tables (``tiles``, from
    :meth:`FmmTree._tile_state`). No collective is needed inside the leaf
    pass (row outputs are disjoint); the only cross-device traffic is
    GSPMD's gather for the final un-bucketing. P2M is leaf-chunk-sharded
    with one psum (:func:`_sharded_upward`) and M2L is target-slot-sharded
    when the slots divide the mesh (:func:`_sharded_m2l`); only M2M, P2L
    and L2L run replicated (cf. the rayon leaf loops at
    ``bbfmm.rs:1123-1357``).

    The leaf math uses the bucketed-tile formulation
    (:func:`_p2p_bucketed_xla`) for both near-field legs: P2P over the
    u-list leaf tiles (``nbr_tab``) and M2P over the w-list cells'
    Chebyshev-node tiles (``wtab``) with the cells' multipoles as weights.
    ``wtab`` is ``None`` only when no target row has a w-list cell. Per-row
    reduction order is row-independent, so an n-device run is bitwise equal
    to the same program on one device.
    """
    from jax.sharding import PartitionSpec as P

    ct = _ctype(prec)
    kernel = make_kernel(kparams, dtype=ct)
    # one consolidated weight-tile gather (see _matvec_fused)
    w_tiles_pre = _weight_tiles(dev, weights, ct)
    mult, w_sorted = _sharded_upward(mesh, dev, weights, w_tiles_pre, prec=prec)

    # M2L sharded over target slots when every level's padded slot count
    # divides the mesh; P2L/L2L stay replicated (cheap tail)
    nsp = int(mesh.shape["sp"])
    levels = dev["m2l_levels"]
    can_shard_m2l = bool(levels) and all(
        (src_r.shape[0] * src_r.shape[2]) % nsp == 0
        for (_u, _v, src_r, _s, _c) in levels
    )
    if can_shard_m2l:
        mult_c = mult.astype(ct)
        mult_pad = jnp.concatenate(
            [mult_c, jnp.zeros((1,) + mult_c.shape[1:], ct)], axis=0
        )
        local = _sharded_m2l(mesh, dev, mult_pad, ct=ct)
        local = _downward_tail(
            dev, local, w_sorted, w_tiles_pre, kparams=kparams, prec=prec
        )
    else:
        local = _downward(
            dev, mult, w_sorted, w_tiles_pre, kparams=kparams, prec=prec
        )

    # near-field weight tiles in kernel layout
    w_tiles = w_tiles_pre.transpose(0, 2, 1)  # (L+1, nrhs, S)

    # multipole tiles for the M2P leg (sentinel row = zero weights)
    mtiles = None
    if wtab is not None:
        mgather = mult[tiles["wtile_cells"]].transpose(0, 2, 1).astype(ct)
        mtiles = jnp.concatenate(
            [mgather, jnp.zeros((1,) + mgather.shape[1:], ct)], axis=0
        )  # (nw+1, nrhs, p^d)

    def leaf_block(tgt_idx_b, tgt_mask_b, tcells_b, nbr_b, wtab_b=None):
        _, vals_b, _ = _l2p_impl(
            dev, targets, tgt_idx_b, tgt_mask_b, tcells_b, local,
            d=d, p=p, with_grads=False, prec=prec, ecs=ecs,
        )
        tpts_b = targets[tgt_idx_b]
        near = _p2p_bucketed_xla(
            kernel, tpts_b, tiles["src_tiles"], w_tiles, nbr_b, ct, ecs
        )
        vals_b = vals_b + near.astype(vals_b.dtype)
        if wtab_b is not None:
            far = _p2p_bucketed_xla(
                kernel, tpts_b, tiles["node_tiles"], mtiles, wtab_b, ct, ecs
            )
            vals_b = vals_b + far.astype(vals_b.dtype)
        return vals_b

    row_spec = P("sp")
    col_spec = P(None, "sp")  # (U, R) tables shard their ROW axis = columns
    in_specs = (row_spec, row_spec, row_spec, col_spec)
    args = (tgt_idx, tgt_mask, tcells, nbr_tab)
    if wtab is not None:
        in_specs += (col_spec,)
        args += (wtab,)
    vals_b = jax.shard_map(
        leaf_block, mesh=mesh, in_specs=in_specs, out_specs=row_spec,
        check_vma=False,
    )(*args)

    vals, _ = _unbucket_impl(
        inv_row, inv_slot, vals_b, None, n_pad=n_pad, d=d, with_grads=False,
    )
    return vals, mult, local, w_sorted


def _sharded_m2l(mesh, dev, mult_pad, *, ct):
    """M2L with each level's target-slot axis partitioned over "sp".

    SURVEY §5.8(b), second half: each device gathers/contracts its own
    1/n_sp of the target slots per level (slots are disjoint across
    devices and across levels), scatters into a device-local ``local``
    block, and one psum over "sp" reassembles the full local-expansion
    table for the (cheap, replicated) P2L/L2L tail. Per-slot math is
    identical to the replicated level loop, so results match it to the
    dot-tiling level and an n-device run matches a 1-device run of the
    same program bitwise.
    """
    from jax.sharding import PartitionSpec as P

    levels = dev["m2l_levels"]
    n_lv = len(levels)
    args = []
    in_specs = []
    has_vt = []
    for u_stack, vt_stack, src_r, src_cells, level_cells in levels:
        nchunk, g, c_chunk = src_r.shape
        # slot-major (c_pad, g) source table; slots shard over "sp"
        src_flat = src_r.transpose(0, 2, 1).reshape(nchunk * c_chunk, g)
        has_vt.append(vt_stack is not None)
        args.extend([
            u_stack,
            vt_stack if vt_stack is not None else jnp.zeros((1,), jnp.float64),
            src_flat,
            src_cells,
            level_cells,
        ])
        in_specs.extend([P(), P(), P("sp"), P(), P("sp")])

    def block_fn(*flat):
        local_part = jnp.zeros(mult_pad.shape, ct)
        for i in range(n_lv):
            u_stack, vt_pack, src_slots, src_cells, cells_b = (
                flat[5 * i : 5 * i + 5])
            u_c = u_stack.astype(ct)
            vt_c = vt_pack.astype(ct) if has_vt[i] else None
            mult_src = mult_pad[src_cells]  # replicated compact level block
            y = _m2l_slots(u_c, vt_c, mult_src[src_slots.T])
            local_part = local_part.at[cells_b].add(
                y.astype(ct), mode="drop", unique_indices=True
            )
        return jax.lax.psum(local_part, "sp")

    return jax.shard_map(
        block_fn, mesh=mesh, in_specs=tuple(in_specs), out_specs=P(),
        check_vma=False,
    )(*args)


def _unbucket_impl(inv_row, inv_slot, vals_b, grads_b, *, n_pad, d, with_grads):
    # Each target index lives in exactly one (row, slot) of the bucket
    # layout, so un-bucketing is a GATHER through the plan-time inverse
    # tables (a scatter-add formulation would need the non-unique-indices
    # path, because of its shared pad sentinel). One flattened index
    # gathers the values; the result is upcast so callers always see f64.
    # Pad targets (n..n_pad) read garbage slots; the host slices them off.
    t = vals_b.shape[1]
    flat = inv_row.astype(jnp.int32) * jnp.int32(t) + inv_slot.astype(jnp.int32)
    vals = vals_b.reshape(-1, vals_b.shape[-1])[flat].astype(jnp.float64)
    if with_grads:
        grads = grads_b.reshape((-1,) + grads_b.shape[2:])[flat]
        return vals, grads.reshape(n_pad, -1)
    return vals, jnp.zeros((0,), jnp.float64)


class FmmTree:
    """Black-box FMM over a fixed set of source points."""

    def __init__(
        self,
        source_points,
        interpolation_order: int,
        kernel_params: KernelParams,
        adaptive_tree: bool = True,
        sparse: bool = False,
        extents=None,
        params: FmmParams | None = None,
    ):
        pts = np.asarray(source_points, np.float64)
        if pts.ndim != 2 or pts.shape[1] not in (1, 2, 3):
            raise ValueError(f"Unsupported source point shape {pts.shape}")
        self._points = pts
        self.p = int(interpolation_order)
        self.d = pts.shape[1]
        self.nnodes = self.p**self.d
        self.kernel_params = kernel_params
        self.kernel: Kernel = make_kernel(kernel_params)  # device closures
        self.kernel_np: Kernel = make_kernel(kernel_params, xp=np)
        self.params = params if params is not None else FmmParams(
            interpolation_order=self.p, epsilon=10.0 ** (-self.p)
        )

        if extents is None:
            extents = np.concatenate([pts.min(axis=0), pts.max(axis=0)])
        center, radius = calculate_tree_center_and_radius(np.asarray(extents, np.float64))
        self._world_center = np.asarray(center, np.float64)

        from ...utils.telemetry import traced_stage

        with traced_stage("fmm_octree_build"):
            self.tree: Octree = tree_mod.build_tree(
                pts,
                center,
                radius,
                self.params.max_points_per_cell,
                store_empty_leaves=not sparse,
                dimensions=self.d,
                adaptive=adaptive_tree,
            )
        with traced_stage("fmm_operators"):
            self._build_operators()
        with traced_stage("fmm_plan"):
            self._build_plan()
        with traced_stage("fmm_device_state"):
            self._build_device_state()

        self.nrhs = 1
        self._multipole = None
        self._local = None
        self._weights_sorted = None
        self._target_cache = {}
        self._hwm = {}
        self._tiles = None
        # capture the active mesh (parallel.use_mesh): when its "sp" axis
        # has >1 device the fused matvec runs the ROW-SHARDED leaf pass
        # (SURVEY §5.8(b)) so per-device near-field work shrinks
        from ...parallel import active_mesh, shard_axis_size

        mesh = active_mesh()
        self._mesh = (
            mesh if mesh is not None and shard_axis_size(mesh, "sp") > 1 else None
        )
        # fixed target-bucket width (leaves with more targets span rows)
        self._tmax = min(128, _next_pow2(max(self.smax, 8)))

    # ------------------------------------------------------------ operators
    def _build_operators(self):
        t = self.tree
        nodes = cheb.chebyshev_nodes(self.p)
        self.nodes_t, _ = cheb.chebyshev_polynomials(nodes, self.p)
        self.nodes_nd = cheb.nodes_tensor_product(nodes, self.d)
        self.m2m_ops = cheb.m2m_transfer_matrices(self.p, self.d)
        self.perm_tables = m2l.build_permutation_tables(self.p, self.d)
        compression = {
            FmmCompressionType.None_: "None",
            FmmCompressionType.SVD: "SVD",
            FmmCompressionType.ACA: "ACA",
        }[self.params.compression_type]
        self.level_ops = m2l.build_level_operators(
            self.kernel_np, self.p, self.d, t.radius, t.depth, compression,
            self.params.epsilon,
        )

    # ------------------------------------------------------------ plan
    def _build_plan(self):
        t = self.tree
        d = self.d

        # --- source leaf buckets (P2M / P2P / P2L sources) ---------------
        counts = np.diff(t.leaf_offsets)
        smax = int(counts.max()) if counts.size else 1
        nsl = t.leaf_cells.size
        # one extra padding row (index nsl) with empty mask for chunk padding
        src_idx = np.zeros((nsl + 1, smax), np.int64)
        src_mask = np.zeros((nsl + 1, smax), bool)
        if nsl:
            sm = np.arange(smax)[None, :] < counts[:, None]
            src_idx[:nsl][sm] = (t.leaf_offsets[:-1, None] + np.arange(smax)[None, :])[sm]
            src_mask[:nsl] = sm
        self.smax = smax
        self.nsl = nsl
        self._src_counts = np.concatenate([counts, [0]]).astype(np.int64)
        self.src_leaf_cells = t.leaf_cells
        self.src_bucket_idx = src_idx  # into the SORTED point arrays
        self.src_bucket_mask = src_mask
        self.points_sorted = self._points[t.point_order]
        self.cell_to_src_row = np.full(t.num_cells, -1, np.int64)
        self.cell_to_src_row[t.leaf_cells] = np.arange(nsl)

        # --- M2M (has_points only) / L2L (all cells) level groups --------
        # One table PER LEVEL, so all octants' transfers run as ONE batched
        # einsum + ONE scatter instead of 2^d small op pairs.
        # M2M is parent-major: (P,) parents and their (P, 2^d) children
        # by octant, absent children = num_cells (the zero sentinel row),
        # so every parent is written once (see _m2m_apply).
        def m2m_group(cells):
            parents, slot = np.unique(t.parent[cells], return_inverse=True)
            children = np.full((parents.size, 1 << d), t.num_cells, np.int64)
            children[slot, t.child_octant[cells]] = cells
            return parents, children

        # L2L is child-major: a padded (2^d, cmax) child/parent table; each
        # child is written once. Pad slots gather row 0 (harmless) and
        # scatter to the drop index num_cells.
        def octant_groups(cells, scatter_child: bool):
            octants = t.child_octant[cells]
            no = 1 << d
            cnt = np.bincount(octants, minlength=no)
            cmax = max(int(cnt.max()), 1)
            ch_t = np.full((no, cmax), t.num_cells if scatter_child else 0,
                           np.int64)
            pa_t = np.full((no, cmax), 0 if scatter_child else t.num_cells,
                           np.int64)
            for o in range(no):
                sel = cells[octants == o]
                ch_t[o, : sel.size] = sel
                pa_t[o, : sel.size] = t.parent[sel]
            return ch_t, pa_t

        self.m2m_groups = []  # deep -> shallow; (parents, children)
        self.l2l_groups = []  # SHALLOW -> deep; gathers pa, scatters ch
        for level in range(t.depth, 0, -1):
            cells = t.cells_at_level(level)
            if cells.size == 0:
                continue
            up_cells = cells[t.has_points[cells]]
            if up_cells.size:
                self.m2m_groups.append(m2m_group(up_cells))
        for level in range(1, t.depth + 1):
            cells = t.cells_at_level(level)
            if cells.size:
                self.l2l_groups.append(octant_groups(cells, scatter_child=True))

        # --- M2L: stacked groups per (level, m2l vector id) ----------------
        # Applying the Messner symmetry permutations at run time (grouping
        # by *reference* class, then take_along_axis) costs a permutation
        # gather per group per matvec. Instead the permutations are folded
        # into the operators ON THE HOST: each distinct m2l vector id gets
        # its own (U_v, Vt_v) obtained by permuting the reference
        # compression's rows/columns once at setup, so the downward pass is
        # pure batched matmul + gather/scatter with no runtime permutation.
        # Symmetry still saves setup work (16 ACA compressions instead of
        # 316 in 3D), exactly like the reference's scheme — only the
        # application site moves from run time to plan time.
        pt = self.perm_tables
        vp = t.v_pairs
        if vp.shape[0]:
            vp = vp[t.has_points[vp[:, 1]]]
        lv = t.levels[vp[:, 0]] if vp.shape[0] else np.zeros(0, np.int64)
        self.m2l_levels = []  # (level, U_stack, Vt_stack|None, tgt, src)
        nnodes = self.nnodes
        for level in range(2, t.depth + 1):
            sel = vp[lv == level] if vp.shape[0] else vp
            if sel.shape[0] == 0:
                continue
            vids = sel[:, 2]
            present = np.unique(vids)
            g = len(present)
            # target-slot layout: one column per target cell at this level,
            # one row per vector id; each (vid, tgt) has at most ONE source
            # (a vid names a relative offset), sentinel = num_cells (the
            # zero-multipole pad row) elsewhere. See _chunk_m2l_level.
            level_cells = np.unique(sel[:, 0])
            c_pad = _next_pow2(level_cells.size)
            slot_of = np.full(t.num_cells + 1, -1, np.int64)
            slot_of[level_cells] = np.arange(level_cells.size)
            # pad slots use DISTINCT out-of-range indices (dropped by the
            # scatter) so the level add keeps unique_indices=True honest
            cells_pad = t.num_cells + 1 + np.arange(c_pad)
            cells_pad[: level_cells.size] = level_cells
            # source cells indexed LOCALLY: each level gathers its compact
            # (S + 1, p^d, r) multipole block once (`mult_src`), and the
            # slot table points into it (sentinel = S, the zero pad row) —
            # slot chunks re-gather from that compact block, not from the
            # whole-tree multipole table.
            src_list = np.unique(sel[:, 1])
            n_src = src_list.size
            src_cells = np.concatenate(
                [src_list, [t.num_cells]]).astype(np.int32)
            local_of = np.full(t.num_cells + 1, n_src, np.int64)
            local_of[src_list] = np.arange(n_src)
            src_tab = np.full((g, c_pad), n_src, np.int32)
            vid_row = np.full(int(present.max()) + 1, -1, np.int64)
            vid_row[present] = np.arange(g)
            src_tab[vid_row[vids], slot_of[sel[:, 0]]] = local_of[sel[:, 1]]
            dense = self.level_ops[level][0][1] is None
            rmax = (
                nnodes
                if dense
                else max(self.level_ops[level][r][0].shape[1] for r in range(pt.num_reference))
            )
            u_stack = np.zeros((g, nnodes, rmax))
            vt_stack = None if dense else np.zeros((g, rmax, nnodes))
            for gi, v in enumerate(present):
                u, vt = self.level_ops[level][pt.ref_lookup[v]]
                pid = pt.perm_lookup[v]
                rows = pt.perm_indices[pid]
                inv = pt.inverse_perm[pid]
                if dense:
                    # runtime was y = (K @ x[rows])[inv]; fold both gathers
                    k2 = np.zeros_like(u)
                    k2[:, rows] = u
                    u_stack[gi] = k2[inv]
                else:
                    # y = (U @ (Vt @ x[rows]))[inv]  ->  U_v = U[inv],
                    # Vt_v[:, rows] = Vt
                    u_stack[gi, :, : u.shape[1]] = u[inv]
                    vt2 = np.zeros((vt.shape[0], nnodes))
                    vt2[:, rows] = vt
                    vt_stack[gi, : vt.shape[0]] = vt2
            self.m2l_levels.append(
                (level, u_stack, vt_stack, src_tab, cells_pad, src_cells))

        # --- P2L groups (x list) ------------------------------------------
        xp = t.x_pairs
        if xp.shape[0]:
            rows = self.cell_to_src_row[xp[:, 1]]
            keep = rows >= 0
            self.p2l_tgt = xp[keep, 0]
            self.p2l_src_row = rows[keep]
        else:
            self.p2l_tgt = np.zeros(0, np.int64)
            self.p2l_src_row = np.zeros(0, np.int64)

        # --- u/w pair lookup sorted by target cell ------------------------
        self._u_sorted = t.u_pairs[np.argsort(t.u_pairs[:, 0], kind="stable")]
        self._w_sorted = t.w_pairs[np.argsort(t.w_pairs[:, 0], kind="stable")]

        all_cells = np.arange(t.num_cells)
        self.cell_centers = t.cell_centers(all_cells)
        self.cell_lengths = t.cell_lengths(all_cells)

    # ------------------------------------------------------- device state
    def _build_device_state(self):
        d = self.d

        # All device-side geometry is stored RELATIVE to the tree centre.
        # The kernels are translation-invariant, so f64 results are
        # unchanged, but the f32 inner-matvec path becomes safe for
        # real-world coordinates (UTM eastings/northings ~1e6-1e7 with
        # metre-scale extents would lose ~3 decimal digits in a raw f32
        # cast — measured as a 1.8e-3 solver stagnation floor on the
        # albatite dataset).
        center = self._world_center
        src_bucket_idx = jnp.asarray(self.src_bucket_idx.astype(np.int32))
        src_bucket_mask = jnp.asarray(self.src_bucket_mask)
        pts_sorted = jnp.asarray(self.points_sorted - center)
        cell_centers_c = self.cell_centers - center
        src_centers = cell_centers_c[self.src_leaf_cells]
        src_lengths = self.cell_lengths[self.src_leaf_cells]

        # P2M scan plan: (nchunk, chunk) leaf tables; weights are computed
        # on the fly inside _upward (see there for why). Chunk sized so the
        # per-chunk (chunk, smax, p^d) transient stays at 1<<23 elements.
        nsl = self.nsl
        chunk = max(8, (1 << 23) // max(self.smax * self.nnodes, 1))
        chunk = 1 << (int(chunk).bit_length() - 1)
        nsl_pad = ((nsl + chunk - 1) // chunk) * chunk
        chunk = min(chunk, nsl_pad)
        idx_t = np.zeros((nsl_pad, self.smax), np.int32)
        msk_t = np.zeros((nsl_pad, self.smax), bool)
        ctr_t = np.ones((nsl_pad, d))
        len_t = np.ones(nsl_pad)
        cells_t = np.full(nsl_pad, self.tree.num_cells, np.int32)
        idx_t[:nsl] = self.src_bucket_idx[:nsl]
        msk_t[:nsl] = self.src_bucket_mask[:nsl]
        ctr_t[:nsl] = src_centers
        len_t[:nsl] = src_lengths
        cells_t[:nsl] = self.src_leaf_cells
        resh = lambda a: jnp.asarray(a.reshape((nsl_pad // chunk, chunk) + a.shape[1:]))
        p2m_scan = (resh(idx_t), resh(msk_t), resh(ctr_t), resh(len_t), resh(cells_t))

        p2l = None
        if self.p2l_tgt.size:
            # Target-major x-list table for the scanned P2L (see
            # _downward_tail): each target cell once, its source leaf rows
            # padded to kmax with the zero-weight sentinel row nsl, in
            # (nchunk, chunk) target chunks sized so the (chunk, kmax, p^d,
            # smax) kernel block stays at 1<<27 elements.
            tgts, inv = np.unique(self.p2l_tgt, return_inverse=True)
            cnt = np.bincount(inv)
            kmax = int(cnt.max())
            order = np.argsort(inv, kind="stable")
            rank = np.arange(order.size) - np.repeat(np.cumsum(cnt) - cnt, cnt)
            m = tgts.size
            pc = max(1, (1 << 27) // max(self.nnodes * self.smax * kmax, 1))
            pc = 1 << (int(pc).bit_length() - 1)
            m_pad = ((m + pc - 1) // pc) * pc
            pc = min(pc, m_pad)
            # pad targets: DISTINCT out-of-range indices (dropped) so the
            # chunk add keeps unique_indices=True honest
            tgt_t = (self.tree.num_cells + 1 + np.arange(m_pad)).astype(np.int32)
            srcr_t = np.full((m_pad, kmax), nsl, np.int32)
            ctr_t2 = np.ones((m_pad, d))
            len_t2 = np.ones(m_pad)
            tgt_t[:m] = tgts
            srcr_t[inv[order], rank] = self.p2l_src_row[order]
            ctr_t2[:m] = cell_centers_c[tgts]
            len_t2[:m] = self.cell_lengths[tgts]
            resh2 = lambda a: jnp.asarray(a.reshape((m_pad // pc, pc) + a.shape[1:]))
            p2l = (resh2(tgt_t), resh2(srcr_t), resh2(ctr_t2), resh2(len_t2))

        # Per-leaf tile layout (nsl+1, smax): the leaf's sorted-point
        # indices, a validity mask, and the composed sorted->original index
        # that lets the fused matvec gather the weight TILES directly from
        # the user's weight array in ONE gather (see _weight_tiles). Row nsl
        # is the zero-weight sentinel tile. No padding beyond smax: the XLA
        # forms that read the tiles need no alignment.
        tile_idx = self.src_bucket_idx.astype(np.int32)  # int32: n < 2^31
        tile_orig_idx = self.tree.point_order.astype(np.int32)[tile_idx]

        self._dev = {
            "point_order": jnp.asarray(self.tree.point_order),
            "pts_sorted": pts_sorted,
            "src_bucket_idx": src_bucket_idx,
            "src_bucket_mask": src_bucket_mask,
            "src_tile_orig_idx": jnp.asarray(tile_orig_idx),
            "src_leaf_cells": jnp.asarray(self.src_leaf_cells),
            "p2m_scan": p2m_scan,
            "m2m_ops": jnp.asarray(self.m2m_ops),
            "m2m_groups": [
                (jnp.asarray(parents), jnp.asarray(children))
                for parents, children in self.m2m_groups
            ],
            "l2l_groups": [
                (jnp.asarray(ch_t), jnp.asarray(pa_t))
                for ch_t, pa_t in self.l2l_groups
            ],
            "m2l_levels": [
                _chunk_m2l_level(u_stack, vt_stack, tgt, src, self.nnodes, sc)
                for (_level, u_stack, vt_stack, tgt, src, sc) in self.m2l_levels
            ],
            "p2l": p2l,
            "nodes_nd": jnp.asarray(self.nodes_nd),
            "cell_centers": jnp.asarray(cell_centers_c),
            "cell_lengths": jnp.asarray(self.cell_lengths),
            "nodes_t": jnp.asarray(self.nodes_t),
            # NOTE: the flat per-cell Chebyshev node table ((ncells * p^d,
            # d) f64 — 1.4 GB at 10M points) is NOT stored; M2P recomputes
            # gathered nodes from (centers, lengths, nodes_nd) inside
            # _near_field_class, bitwise-identically.
        }

        # w-list cells (with points): the M2P sources. Adaptive trees
        # evaluate their multipoles directly at the targets
        # (``bbfmm.rs:1254`` M2P).
        wc = self._w_sorted[:, 1]
        self._wtile_cells = (
            np.unique(wc[self.tree.has_points[wc]]) if wc.size else wc
        )
        self._cell_to_wtile = np.full(
            self.tree.num_cells, self._wtile_cells.size, np.int32)
        self._cell_to_wtile[self._wtile_cells] = np.arange(
            self._wtile_cells.size, dtype=np.int32)

    def _tile_state(self):
        """Static tiles for the tile-form near field, built on first use.

        ``src_tiles`` (nsl+1, d, smax) f64: each source leaf's tree-centred
        coordinates, slots beyond the leaf's count (and the sentinel tile
        nsl) at the tree centre — phi is finite there for every registry
        kernel and their zero weights kill the contribution.
        ``node_tiles`` (nw+1, d, p^d) f64: the Chebyshev nodes of each
        w-list cell (M2P treats a w-list cell as a source tile of its nodes,
        weighted by the cell's multipole coefficients); row nw is the
        sentinel. ``None`` when the tree has no w-list cell.
        """
        if self._tiles is not None:
            return self._tiles
        center = self._world_center
        nsl, d = self.nsl, self.d
        src_tiles = np.zeros((nsl + 1, d, self.smax))
        src_tiles[:nsl] = np.where(
            self.src_bucket_mask[:nsl, None, :],
            (self.points_sorted - center)[self.src_bucket_idx[:nsl]].transpose(0, 2, 1),
            0.0,
        )
        tiles = {"src_tiles": jnp.asarray(src_tiles), "node_tiles": None,
                 "wtile_cells": None}
        wc = self._wtile_cells
        if wc.size:
            node_xyz = np.asarray(
                cheb.scale_nodes_to_cell(
                    self.nodes_nd, self.cell_centers[wc] - center,
                    self.cell_lengths[wc],
                )
            )  # (nw, nnodes, d)
            node_tiles = np.zeros((wc.size + 1, d, self.nnodes))
            node_tiles[: wc.size] = node_xyz.transpose(0, 2, 1)
            tiles["node_tiles"] = jnp.asarray(node_tiles)
            tiles["wtile_cells"] = jnp.asarray(wc)
        self._tiles = tiles
        return tiles

    # ---------------------------------------------------------- weights
    @property
    def source_points(self) -> np.ndarray:
        return self._points

    def set_weights(self, weights) -> None:
        """Upward pass (P2M + M2M) over cells with sources."""
        w = jnp.asarray(np.asarray(weights, np.float64).reshape(self._points.shape[0], -1))
        self.nrhs = int(w.shape[1])
        self._multipole, self._weights_sorted = _upward(self._dev, w)
        self._local = None

    def set_local_coefficients(self, weights) -> None:
        """Full-tree downward pass; enables ``evaluate_leaves``."""
        if self._multipole is None:
            self.set_weights(weights)
        self._local = _downward(self._dev, self._multipole, self._weights_sorted, kparams=self.kernel_params)

    # --------------------------------------------------------- evaluation
    _HWM_FLOORS = {"ntl": 32, "nchunks": 2, "m2p": 128, "n": 1024, "m2p_u": 4,
                   "m2p_pairs": 64, "p2p_pairs": 64}

    def _hwm_pad(self, key: str, n: int) -> int:
        """Monotonic high-water-mark padding: shapes only ever grow (to the
        next power of two, from a per-key floor), so the number of distinct
        compiled programs per tree is O(log max) rather than one per batch
        size."""
        cur = self._hwm.get(key, self._HWM_FLOORS.get(key, 0))
        if n <= cur:
            self._hwm[key] = cur
            return cur
        new = _next_pow2(n)
        self._hwm[key] = new
        return new

    def _bin_targets(self, target_points, reuse_key=None):
        """Host-side target bucketing with high-water-mark shape padding.

        Builds, per target bucket row, the concatenated u-list source-point
        index table and the concatenated w-list Chebyshev-node index table,
        each grouped into power-of-two width classes for the scatter-free
        row-major near-field scans.
        """
        if reuse_key is not None and reuse_key in self._target_cache:
            return self._target_cache[reuse_key]

        targets = np.asarray(target_points, np.float64)
        n = targets.shape[0]
        leaf_of_target = self.tree.points_to_leaves(targets)
        tcells_u, tinv = np.unique(leaf_of_target, return_inverse=True)
        order = np.argsort(tinv, kind="stable")
        counts = np.bincount(tinv, minlength=tcells_u.size)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        nc = tcells_u.size

        def _concat_ranges(starts, lens):
            """Vectorised concat of [arange(s, s+l) for s, l in zip(...)]."""
            total = int(lens.sum())
            if total == 0:
                return np.zeros(0, np.int64)
            off = np.cumsum(lens) - lens
            return (
                np.arange(total, dtype=np.int64)
                - np.repeat(off, lens)
                + np.repeat(starts, lens)
            )

        # fixed bucket width: leaves holding more targets span several rows.
        # All row tables are built with vectorised repeat/cumsum idioms —
        # the per-leaf Python loops this replaces were O(10^4-10^5)
        # iterations per new target set at 1M-3M targets.
        tmax = self._tmax
        nrow_per_cell = -(-counts // tmax)
        ntl = int(nrow_per_cell.sum())
        # per row: its cell (as index into tcells_u), rank within the cell
        rcell = np.repeat(np.arange(nc), nrow_per_cell)
        rrank = _concat_ranges(np.zeros(nc, np.int64), nrow_per_cell)
        rstart = offsets[rcell] + rrank * tmax
        rlen = np.minimum(counts[rcell] - rrank * tmax, tmax)

        ntl_pad = self._hwm_pad("ntl", ntl)
        # int32 indices: the (ntl_pad, T) table is 67 MB in i64 at 3M points
        tgt_idx = np.zeros((ntl_pad, tmax), np.int32)
        tgt_mask = np.zeros((ntl_pad, tmax), bool)
        tcells_pad = np.zeros(ntl_pad, np.int64)
        slot = np.arange(tmax)
        rmask = slot[None, :] < rlen[:, None]  # (ntl, tmax)
        gpos = rstart[:, None] + slot[None, :]
        tgt_idx[:ntl][rmask] = order[gpos[rmask]]
        tgt_mask[:ntl] = rmask
        tcells_pad[:ntl] = tcells_u[rcell]

        # --- per-CELL concatenated source / node index lists --------------
        # One flat array + per-cell offsets each, in tcells_u order.
        t = self.tree
        loff = t.leaf_offsets
        nnodes = self.nnodes
        leaf_counts = np.diff(loff)

        # u list -> neighbour source-leaf rows per cell (flat)
        lo_u = np.searchsorted(self._u_sorted[:, 0], tcells_u)
        hi_u = np.searchsorted(self._u_sorted[:, 0], tcells_u, side="right")
        pair_pos = _concat_ranges(lo_u, hi_u - lo_u)
        pair_cell = np.repeat(np.arange(nc), hi_u - lo_u)
        srows_all = self.cell_to_src_row[self._u_sorted[pair_pos, 1]]
        keep = srows_all >= 0
        flat_srows = srows_all[keep]
        srow_cell = pair_cell[keep]
        nbr_cnt_c = np.bincount(srow_cell, minlength=nc)
        nbr_off_c = np.cumsum(nbr_cnt_c) - nbr_cnt_c

        # concat of each neighbour leaf's point range, grouped by cell
        src_lens = leaf_counts[flat_srows]

        # w list -> Chebyshev-node ids per cell (flat)
        lo_w = np.searchsorted(self._w_sorted[:, 0], tcells_u)
        hi_w = np.searchsorted(self._w_sorted[:, 0], tcells_u, side="right")
        wpos = _concat_ranges(lo_w, hi_w - lo_w)
        wcell = np.repeat(np.arange(nc), hi_w - lo_w)
        wcat_all = self._w_sorted[wpos, 1]
        wkeep = t.has_points[wcat_all]

        def build_groups(flat, width_c, off_c, kind):
            """Group rows by pow2 width class; build padded index tables."""
            widths = width_c[rcell]  # per row (rows of one cell share width)
            groups = []
            meta = []
            for w_class in sorted({int(_next_pow2(max(int(w), 1))) for w in np.unique(widths) if w > 0}):
                sel = np.nonzero(
                    (widths > 0)
                    & (np.maximum(widths, 1) <= w_class)
                    & (np.maximum(widths, 1) > w_class // 2)
                )[0]
                if sel.size == 0:
                    continue
                # The scan materialises a (chunk, T, w_class) kernel matrix,
                # so its row chunk is bounded by that: 1<<22 elements at the
                # reference default FmmParams.eval_chunk_size = 1024, scaled
                # linearly by it.
                ecs = max(int(self.params.eval_chunk_size), 1)
                chunk_scan = max(1, ((1 << 22) * ecs // 1024) // max(tmax * w_class, 1))
                chunk_scan = 1 << (int(chunk_scan).bit_length() - 1)
                g = self._hwm_pad(f"{kind}_rows_{w_class}", sel.size)
                chunk_scan = min(chunk_scan, g)  # pow2: divides g
                # pad slots use DISTINCT out-of-range indices (dropped) so
                # the class adds keep unique_indices=True honest
                rsel = (ntl_pad + np.arange(g)).astype(np.int32)
                rsel[: sel.size] = sel
                tab = np.zeros((g, w_class), np.int32)
                mask = np.zeros((g, w_class), bool)
                w_sel = widths[sel]
                cmask = np.arange(w_class)[None, :] < w_sel[:, None]
                pos = off_c[rcell[sel]][:, None] + np.arange(w_class)[None, :]
                tab[: sel.size][cmask] = flat[pos[cmask]]
                mask[: sel.size] = cmask
                groups.append((rsel, tab, mask))
                meta.append((w_class, chunk_scan))
            return tuple(groups), tuple(meta)

        # P2P/M2P scan tables are built (and uploaded) LAZILY on the first
        # scan-path call: the row-sharded matvec never reads them, they are
        # GB-scale at 1M+ points (rows x w_class int32 per width class), and
        # their construction is the dominant host binning cost.
        def _scan_builder(binned):
            flat_src = _concat_ranges(loff[flat_srows], src_lens)
            width_src_c = np.zeros(nc, np.int64)
            np.add.at(width_src_c, srow_cell, src_lens)
            srcoff_c = np.cumsum(width_src_c) - width_src_c
            flat_nodes = _concat_ranges(
                wcat_all[wkeep] * nnodes,
                np.full(int(wkeep.sum()), nnodes, np.int64),
            )
            width_node_c = np.bincount(wcell[wkeep], minlength=nc) * nnodes
            nodeoff_c = np.cumsum(width_node_c) - width_node_c
            p2p, binned["p2p_meta"] = build_groups(
                flat_src, width_src_c, srcoff_c, "p2p")
            m2p, binned["m2p_meta"] = build_groups(
                flat_nodes, width_node_c, nodeoff_c, "m2p")
            binned["p2p_groups"] = tuple(tuple(jnp.asarray(a) for a in grp) for grp in p2p)
            binned["m2p_groups"] = tuple(tuple(jnp.asarray(a) for a in grp) for grp in m2p)

        # Tile-form tables, also LAZY (only the tile-form near field reads
        # them): per row, its u-list leaf tiles (U, ntl_pad) and its w-list
        # cell tiles (U_w, ntl_pad), int32, transposed so a row shard is a
        # column block; sentinels nsl / nw are the zero-weight tiles.
        def _tile_builder(binned):
            u_max = max(int(nbr_cnt_c.max()) if nc else 0, 1)
            nbr_tab = np.full((ntl_pad, u_max), self.nsl, np.int32)
            nbr_cnt_row = nbr_cnt_c[rcell]
            nmask = np.arange(u_max)[None, :] < nbr_cnt_row[:, None]
            npos = nbr_off_c[rcell][:, None] + np.arange(u_max)[None, :]
            nbr_tab[:ntl][nmask] = flat_srows[npos[nmask]]
            binned["nbr_tab"] = jnp.asarray(np.ascontiguousarray(nbr_tab.T))

            # Every w-list cell with points has a node tile, so the table
            # is built whenever any row has one: the tile form never drops
            # the M2P leg. None only when no target row has a w-list cell.
            binned["wtab"] = None
            wcnt_c = np.bincount(wcell[wkeep], minlength=nc)
            if wcnt_c.size and wcnt_c.max() > 0:
                wcells_flat = wcat_all[wkeep]
                woff_c = np.cumsum(wcnt_c) - wcnt_c
                uw_max = self._hwm_pad("m2p_u", int(wcnt_c.max()))
                nw = self._wtile_cells.size
                wtab = np.full((ntl_pad, uw_max), nw, np.int32)
                wcnt_row = wcnt_c[rcell]
                wmask = np.arange(uw_max)[None, :] < wcnt_row[:, None]
                wpos2 = woff_c[rcell][:, None] + np.arange(uw_max)[None, :]
                wtab[:ntl][wmask] = self._cell_to_wtile[wcells_flat[wpos2[wmask]]]
                if np.any(wtab[:ntl][wmask] >= nw):
                    raise AssertionError("w-list cell without a node tile")
                binned["wtab"] = jnp.asarray(np.ascontiguousarray(wtab.T))

        n_pad = self._hwm_pad("n", n)
        targets_pad = np.zeros((n_pad, targets.shape[1]))
        targets_pad[:n] = targets - self._world_center  # tree-centred (see _build_device_state)

        # inverse of the (row, slot) bucketing: un-bucketing is a gather
        # (see _unbucket_impl); pad targets read (0, 0) and are sliced off
        inv_row = np.zeros(n_pad, np.int32)
        inv_slot = np.zeros(n_pad, np.int32)
        rr, ss = np.nonzero(tgt_mask)
        inv_row[tgt_idx[rr, ss]] = rr
        inv_slot[tgt_idx[rr, ss]] = ss

        binned = {
            "targets_pad": jnp.asarray(targets_pad),
            "tcells": jnp.asarray(tcells_pad),
            "tgt_idx": jnp.asarray(tgt_idx),
            "tgt_mask": jnp.asarray(tgt_mask),
            "inv_row": jnp.asarray(inv_row),
            "inv_slot": jnp.asarray(inv_slot),
            "_scan_builder": _scan_builder,
            "_tile_builder": _tile_builder,
            "n_pad": n_pad,
            "ntargets": n,
        }
        if reuse_key is not None:
            self._target_cache[reuse_key] = binned
        return binned

    def _leaf_pass(self, targets, binned, with_grads: bool):
        """Fused leaf pass; returns host arrays."""
        n = binned["ntargets"]
        vals, grads = self._leaf_pass_device(binned, with_grads, prec="f64")
        if with_grads:
            return np.asarray(vals)[:n], np.asarray(grads)[:n]
        return np.asarray(vals)[:n], None

    def _check_gradients(self):
        if not self.kernel.supports_gradients:
            raise KernelDoesNotSupportGradientsError()

    # ------------------------------------------------- device-resident path
    def prepare_targets(self, target_points, reuse_key) -> None:
        """Bind a named target set for the device-resident matvec path."""
        self._bin_targets(target_points, reuse_key)

    def _ensure_scan_tables(self, binned):
        """Build the row-scan index tables (P2P and M2P width classes) on
        first use; they hold ``p2p_groups``/``p2p_meta`` and
        ``m2p_groups``/``m2p_meta``."""
        if "p2p_groups" not in binned:
            binned["_scan_builder"](binned)
        return binned

    def _ensure_tile_tables(self, binned):
        """Build the tile-form tables (``nbr_tab``, ``wtab``) on first use."""
        if "nbr_tab" not in binned:
            binned["_tile_builder"](binned)
        return binned

    def _leaf_pass_device(self, binned, with_grads: bool, prec: str = "f64"):
        _check_precision(prec)
        self._ensure_scan_tables(binned)
        return _leaf_all(
            self._dev,
            binned["targets_pad"],
            binned["tgt_idx"],
            binned["tgt_mask"],
            binned["tcells"],
            self._local,
            self._multipole,
            self._weights_sorted,
            binned["p2p_groups"],
            binned["m2p_groups"],
            binned["inv_row"],
            binned["inv_slot"],
            kparams=self.kernel_params,
            d=self.d,
            p=self.p,
            n_pad=binned["n_pad"],
            p2p_meta=binned["p2p_meta"],
            m2p_meta=binned["m2p_meta"],
            with_grads=with_grads,
            prec=prec,
            ecs=int(self.params.eval_chunk_size),
        )

    def evaluate_device(self, weights_dev, reuse_key, precision: str = "f64"):
        """Full matvec at a prepared target set, device in -> device out.

        One fused dispatch (upward + downward + leaf): no host transfers —
        intended for the solver hot loop where weights, values and
        residuals all live in device memory. ``precision="f64"`` runs every
        pass in f64, the reference's arithmetic. ``precision="f32"`` runs
        the contractions in float32 (~1e-6 relative), the inner mode of the
        mixed-precision refined solver. Any other value raises
        ``ValueError``. Under a mesh whose "sp" axis has more than one
        device the leaf pass is row-sharded (:func:`_matvec_fused_sharded`).
        """
        _check_precision(precision)
        binned = self._target_cache[reuse_key]
        if self._mesh is not None:
            nsp = int(self._mesh.shape["sp"])
            if int(binned["tgt_idx"].shape[0]) % nsp == 0:
                self._ensure_tile_tables(binned)
                vals, mult, local, wsorted = _matvec_fused_sharded(
                    self._mesh,
                    self._dev,
                    self._tile_state(),
                    weights_dev,
                    binned["targets_pad"],
                    binned["tgt_idx"],
                    binned["tgt_mask"],
                    binned["tcells"],
                    binned["nbr_tab"],
                    binned["wtab"],
                    binned["inv_row"],
                    binned["inv_slot"],
                    kparams=self.kernel_params,
                    d=self.d,
                    p=self.p,
                    n_pad=binned["n_pad"],
                    prec=precision,
                    ecs=int(self.params.eval_chunk_size),
                )
                self._multipole, self._local, self._weights_sorted = (
                    mult, local, wsorted,
                )
                return vals[: binned["ntargets"]]

        self._ensure_scan_tables(binned)
        vals, mult, local, wsorted = _matvec_fused(
            self._dev,
            weights_dev,
            binned["targets_pad"],
            binned["tgt_idx"],
            binned["tgt_mask"],
            binned["tcells"],
            binned["p2p_groups"],
            binned["m2p_groups"],
            binned["inv_row"],
            binned["inv_slot"],
            kparams=self.kernel_params,
            d=self.d,
            p=self.p,
            n_pad=binned["n_pad"],
            p2p_meta=binned["p2p_meta"],
            m2p_meta=binned["m2p_meta"],
            prec=precision,
            ecs=int(self.params.eval_chunk_size),
        )
        self._multipole, self._local, self._weights_sorted = mult, local, wsorted
        return vals[: binned["ntargets"]]

    def near_field_device(self, weights_dev, reuse_key, precision: str = "f64",
                          form: str = "rows"):
        """The u-list near field (P2P) alone at a prepared target set.

        ``form="rows"`` is the row-chunk scan the single-device leaf pass
        runs; ``form="tiles"`` is the bucketed-tile form the row-sharded
        leaf pass runs (here unsharded). Device in -> device out, (n, nrhs)
        f64. Measurement and verification hook: the full matvec never needs
        it.
        """
        _check_precision(precision)
        binned = self._target_cache[reuse_key]
        if form == "rows":
            self._ensure_scan_tables(binned)
            vals = _near_field_scan_only(
                self._dev, weights_dev, binned["targets_pad"], binned["tgt_idx"],
                binned["p2p_groups"], binned["inv_row"], binned["inv_slot"],
                kparams=self.kernel_params, d=self.d, n_pad=binned["n_pad"],
                p2p_meta=binned["p2p_meta"], prec=precision,
            )
        elif form == "tiles":
            self._ensure_tile_tables(binned)
            vals = _near_field_tiles_only(
                self._dev, self._tile_state(), weights_dev,
                binned["targets_pad"], binned["tgt_idx"], binned["nbr_tab"],
                binned["inv_row"], binned["inv_slot"],
                kparams=self.kernel_params, d=self.d, n_pad=binned["n_pad"],
                prec=precision, ecs=int(self.params.eval_chunk_size),
            )
        else:
            raise ValueError(f"form must be 'rows' or 'tiles', got {form!r}")
        return vals[: binned["ntargets"]]

    def evaluate(self, weights, target_points, reuse_key=None) -> np.ndarray:
        """Downward + leaf pass at ``target_points`` (full mode)."""
        if self._multipole is None:
            self.set_weights(weights)
        binned = self._bin_targets(target_points, reuse_key)
        self._local = _downward(self._dev, self._multipole, self._weights_sorted, kparams=self.kernel_params)
        vals, _ = self._leaf_pass(target_points, binned, with_grads=False)
        return vals

    def evaluate_with_gradients(self, weights, target_points, reuse_key=None):
        self._check_gradients()
        if self._multipole is None:
            self.set_weights(weights)
        binned = self._bin_targets(target_points, reuse_key)
        self._local = _downward(self._dev, self._multipole, self._weights_sorted, kparams=self.kernel_params)
        return self._leaf_pass(target_points, binned, with_grads=True)

    def evaluate_leaves(self, weights, target_points, reuse_key=None) -> np.ndarray:
        """Leaf pass only (after ``set_local_coefficients``)."""
        if self._local is None:
            raise RuntimeError("call set_local_coefficients before evaluate_leaves")
        binned = self._bin_targets(target_points, reuse_key)
        vals, _ = self._leaf_pass(target_points, binned, with_grads=False)
        return vals

    def evaluate_leaves_with_gradients(self, weights, target_points, reuse_key=None):
        self._check_gradients()
        if self._local is None:
            raise RuntimeError("call set_local_coefficients before evaluate_leaves")
        binned = self._bin_targets(target_points, reuse_key)
        return self._leaf_pass(target_points, binned, with_grads=True)
