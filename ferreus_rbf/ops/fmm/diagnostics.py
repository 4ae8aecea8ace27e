"""FMM evaluator error budget and near-field reference.

``fmm_error_budget`` answers: when an interpolant's values differ from a
true-f64 dense oracle at scale, is the error (a) Chebyshev/ACA truncation
of the far field — which the Rust reference shares, its f64 arithmetic only
reproduces the TRUNCATED value (``ferreus_bbfmm/src/chebyshev.rs:723-786``,
``bbfmm.rs:864-986``) — or (b) the arithmetic precision of the passes?

The sweep holds the points + weights fixed and varies ONE axis at a time:

- ``interpolation_order`` p: truncation scales ~10^-p; anything that does
  not move with p is not truncation.
- precision at fixed p: ``"f64"`` vs ``"f32"``; the gap shows what the f64
  tier buys over the solver's inner matvec.

Every variant is compared to the same dense numpy-f64 oracle (exact kernel
sums, no FMM) on a sampled target subset.

``near_field_reference`` is the plain numpy f64 sum over a tree's u-list
pairs: what the FMM's near-field (P2P) leg must reproduce exactly.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..kernels import make_kernel
from .api import FmmTree
from ...config import FmmCompressionType, FmmParams


def dense_oracle(pts, weights, kparams, sample_idx, chunk_bytes=2e9):
    """Dense numpy-f64 kernel sum at ``pts[sample_idx]`` — the exact value."""
    pts = np.asarray(pts, np.float64)
    w = np.asarray(weights, np.float64)
    if w.ndim == 1:
        w = w[:, None]
    targets = pts[sample_idx]
    kernel = make_kernel(kparams, xp=np)
    n = pts.shape[0]
    chunk = max(1, int(chunk_bytes // (n * 8)))
    return np.concatenate([
        kernel.pair(targets[s : s + chunk], pts) @ w
        for s in range(0, targets.shape[0], chunk)
    ])


def fmm_error_budget(
    pts,
    weights,
    kparams,
    orders=(5, 7, 9),
    n_sample=256,
    seed=3,
    adaptive_tree=True,
    max_points_per_cell=256,
):
    """Max relative FMM-vs-dense error per (order, precision) variant.

    Returns ``{"n", "n_sample", "entries": [{"p", "prec", "err"}...],
    "tracks_p", "verdict"}`` where ``verdict`` names the dominant error
    source of the f64 tier: ``"cheb_truncation"`` if its error tracks p,
    ``"precision_floor"`` if it does not.
    """
    pts = np.asarray(pts, np.float64)
    w = np.asarray(weights, np.float64)
    if w.ndim == 1:
        w = w[:, None]
    n = pts.shape[0]
    rng = np.random.default_rng(seed)
    sample_idx = np.sort(rng.choice(n, size=min(n_sample, n), replace=False))
    oracle = dense_oracle(pts, w, kparams, sample_idx)
    scale = max(float(np.max(np.abs(oracle))), 1e-300)
    sample_pts = pts[sample_idx]
    w_dev = jnp.asarray(w)

    entries = []
    by_key = {}
    for p in orders:
        params = FmmParams(
            interpolation_order=int(p),
            max_points_per_cell=max_points_per_cell,
            compression_type=FmmCompressionType.ACA,
            epsilon=10.0 ** (-int(p)),
        )
        tree = FmmTree(pts, int(p), kparams, adaptive_tree=adaptive_tree,
                       sparse=True, params=params)
        tree.prepare_targets(sample_pts, "sample")
        for prec in ("f64", "f32"):
            vals = np.asarray(tree.evaluate_device(w_dev, "sample",
                                                   precision=prec))
            err = float(np.max(np.abs(vals - oracle)) / scale)
            entries.append({"p": int(p), "prec": prec,
                            "err": float(f"{err:.3e}")})
            by_key[(int(p), prec)] = err
        del tree

    ps = sorted({e["p"] for e in entries})
    f64 = [by_key[(p, "f64")] for p in ps]
    tracks_p = len(ps) >= 2 and f64[-1] < 0.1 * f64[0]
    return {
        "n": int(n),
        "n_sample": int(sample_idx.size),
        "entries": entries,
        "tracks_p": bool(tracks_p),
        "verdict": "cheb_truncation" if tracks_p else "precision_floor",
        "note": "err = max rel FMM-vs-dense-f64 at the sample, each at that "
                "plan's own epsilon=1e-p",
    }


def near_field_reference(tree, weights, targets):
    """Numpy f64 near field of ``tree`` at ``targets``: for each target,
    the kernel sum over the source points of every leaf in its leaf's
    u-list (the reference's direct P2P, ``bbfmm.rs:1254``). Returns
    (len(targets), nrhs)."""
    t = tree.tree
    w = np.asarray(weights, np.float64)
    if w.ndim == 1:
        w = w[:, None]
    targets = np.asarray(targets, np.float64)
    kernel = make_kernel(tree.kernel_params, xp=np)
    pts = np.asarray(tree.source_points, np.float64)
    leaf_row = np.full(t.num_cells, -1, np.int64)
    leaf_row[t.leaf_cells] = np.arange(t.leaf_cells.size)
    u_of = {}
    for tgt_cell, src_cell in t.u_pairs:
        u_of.setdefault(int(tgt_cell), []).append(int(src_cell))
    leaf_of_target = t.points_to_leaves(targets)
    out = np.zeros((targets.shape[0], w.shape[1]))
    for cell in np.unique(leaf_of_target):
        rows = np.nonzero(leaf_of_target == cell)[0]
        src = []
        for s in u_of.get(int(cell), []):
            r = leaf_row[s]
            if r >= 0:
                src.append(t.point_order[t.leaf_offsets[r]:t.leaf_offsets[r + 1]])
        if not src:
            continue
        src = np.concatenate(src)
        out[rows] = kernel.pair(targets[rows], pts[src]) @ w[src]
    return out
