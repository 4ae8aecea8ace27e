"""M2L reference operators, symmetry permutations, and low-rank compression.

Implements the symmetry-optimised M2L scheme of Messner/Bramas/Coulaud/Darve
2012 as used by the reference (``chebyshev.rs:243-585``, ``aca.rs``): the up
to 7^d - 3^d far-field transfer vectors collapse onto 16 (3D) / 7 (2D)
reference operators via axial (sign-flip) and diagonal (axis-order)
permutations of the Chebyshev tensor grid; each reference operator is
compressed once per level (ACA + QR/SVD recompression, plain truncated SVD,
or dense).

On the device the whole machinery reduces to gathers: a per-interaction
permutation row (precomputed int table) reorders multipole node values, the
compressed (U, V^T) pair is applied as two batched matmuls over all
interactions sharing the reference operator, and the inverse permutation row
scatters into the target locals. That turns the reference's per-cell matmat
loop into a handful of big batched matmuls per (level, reference-vector) group.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from .cheb import chebyshev_nodes, nodes_tensor_product
from ..kernels import Kernel


def cartesian_rows(values, d: int) -> np.ndarray:
    """Row-major cartesian product; first column varies slowest."""
    grids = np.meshgrid(*([np.asarray(values)] * d), indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=1)


def reference_m2l_vectors(d: int) -> np.ndarray:
    """Reference transfer vectors: v0 >= 2, components non-increasing."""
    base = cartesian_rows(np.arange(4), d)
    keep = (base[:, 0] >= 2) & np.all(base[:, :-1] >= base[:, 1:], axis=1)
    return base[keep]


@dataclasses.dataclass
class PermutationTables:
    """Symmetry lookup tables shared by all levels.

    * ``perm_indices`` (ncombo, p^d): permuted[k] = orig[perm_indices[k]]
    * ``inverse_perm`` (ncombo, p^d): argsort of each row
    * ``perm_lookup`` (7^d,): combo id per m2l vector id
    * ``ref_lookup`` (7^d,): reference operator id per m2l vector id
      (-1 for near-field vectors |v|_inf < 2)
    """

    perm_indices: np.ndarray
    inverse_perm: np.ndarray
    perm_lookup: np.ndarray
    ref_lookup: np.ndarray
    num_reference: int


def build_permutation_tables(p: int, d: int) -> PermutationTables:
    mi = cartesian_rows(np.arange(1, p + 1), d)  # (p^d, d), dim0 slowest

    def k_index(alpha: np.ndarray) -> np.ndarray:
        out = np.zeros(alpha.shape[0], np.int64)
        for j in range(d):
            out = out * p + (alpha[:, j] - 1)
        return out

    axis_orders = list(itertools.permutations(range(d)))
    sign_perms = cartesian_rows(np.array([-1, 1]), d)

    def perm_from_alpha(alpha_p: np.ndarray) -> np.ndarray:
        perm = np.empty(p**d, np.int64)
        perm[k_index(alpha_p)] = np.arange(p**d)
        return perm

    diag_perms = [perm_from_alpha(mi[:, list(order)]) for order in axis_orders]
    axial_perms = [
        perm_from_alpha(np.where(sp[None, :] < 0, p - (mi - 1), mi)) for sp in sign_perms
    ]

    ncombo = len(sign_perms) * len(axis_orders)
    perm_indices = np.empty((ncombo, p**d), np.int64)
    for a in range(len(sign_perms)):
        for b in range(len(axis_orders)):
            # combined[k] = axial[diagonal[k]] (``chebyshev.rs:544-555``)
            perm_indices[a * len(axis_orders) + b] = axial_perms[a][diag_perms[b]]
    inverse_perm = np.argsort(perm_indices, axis=1)

    # per-vector lookups over all 7^d vectors (id = base-7, dim0 msd)
    vectors = cartesian_rows(np.arange(-3, 4), d)
    nvec = vectors.shape[0]
    perm_lookup = np.zeros(nvec, np.int64)
    ref_lookup = np.full(nvec, -1, np.int64)

    refs = reference_m2l_vectors(d)
    refs_sorted = np.sort(refs, axis=1)  # ascending per row

    sign_rows = {tuple(sp): i for i, sp in enumerate(sign_perms)}
    order_rows = {order: i for i, order in enumerate(axis_orders)}

    for vid in range(nvec):
        v = vectors[vid]
        flips = tuple(-1 if x < 0 else 1 for x in v)
        a = sign_rows[flips]
        # stable argsort of -|v| = descending |v| with ties by index
        order = tuple(np.argsort(-np.abs(v), kind="stable"))
        b = order_rows[order]
        perm_lookup[vid] = a * len(axis_orders) + b
        if np.max(np.abs(v)) >= 2:
            sv = np.sort(np.abs(v))
            match = np.nonzero(np.all(refs_sorted == sv[None, :], axis=1))[0]
            ref_lookup[vid] = match[0]

    return PermutationTables(
        perm_indices=perm_indices,
        inverse_perm=inverse_perm,
        perm_lookup=perm_lookup,
        ref_lookup=ref_lookup,
        num_reference=refs.shape[0],
    )


# -- operator generation -------------------------------------------------


def reference_operator_matrix(
    kernel: Kernel, ref_vector: np.ndarray, p: int, d: int, length: float
) -> np.ndarray:
    """Dense reference M2L operator K[i, j] = phi(|t*L + (n_i - n_j)*L/2|).

    Row i indexes the target-cell node (offset by the transfer vector t),
    column j the source-cell node — the orientation used at apply time
    (``chebyshev.rs:587-627``, ``bbfmm.rs:941-962``).
    """
    nodes = chebyshev_nodes(p)
    grid = nodes_tensor_product(nodes, d)
    row_pts = (ref_vector[None, :] + grid * 0.5) * length
    col_pts = grid * 0.5 * length
    return np.asarray(kernel.pair(row_pts, col_pts))


def aca_partial_pivoting(row_fn, col_fn, m: int, n: int, epsilon: float):
    """Partial-pivoted ACA: A ~= U V^T (``aca.rs:23-136`` semantics).

    ``row_fn(i) -> (n,)``, ``col_fn(j) -> (m,)`` generate kernel entries
    lazily. Stops when ||u_k||^2 ||v_k||^2 <= eps^2 * ||A_k||_F^2 estimate.
    """
    max_iter = min(m, n)
    tol = epsilon * epsilon
    u = np.zeros((m, max_iter))
    v = np.zeros((n, max_iter))
    unused_rows = np.ones(m, bool)
    unused_cols = np.ones(n, bool)
    residual_norm = 0.0
    i = 0
    k = 0
    for _ in range(max_iter):
        row = row_fn(i).copy()
        unused_rows[i] = False
        if k:
            row -= u[i, :k] @ v[:, :k].T
        masked = np.where(unused_cols, np.abs(row), 0.0)
        j = int(np.argmax(masked))
        if row[j] == 0.0:
            break
        row /= row[j]
        col = col_fn(j).copy()
        unused_cols[j] = False
        if k:
            col -= u[:, :k] @ v[j, :k]
        masked = np.where(unused_rows, np.abs(col), 0.0)
        i = int(np.argmax(masked))

        sum_k = 0.0
        if k:
            sum_k = float((u[:, :k].T @ col) @ (v[:, :k].T @ row))
        norm_uv2 = float(col @ col) * float(row @ row)
        residual_norm += norm_uv2 + 2.0 * sum_k
        u[:, k] = col
        v[:, k] = row
        k += 1
        if norm_uv2 <= tol * residual_norm:
            break
    return u[:, :k], v[:, :k]


def singular_values_cutoff(sigma: np.ndarray, epsilon: float) -> int:
    """Smallest rank with tail Frobenius energy < eps^2 * total energy."""
    s2 = sigma**2
    tail = np.cumsum(s2[::-1])[::-1]
    thresh = tail[0] * epsilon * epsilon
    below = np.nonzero(tail < thresh)[0]
    return int(below[0]) if below.size else sigma.size


def recompress(u_aca: np.ndarray, v_aca: np.ndarray, epsilon: float):
    """QR + SVD recompression of ACA factors -> (U, V^T)."""
    qu, ru = np.linalg.qr(u_aca)
    qv, rv = np.linalg.qr(v_aca)
    ur, s, vrt = np.linalg.svd(ru @ rv.T)
    rank = max(singular_values_cutoff(s, epsilon), 1)
    u = qu @ (ur[:, :rank] * s[:rank][None, :])
    vt = vrt[:rank] @ qv.T
    return u, vt


def compress_operator(kernel_np: Kernel, ref_vector, p, d, length, compression, epsilon):
    """One compressed reference operator (U, Vt); Vt is None for dense."""
    if compression == "None":
        return reference_operator_matrix(kernel_np, ref_vector, p, d, length), None

    if compression == "SVD":
        k = reference_operator_matrix(kernel_np, ref_vector, p, d, length)
        u_full, s, vt_full = np.linalg.svd(k)
        rank = max(singular_values_cutoff(s, epsilon), 1)
        return u_full[:, :rank], s[:rank][:, None] * vt_full[:rank]

    # ACA against the lazily generated operator
    nodes = chebyshev_nodes(p)
    grid = nodes_tensor_product(nodes, d)
    row_pts = (np.asarray(ref_vector)[None, :] + grid * 0.5) * length
    col_pts = grid * 0.5 * length

    def row_fn(i):
        return np.asarray(kernel_np.pair(row_pts[i : i + 1], col_pts))[0]

    def col_fn(j):
        return np.asarray(kernel_np.pair(row_pts, col_pts[j : j + 1]))[:, 0]

    u_aca, v_aca = aca_partial_pivoting(row_fn, col_fn, grid.shape[0], grid.shape[0], epsilon)
    return recompress(u_aca, v_aca, epsilon)


def build_level_operators(kernel_np, p, d, radius, depth, compression, epsilon):
    """Per level (2..depth), the compressed reference operators.

    Returns {level: [(U, Vt) per reference vector]} — host numpy; the plan
    builder pads/stacks them for the device.
    """
    refs = reference_m2l_vectors(d)
    out = {}
    for level in range(2, depth + 1):
        length = 2.0 * radius / (1 << level)
        ops = [
            compress_operator(kernel_np, refs[r], p, d, length, compression, epsilon)
            for r in range(refs.shape[0])
        ]
        out[level] = ops
    return out
