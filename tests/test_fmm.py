"""BBFMM engine tests: FMM-vs-dense equivalence (the reference's core test
philosophy, SURVEY.md section 4), interaction-list correctness by brute
force, Chebyshev operator sanity, M2L symmetry identity, and error paths."""

import numpy as np
import pytest

from ferreus_rbf.config import FmmCompressionType, FmmParams
from ferreus_rbf.ops.fmm import cheb, m2l
from ferreus_rbf.ops.fmm.api import FmmTree, PointOutsideTreeError
from ferreus_rbf.ops.fmm.tree import build_tree, calculate_tree_center_and_radius
from ferreus_rbf.ops.kernels import KernelParams, KernelType, make_kernel


def make_tree(pts, p, kp, adaptive=True, sparse=True, mppc=64,
              comp=FmmCompressionType.ACA, extents=None):
    params = FmmParams(
        interpolation_order=p,
        max_points_per_cell=mppc,
        compression_type=comp,
        epsilon=10.0**-p,
    )
    return FmmTree(pts, p, kp, adaptive_tree=adaptive, sparse=sparse,
                   extents=extents, params=params)


# --------------------------------------------------------------- chebyshev
def test_chebyshev_interpolation_reproduces_polynomials():
    """S_p weights interpolate degree < p polynomials exactly."""
    p = 6
    nodes = cheb.chebyshev_nodes(p)
    nodes_t, _ = cheb.chebyshev_polynomials(nodes, p)
    x = np.linspace(-1, 1, 17)
    s = cheb.interpolation_matrix(x, nodes_t)

    for degree in range(p):
        f = nodes**degree
        np.testing.assert_allclose(s @ f, x**degree, atol=1e-12)


def test_anterpolation_weights_partition_of_unity():
    p, d = 5, 3
    nodes = cheb.chebyshev_nodes(p)
    nodes_t, _ = cheb.chebyshev_polynomials(nodes, p)
    rng = np.random.default_rng(0)
    pts = rng.random((1, 20, d)) * 2.0 - 1.0
    w, dw = cheb.anterpolation_weights(
        pts, np.zeros((1, d)), np.full((1,), 2.0), nodes_t, d, with_gradients=True
    )
    np.testing.assert_allclose(w.sum(axis=-1), 1.0, atol=1e-12)
    np.testing.assert_allclose(dw.sum(axis=-1), 0.0, atol=1e-11)


def test_m2m_transfer_preserves_far_field():
    """Child-aggregated multipoles equal direct parent anterpolation for a
    smooth test function (exact for polynomial data)."""
    p, d = 5, 2
    ops = cheb.m2m_transfer_matrices(p, d)
    nodes = cheb.chebyshev_nodes(p)
    grid = cheb.nodes_tensor_product(nodes, d)
    nodes_t, _ = cheb.chebyshev_polynomials(nodes, p)

    # place a point in child 0 ([-1,0]^2 of parent), compute its P2M in the
    # child then M2M to parent; compare against direct P2M to parent
    pt = np.array([[[-0.6, -0.3]]])
    w_child, _ = cheb.anterpolation_weights(
        pt, np.array([[-0.5, -0.5]]), np.full((1,), 1.0), nodes_t, d
    )
    w_parent, _ = cheb.anterpolation_weights(
        pt, np.array([[0.0, 0.0]]), np.full((1,), 2.0), nodes_t, d
    )
    via_m2m = ops[0] @ w_child[0, 0]
    np.testing.assert_allclose(via_m2m, w_parent[0, 0], atol=1e-12)


# ------------------------------------------------------------------- M2L
def test_m2l_permutation_identity():
    """Permuted reference operator equals the direct operator for every
    far-field transfer vector (Messner eq. 26/27)."""
    p, d = 4, 3
    kp = KernelParams(KernelType.LinearRbf)
    knp = make_kernel(kp, xp=np)
    pt = m2l.build_permutation_tables(p, d)
    refs = m2l.reference_m2l_vectors(d)
    nodes = cheb.chebyshev_nodes(p)
    grid = cheb.nodes_tensor_product(nodes, d)
    length = 0.37
    rng = np.random.default_rng(0)
    vectors = m2l.cartesian_rows(np.arange(-3, 4), d)
    far = vectors[np.max(np.abs(vectors), axis=1) >= 2]
    sample = far[rng.choice(far.shape[0], 25, replace=False)]
    mult = rng.standard_normal(p**d)
    for v in sample:
        vid = 0
        for j in range(d):
            vid = vid * 7 + (v[j] + 3)
        r = pt.ref_lookup[vid]
        c = pt.perm_lookup[vid]
        k_ref = m2l.reference_operator_matrix(knp, refs[r], p, d, length)
        row_pts = (v[None, :] + grid * 0.5) * length
        col_pts = grid * 0.5 * length
        k_v = np.asarray(knp.pair(row_pts, col_pts))
        perm = pt.perm_indices[c]
        inv = pt.inverse_perm[c]
        np.testing.assert_allclose((k_ref @ mult[perm])[inv], k_v @ mult, atol=1e-11)


def test_aca_matches_operator():
    p, d = 5, 3
    kp = KernelParams(KernelType.CubicRbf)
    knp = make_kernel(kp, xp=np)
    ref = np.array([3, 1, 0])
    dense = m2l.reference_operator_matrix(knp, ref, p, d, 0.25)
    u, vt = m2l.compress_operator(knp, ref, p, d, 0.25, "ACA", 1e-8)
    assert u.shape[1] < p**d  # actually compressed
    np.testing.assert_allclose(u @ vt, dense, atol=1e-7 * np.abs(dense).max())


# ----------------------------------------------------------- tree invariants
def _brute_force_adjacent(tree, a, b):
    ca = tree.cell_centers([a])[0]
    cb = tree.cell_centers([b])[0]
    la = tree.cell_lengths([a])[0]
    lb = tree.cell_lengths([b])[0]
    return np.all(np.abs(cb - ca) <= (la + lb) / 2 + 1e-9)


@pytest.mark.parametrize("adaptive,d", [(True, 2), (False, 2), (False, 3)])
def test_interaction_lists_brute_force(adaptive, d):
    rng = np.random.default_rng(3)
    pts = rng.random((300, d))
    center, radius = calculate_tree_center_and_radius(
        np.concatenate([pts.min(0), pts.max(0)])
    )
    tree = build_tree(pts, center, radius, 20, store_empty_leaves=True,
                      dimensions=d, adaptive=adaptive)

    leaves = np.nonzero(tree.is_leaf)[0]
    leaf_set = set(leaves.tolist())

    # u: adjacent leaves (any level), including self
    u_got = {}
    for t, s in tree.u_pairs:
        u_got.setdefault(int(t), set()).add(int(s))
    for b in leaves:
        want = {int(l) for l in leaves if _brute_force_adjacent(tree, int(b), int(l))}
        got = u_got.get(int(b), set())
        assert got == want, f"u mismatch for leaf {b}"

    # v: children of parent's colleagues at same level, non-adjacent
    v_got = {}
    for t, s, _vid in tree.v_pairs:
        v_got.setdefault(int(t), set()).add(int(s))
    for c in range(tree.num_cells):
        lv = int(tree.levels[c])
        if lv < 2:
            continue
        parent = int(tree.parent[c])
        want = set()
        for cand in range(tree.num_cells):
            if int(tree.levels[cand]) != lv or not tree.has_points[cand]:
                continue
            cand_parent = int(tree.parent[cand])
            if cand_parent == parent:
                continue  # sibling (parent is not its own colleague)
            if not _brute_force_adjacent(tree, parent, cand_parent):
                continue
            if _brute_force_adjacent(tree, c, cand):
                continue
            want.add(cand)
        got = v_got.get(c, set())
        # v_pairs keeps only sources with points (empty sources are no-ops)
        assert got == want, f"v mismatch for cell {c}: {got ^ want}"

    # w: descendants of colleagues, parent adjacent, self not adjacent
    w_got = {}
    for t, s in tree.w_pairs:
        w_got.setdefault(int(t), set()).add(int(s))
    for b in leaves:
        want = set()
        for cand in range(tree.num_cells):
            if int(tree.levels[cand]) <= int(tree.levels[b]):
                continue
            parent = int(tree.parent[cand])
            if _brute_force_adjacent(tree, int(b), parent) and not _brute_force_adjacent(
                tree, int(b), cand
            ):
                # parent chain must come from descending adjacent cells
                want.add(cand)
        got = w_got.get(int(b), set())
        assert got == want, f"w mismatch for leaf {b}: {got ^ want}"

    # x is the inverse of w
    assert set(map(tuple, tree.x_pairs.tolist())) == set(
        (int(s), int(t)) for t, s in tree.w_pairs
    )


def test_leaf_partition():
    rng = np.random.default_rng(4)
    pts = rng.random((500, 3))
    center, radius = calculate_tree_center_and_radius(
        np.concatenate([pts.min(0), pts.max(0)])
    )
    tree = build_tree(pts, center, radius, 32, store_empty_leaves=False,
                      dimensions=3, adaptive=True)
    # every point appears exactly once across leaf CSR buckets
    gathered = np.sort(tree.point_order)
    np.testing.assert_array_equal(gathered, np.arange(500))
    # per-leaf counts below threshold (unless at MAXIMUM_LEVEL)
    counts = np.diff(tree.leaf_offsets)
    assert counts.max() <= 32
    # leaves of the sparse tree all have points
    assert np.all(tree.has_points[tree.leaf_cells])


# --------------------------------------------------------- matvec equivalence
CASES = [
    (700, 2, 5, True, True, KernelType.LinearRbf),
    (700, 3, 4, True, False, KernelType.ThinPlateSplineRbf),
    (1200, 3, 5, False, False, KernelType.CubicRbf),
    (1500, 3, 5, True, True, KernelType.Spheroidal5Rbf),
    (900, 1, 5, True, False, KernelType.Laplacian),
]


@pytest.mark.parametrize("n,d,p,adaptive,sparse,ktype", CASES)
def test_matvec_matches_dense(n, d, p, adaptive, sparse, ktype):
    rng = np.random.default_rng(42)
    pts = rng.random((n, d))
    w = rng.standard_normal((n, 2))
    kp = KernelParams(ktype, base_range=2.0, total_sill=1.0)
    tree = make_tree(pts, p, kp, adaptive, sparse, mppc=48)
    tree.set_weights(w)
    targets = rng.random((300, d))
    got = tree.evaluate(w, targets)
    want = np.asarray(make_kernel(kp, xp=np).pair(targets, pts)) @ w
    scale = np.max(np.abs(want))
    # BBFMM error ~ 10^-p x conditioning; allow an order of slack
    tol = 50.0 * 10.0**-p * scale
    assert np.max(np.abs(got - want)) < tol


def test_matvec_gradients_match_dense():
    rng = np.random.default_rng(7)
    n, d, p = 1000, 3, 6
    pts = rng.random((n, d))
    w = rng.standard_normal((n, 2))
    kp = KernelParams(KernelType.LinearRbf)
    tree = make_tree(pts, p, kp, mppc=48, sparse=False)
    tree.set_weights(w)
    targets = rng.random((200, d))
    vals, grads = tree.evaluate_with_gradients(w, targets)
    kd = make_kernel(kp, xp=np)
    kmat, gmat = kd.pair_with_grad(targets, pts)
    want_v = kmat @ w
    want_g = np.einsum("mnd,nr->mrd", gmat, w).reshape(200, -1)
    assert np.max(np.abs(vals - want_v)) < 1e-4 * np.max(np.abs(want_v))
    assert np.max(np.abs(grads - want_g)) < 1e-2 * np.max(np.abs(want_g))


def test_leaf_mode_matches_full_mode():
    rng = np.random.default_rng(9)
    pts = rng.random((800, 3))
    w = rng.standard_normal((800, 1))
    kp = KernelParams(KernelType.CubicRbf)
    tree = make_tree(pts, 4, kp, sparse=False, mppc=48)
    tree.set_weights(w)
    tree.set_local_coefficients(w)
    targets = rng.random((150, 3))
    full = tree.evaluate(w, targets)
    leaves = tree.evaluate_leaves(w, targets)
    np.testing.assert_allclose(leaves, full, rtol=0, atol=1e-12)


def test_evaluate_leaves_with_gradients_matches_full_mode():
    """Leaf-mode gradients == full-mode gradients after a full downward pass
    populated the locals (the evaluator-split path RMT seed projection uses)."""
    rng = np.random.default_rng(21)
    pts = rng.random((700, 3))
    w = rng.standard_normal((700, 2))
    kp = KernelParams(KernelType.LinearRbf)
    tree = make_tree(pts, 5, kp, sparse=False, mppc=48)
    tree.set_weights(w)
    targets = rng.random((120, 3))
    full_v, full_g = tree.evaluate_with_gradients(w, targets)
    # the full-mode call above left self._local populated; leaf mode reuses it
    leaf_v, leaf_g = tree.evaluate_leaves_with_gradients(w, targets)
    np.testing.assert_allclose(leaf_v, full_v, rtol=0, atol=1e-12)
    np.testing.assert_allclose(leaf_g, full_g, rtol=0, atol=1e-12)
    # and the gradients are right: finite differences on the full evaluate
    eps = 1e-6
    for axis in range(3):
        tp = targets.copy(); tp[:, axis] += eps
        tm = targets.copy(); tm[:, axis] -= eps
        fd = (tree.evaluate(w, tp) - tree.evaluate(w, tm)) / (2 * eps)
        got = leaf_g.reshape(120, 2, 3)[:, :, axis]
        assert np.max(np.abs(got - fd)) < 5e-4 * max(1.0, np.max(np.abs(fd)))


def test_evaluate_at_sources_multi_rhs():
    rng = np.random.default_rng(11)
    n = 1200
    pts = rng.random((n, 3))
    w = rng.standard_normal((n, 4))
    kp = KernelParams(KernelType.LinearRbf)
    tree = make_tree(pts, 5, kp, mppc=64)
    tree.set_weights(w)
    got = tree.evaluate(w, pts, reuse_key="src")
    want = np.asarray(make_kernel(kp, xp=np).pair(pts, pts)) @ w
    assert np.max(np.abs(got - want)) < 1e-3 * np.max(np.abs(want))
    # cached binning gives identical results
    np.testing.assert_array_equal(tree.evaluate(w, pts, reuse_key="src"), got)


def test_point_outside_tree_error():
    rng = np.random.default_rng(13)
    pts = rng.random((100, 2))
    kp = KernelParams(KernelType.LinearRbf)
    tree = make_tree(pts, 3, kp, mppc=16, extents=np.array([0.0, 0.0, 1.0, 1.0]))
    w = np.ones((100, 1))
    tree.set_weights(w)
    with pytest.raises(PointOutsideTreeError) as exc:
        tree.evaluate(w, np.array([[0.5, 0.5], [10.0, 0.5]]))
    assert exc.value.point_index == 1


def test_eval_chunk_size_changes_chunking_not_values():
    """FmmParams.eval_chunk_size scales the leaf-pass scan chunk budgets
    (the knob must be wired, not decorative). Chunking splits
    over target rows only, so per-row reduction order — and the result —
    is unchanged."""
    rng = np.random.default_rng(5)
    pts = rng.random((3000, 3))
    kp = KernelParams(KernelType.LinearRbf)
    w = rng.standard_normal((3000, 2))

    results, chunks = [], []
    for ecs in (64, 1024):
        params = FmmParams(interpolation_order=4, max_points_per_cell=64,
                           compression_type=FmmCompressionType.ACA,
                           epsilon=1e-4, eval_chunk_size=ecs)
        tree = FmmTree(pts, 4, kp, adaptive_tree=True, sparse=True, params=params)
        tree.set_weights(w)
        results.append(tree.evaluate(w, pts))
        binned = tree._ensure_scan_tables(tree._bin_targets(pts, None))
        chunks.append([m[1] for m in binned["p2p_meta"]])
    assert chunks[0] != chunks[1], chunks  # the knob visibly changes chunking
    np.testing.assert_allclose(results[0], results[1], rtol=1e-13, atol=1e-13)


def test_f32_matvec_with_utm_scale_offsets():
    """Real-world coordinates (UTM northings ~7.7e6 with metre-scale
    extents) must not lose precision in the f32 inner-matvec path: device
    geometry is stored tree-centred (translation-invariant kernels)."""
    rng = np.random.default_rng(11)
    offset = np.array([329_500.0, 7_744_800.0, 150.0])
    pts = rng.random((3000, 3)) * np.array([460.0, 818.0, 542.0]) + offset
    kp = KernelParams(KernelType.LinearRbf)
    tree = FmmTree(pts, 5, kp, adaptive_tree=True, sparse=True)
    tree.prepare_targets(pts, "src")
    n_pad = tree._target_cache["src"]["n_pad"]
    w = np.zeros((n_pad, 2))
    w[:3000] = rng.standard_normal((3000, 2))
    import jax.numpy as jnp

    v64 = np.asarray(tree.evaluate_device(jnp.asarray(w), "src", precision="f64"))
    v32 = np.asarray(tree.evaluate_device(jnp.asarray(w), "src", precision="f32"))
    rel = np.max(np.abs(v32 - v64)) / np.max(np.abs(v64))
    # raw-coordinate f32 casts give ~1e-3 here; centred geometry keeps the
    # f32 tier at f32 grade (~1e-7 here; f32 bucket accumulation at scale
    # adds more), which the refined solver's f64 residuals absorb
    assert rel < 2e-5, rel
