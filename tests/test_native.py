"""Native C++ interaction-list builder vs the numpy implementation."""

import numpy as np
import pytest

from ferreus_rbf import native
from ferreus_rbf.ops.fmm.tree import (
    _build_interaction_lists_numpy,
    build_tree,
    calculate_tree_center_and_radius,
)


@pytest.mark.skipif(not native.native_available(), reason="no native library")
@pytest.mark.parametrize("d,store_empty", [(2, True), (3, False), (3, True), (1, False)])
def test_native_lists_match_numpy(d, store_empty):
    rng = np.random.default_rng(5)
    pts = rng.random((600, d))
    center, radius = calculate_tree_center_and_radius(
        np.concatenate([pts.min(0), pts.max(0)])
    )
    tree = build_tree(pts, center, radius, 24, store_empty_leaves=store_empty,
                      dimensions=d, adaptive=True)  # native path inside

    # recompute with the numpy reference implementation
    import copy

    ref = copy.copy(tree)
    _build_interaction_lists_numpy(ref)

    def canon(pairs):
        return set(map(tuple, np.asarray(pairs).tolist()))

    assert canon(tree.u_pairs) == canon(ref.u_pairs)
    assert canon(tree.w_pairs) == canon(ref.w_pairs)
    # numpy v list is unfiltered; the native one drops empty sources
    ref_v = ref.v_pairs[ref.has_points[ref.v_pairs[:, 1]]] if ref.v_pairs.size else ref.v_pairs
    assert canon(tree.v_pairs) == canon(ref_v)
