"""fmm_error_budget: the truncation-vs-precision attribution sweep.

Small-scale CPU check of the instrument itself (the at-scale numbers it
exists to produce come from bench.py on the GPU): error must track the
interpolation order at fixed precision, the f64 tier must not be WORSE
than the f32 tier, and the verdict must attribute a truncation-dominated
setup to truncation.
"""

import numpy as np
import pytest

from ferreus_rbf.ops.fmm.diagnostics import dense_oracle, fmm_error_budget
from ferreus_rbf.ops.kernels import KernelParams, KernelType


def _cloud(n, seed=11):
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radii = 0.7 + 0.6 * rng.random(n)
    pts = dirs * radii[:, None]
    w = rng.standard_normal((n, 1))
    return pts, w


def test_budget_tracks_order_and_attributes():
    pts, w = _cloud(4000)
    kp = KernelParams(KernelType.LinearRbf)
    budget = fmm_error_budget(pts, w, kp, orders=(3, 6), n_sample=128)
    by = {(e["p"], e["prec"]): e["err"] for e in budget["entries"]}
    # truncation: higher order is at least ~10x more accurate
    assert by[(6, "f64")] < 0.1 * by[(3, "f64")]
    # f64 arithmetic is never worse than f32 beyond noise (3x band)
    assert all(by[(p, "f64")] < 3.0 * by[(p, "f32")] for p in (3, 6))
    assert budget["tracks_p"]
    assert budget["verdict"] == "cheb_truncation"
    # and the absolute scale is sane for p=6 (epsilon 1e-6)
    assert by[(6, "f64")] < 1e-4


def test_dense_oracle_matches_direct():
    pts, w = _cloud(600)
    kp = KernelParams(KernelType.LinearRbf)
    idx = np.arange(0, 600, 7)
    got = dense_oracle(pts, w, kp, idx, chunk_bytes=1e5)  # force chunking
    from ferreus_rbf.ops.kernels import make_kernel

    kernel = make_kernel(kp, xp=np)
    want = kernel.pair(pts[idx], pts) @ w
    np.testing.assert_allclose(got, want, rtol=1e-13)
