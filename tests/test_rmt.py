"""Regularised marching tetrahedra tests: the golden sphere (exact
vertex/facet counts, the reference's acceptance test at
``ferreus_rmt/src/lib.rs:104-105``), manifoldness, boundary closure
volumes, and the full RBF -> isosurface pipeline."""

import numpy as np
import pytest

import ferreus_rbf as frt
from ferreus_rbf.isosurfacing import BoundaryClosure, ClusterMethod
from ferreus_rbf.rmt.isosurface import build_isosurface
from ferreus_rbf.rmt import topology


def sphere_sdf(pts):
    return np.linalg.norm(pts, axis=1, keepdims=True) - 1.0


def sphere_grad(pts):
    n = np.linalg.norm(pts, axis=1, keepdims=True)
    return n - 1.0, pts / np.maximum(n, 1e-12)


def edge_counts(mesh):
    edges = {}
    for t in mesh.facets:
        for a, b in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
            k = (min(a, b), max(a, b))
            edges[k] = edges.get(k, 0) + 1
    return edges


def is_watertight(mesh):
    counts = list(edge_counts(mesh).values())
    return bool(counts) and all(c == 2 for c in counts)


def signed_volume(mesh):
    tri = mesh.vertices[mesh.facets]
    return float(np.einsum("ij,ij->i", tri[:, 0], np.cross(tri[:, 1], tri[:, 2])).sum() / 6.0)


SEEDS = np.array([[1.0, 0.0, 0.0]])
# Clipped-box tests (x <= 0.6) must seed ON the surface INSIDE the box:
# per the reference contract seeds are clamped to the lattice AABB every
# Newton step (seed_projection.rs:113-116), so a seed whose surface point
# lies outside the box pins to the face in a non-crossing cell and dies.
CLIP_SEEDS = np.array([[-1.0, 0.0, 0.0]])


def test_golden_sphere():
    """The de-facto acceptance test: exact counts for the unit sphere at
    resolution 0.2 in [-1.5, 1.5]^3 (matches the reference's 540/1076)."""
    mesh = build_isosurface(
        SEEDS, [-1.5] * 3 + [1.5] * 3, 0.2, 0.0, sphere_sdf, sphere_grad,
        ClusterMethod.CurvatureWeighted, BoundaryClosure.None_,
    )
    assert mesh.num_vertices == 540
    assert mesh.num_facets == 1076
    assert is_watertight(mesh)
    edges = edge_counts(mesh)
    assert mesh.num_vertices - len(edges) + mesh.num_facets == 2  # sphere
    r = np.linalg.norm(mesh.vertices, axis=1)
    assert r.min() > 0.98 and r.max() < 1.01
    # outward winding
    tri = mesh.vertices[mesh.facets]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    assert np.all(np.einsum("ij,ij->i", n, tri.mean(axis=1)) > 0)
    # volume ~ 4/3 pi (discretised slightly below)
    assert abs(signed_volume(mesh) - 4.18879) < 0.15


def test_isovalue_offset_changes_radius():
    mesh = build_isosurface(
        SEEDS, [-1.5] * 3 + [1.5] * 3, 0.2, 0.25, sphere_sdf, sphere_grad,
        ClusterMethod.CurvatureWeighted, BoundaryClosure.None_,
    )
    r = np.linalg.norm(mesh.vertices, axis=1)
    assert abs(np.mean(r) - 1.25) < 0.02


def test_central_difference_fallback():
    """No analytic gradient: seed projection falls back to central diffs."""
    mesh = build_isosurface(
        SEEDS, [-1.5] * 3 + [1.5] * 3, 0.25, 0.0, sphere_sdf, None,
        ClusterMethod.CurvatureWeighted, BoundaryClosure.None_,
    )
    assert is_watertight(mesh)


def test_cluster_method_none_gives_more_vertices():
    raw = build_isosurface(
        SEEDS, [-1.5] * 3 + [1.5] * 3, 0.25, 0.0, sphere_sdf, sphere_grad,
        ClusterMethod.None_, BoundaryClosure.None_,
    )
    clustered = build_isosurface(
        SEEDS, [-1.5] * 3 + [1.5] * 3, 0.25, 0.0, sphere_sdf, sphere_grad,
        ClusterMethod.CurvatureWeighted, BoundaryClosure.None_,
    )
    assert raw.num_vertices > clustered.num_vertices
    assert is_watertight(raw)


def test_boundary_closure_volumes():
    """Sphere clipped by the +x box face: ClosePositive encloses the cut
    sphere, CloseNegative the box-minus-sphere complement."""
    extents = [-1.5, -1.5, -1.5, 0.6, 1.5, 1.5]
    h = 1.0 - 0.6
    cap = np.pi * h * h * (3 - h) / 3
    cut_sphere = 4 / 3 * np.pi - cap
    box = (0.6 + 1.5) * 3.0 * 3.0

    closed_pos = build_isosurface(
        CLIP_SEEDS, extents, 0.2, 0.0, sphere_sdf, sphere_grad,
        ClusterMethod.CurvatureWeighted, BoundaryClosure.ClosePositive,
    )
    assert is_watertight(closed_pos)
    assert abs(signed_volume(closed_pos) - cut_sphere) < 0.1

    closed_neg = build_isosurface(
        CLIP_SEEDS, extents, 0.2, 0.0, sphere_sdf, sphere_grad,
        ClusterMethod.CurvatureWeighted, BoundaryClosure.CloseNegative,
    )
    assert is_watertight(closed_neg)
    assert abs(signed_volume(closed_neg) - (box - cut_sphere)) < 0.15


def _mc_volume(f, extents, n=400_000, seed=5):
    """Monte-Carlo volume of {f < 0} inside the box."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(extents[:3])
    hi = np.asarray(extents[3:])
    pts = lo + rng.random((n, 3)) * (hi - lo)
    frac = float(np.mean(f(pts).reshape(-1) < 0.0))
    return frac * float(np.prod(hi - lo))


def _grad_from_f(f, eps=1e-5):
    def g(pts):
        v = f(pts)
        grads = np.zeros_like(pts)
        for k in range(3):
            dp = np.zeros(3)
            dp[k] = eps
            grads[:, k] = ((f(pts + dp) - f(pts - dp)) / (2 * eps)).reshape(-1)
        return v, grads
    return g


# ---------------------------------------------------- adversarial closure
# Cases where the earcut+perimeter-completion closure
# could diverge from the reference's per-face CDT + inside/outside flood
# (``boundary_closure.rs:39-48,642``): nested loops on one face, caps
# meeting at box edges/corners, many exit faces, multiple components.


def test_closure_annulus_nested_loops():
    """Hollow cylinder through two opposite faces: each z-face cap is an
    ANNULUS (outer loop + hole on one face)."""
    c, w = 0.6, 0.25

    def f(pts):
        rho = np.linalg.norm(pts[:, :2], axis=1, keepdims=True)
        return np.abs(rho - c) - w

    ext = [-1.2, -1.2, -0.5, 1.2, 1.2, 0.5]
    # the two cylinders are disconnected isosurface components: seed both
    # (the RBF pipeline seeds every source point, which covers this)
    seeds = np.array([[c + w, 0.0, 0.0], [c - w, 0.0, 0.0]])
    mesh = build_isosurface(seeds, ext, 0.06, 0.0, f, _grad_from_f(f),
                            ClusterMethod.CurvatureWeighted, BoundaryClosure.ClosePositive)
    assert is_watertight(mesh)
    expect = np.pi * ((c + w) ** 2 - (c - w) ** 2) * 1.0  # annulus x height
    vol = signed_volume(mesh)
    assert abs(vol - expect) < 0.06 * expect, (vol, expect)


def test_closure_corner_caps():
    """Sphere centred on a box corner: three face caps meet at box edges
    and at the corner itself; enclosed volume is one sphere octant."""
    r = 0.8

    def f(pts):
        return np.linalg.norm(pts - np.array([1.0, 1.0, 1.0]), axis=1, keepdims=True) - r

    ext = [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]
    s = 1.0 - r / np.sqrt(3.0)
    seeds = np.array([[s, s, s]])
    mesh = build_isosurface(seeds, ext, 0.05, 0.0, f, _grad_from_f(f),
                            ClusterMethod.CurvatureWeighted, BoundaryClosure.ClosePositive)
    assert is_watertight(mesh)
    expect = (4.0 / 3.0) * np.pi * r**3 / 8.0
    vol = signed_volume(mesh)
    assert abs(vol - expect) < 0.08 * expect, (vol, expect)


def test_closure_five_exit_faces():
    """Off-centre large sphere exiting through five of the six faces."""
    ctr = np.array([0.0, 0.0, 0.5])
    r = 1.3

    def f(pts):
        return np.linalg.norm(pts - ctr, axis=1, keepdims=True) - r

    ext = [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]
    seeds = np.array([[0.0, 0.0, 0.5 - r]])
    mesh = build_isosurface(seeds, ext, 0.06, 0.0, f, _grad_from_f(f),
                            ClusterMethod.CurvatureWeighted, BoundaryClosure.ClosePositive)
    assert is_watertight(mesh)
    expect = _mc_volume(f, ext)
    vol = signed_volume(mesh)
    assert abs(vol - expect) < 0.05 * expect, (vol, expect)


def test_closure_multi_component():
    """Two disjoint spheres poking through opposite faces: the closure must
    cap two separate components on different faces in one pass."""
    c1 = np.array([0.9, 0.0, 0.0])
    c2 = np.array([-0.9, 0.0, 0.0])
    r = 0.5

    def f(pts):
        d1 = np.linalg.norm(pts - c1, axis=1) - r
        d2 = np.linalg.norm(pts - c2, axis=1) - r
        return np.minimum(d1, d2)[:, None]

    ext = [-1.2, -1.2, -1.2, 1.2, 1.2, 1.2]
    seeds = np.array([[0.9, 0.0, -r], [-0.9, 0.0, -r]])
    mesh = build_isosurface(seeds, ext, 0.05, 0.0, f, _grad_from_f(f),
                            ClusterMethod.CurvatureWeighted, BoundaryClosure.ClosePositive)
    assert is_watertight(mesh)
    expect = _mc_volume(f, ext)
    vol = signed_volume(mesh)
    assert abs(vol - expect) < 0.06 * expect, (vol, expect)


def test_open_clip_leaves_boundary():
    extents = [-1.5, -1.5, -1.5, 0.6, 1.5, 1.5]
    mesh = build_isosurface(
        CLIP_SEEDS, extents, 0.2, 0.0, sphere_sdf, sphere_grad,
        ClusterMethod.CurvatureWeighted, BoundaryClosure.None_,
    )
    counts = list(edge_counts(mesh).values())
    assert any(c == 1 for c in counts)  # open rim on the clip plane
    assert np.max(mesh.vertices[:, 0]) <= 0.6 + 1e-9


def test_topology_connected_components():
    # single component
    assert len(topology.connected_components_masks(0b11)) == 1
    # edges 1 (mask 0x2) and 8 (0x100) are opposite in-plane edges: separate
    comps = topology.connected_components_masks((1 << 1) | (1 << 8))
    assert len(comps) == 2
    # full mask is one component
    assert len(topology.connected_components_masks(topology.ALL14_MASK)) == 1


def test_rbf_isosurface_end_to_end():
    """Fit an RBF to sphere SDF samples, then extract its zero level set."""
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(400, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radii = np.array([0.7, 1.0, 1.3]).repeat(134)[:400]
    pts = dirs * radii[:, None]
    vals = np.linalg.norm(pts, axis=1, keepdims=True) - 1.0

    settings = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.Linear)
    rbfi = frt.RBFInterpolator(pts, vals, settings)
    mesh = rbfi.build_isosurface([-1.4] * 3 + [1.4] * 3, 0.25, 0.0, BoundaryClosure.None_)
    assert mesh.num_facets > 100
    assert is_watertight(mesh)
    r = np.linalg.norm(mesh.vertices, axis=1)
    assert abs(np.mean(r) - 1.0) < 0.05
