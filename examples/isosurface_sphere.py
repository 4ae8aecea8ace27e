"""Extract a sphere isosurface from an analytic SDF with standalone RMT.

Port of ``ferreus_rmt/examples/sphere.rs`` — the golden-output workflow
(540 vertices / 1076 facets at resolution 0.2 in [-1.5, 1.5]^3).
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))

import numpy as np

from ferreus_rbf.isosurfacing import BoundaryClosure, ClusterMethod, build_isosurface


def sphere_sdf(pts):
    return np.linalg.norm(pts, axis=1, keepdims=True) - 1.0


def sphere_grad(pts):
    n = np.linalg.norm(pts, axis=1, keepdims=True)
    return n - 1.0, pts / np.maximum(n, 1e-12)


def main():
    mesh = build_isosurface(
        np.array([[1.0, 0.0, 0.0]]),
        [-1.5, -1.5, -1.5, 1.5, 1.5, 1.5],
        0.2,
        0.0,
        sphere_sdf,
        sphere_grad,
        ClusterMethod.CurvatureWeighted,
        BoundaryClosure.None_,
    )
    print(f"sphere mesh: {mesh.num_vertices} vertices, {mesh.num_facets} facets")
    mesh.save_obj("sphere.obj")
    print("wrote sphere.obj")


if __name__ == "__main__":
    main()
