"""Boundary closure demo: watertight caps on a clipped sphere.

Port of the reference's ``py_ferreus_rbf/examples/boundary_closure.py``
workflow: extract the same clipped surface open, closed-positive, and
closed-negative, and report watertightness + enclosed volume.
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


def stats(mesh):
    edges = {}
    for t in mesh.facets:
        for a, b in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
            k = (min(a, b), max(a, b))
            edges[k] = edges.get(k, 0) + 1
    watertight = all(c == 2 for c in edges.values())
    tri = mesh.vertices[mesh.facets]
    vol = np.einsum("ij,ij->i", tri[:, 0], np.cross(tri[:, 1], tri[:, 2])).sum() / 6.0
    return watertight, vol


def main():
    seeds = np.array([[1.0, 0.0, 0.0]])
    extents = [-1.5, -1.5, -1.5, 0.6, 1.5, 1.5]  # clips the sphere at x=0.6
    for mode in (BoundaryClosure.None_, BoundaryClosure.ClosePositive,
                 BoundaryClosure.CloseNegative):
        mesh = build_isosurface(
            seeds, extents, 0.2, 0.0, sphere_sdf, sphere_grad,
            ClusterMethod.CurvatureWeighted, mode,
        )
        watertight, vol = stats(mesh)
        print(f"{mode.value:>14}: V={mesh.num_vertices:4d} F={mesh.num_facets:4d} "
              f"watertight={watertight} volume={vol:8.4f}")
        mesh.save_obj(f"sphere_{mode.value}.obj")


if __name__ == "__main__":
    main()
