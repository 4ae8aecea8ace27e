"""Fit the albatite signed-distance dataset with a spheroidal kernel and
extract the zero isosurface.

Port of ``ferreus_rbf/examples/isosurface_spheroidal.rs``.
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))

import numpy as np

import ferreus_rbf as frt
from common import load_albatite


def main():
    points, values = load_albatite()
    extents = np.concatenate([points.min(axis=0), points.max(axis=0)])
    span = np.max(extents[3:] - extents[:3])

    settings = frt.InterpolantSettings(
        kernel_type=frt.RBFKernelType.Spheroidal,
        spheroidal_order=frt.SpheroidalOrder.Five,
        base_range=span / 4.0,
        total_sill=span / 4.0,
    )
    rbfi = frt.RBFInterpolator(points, values, settings)

    resid = np.max(np.abs(rbfi.evaluate_at_source(True) - values))
    print(f"fit residual: {resid:.3e} over {points.shape[0]} points")

    resolution = span / 100.0
    mesh = rbfi.build_isosurface(extents, resolution, 0.0, frt.BoundaryClosure.None_)
    print(f"isosurface: {mesh.num_vertices} vertices, {mesh.num_facets} facets")
    mesh.save_obj("albatite_spheroidal.obj")


if __name__ == "__main__":
    main()
