"""Linear-kernel fit under a 3D global trend (anisotropy) + isosurface.

Port of ``ferreus_rbf/examples/isosurface_trend_linear.rs``.
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

    trend = frt.GlobalTrend.three(
        dip=30.0,
        dip_direction=45.0,
        pitch=0.0,
        major_ratio=2.0,
        semi_major_ratio=1.5,
        minor_ratio=1.0,
    )

    settings = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.Linear)
    rbfi = frt.RBFInterpolator(points, values, settings, global_trend=trend)

    mesh = rbfi.build_isosurface(extents, span / 100.0, 0.0, frt.BoundaryClosure.None_)
    print(f"isosurface: {mesh.num_vertices} vertices, {mesh.num_facets} facets")
    mesh.save_obj("albatite_trend.obj")


if __name__ == "__main__":
    main()
