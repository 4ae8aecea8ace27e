"""Fit Franke's 2D test function and evaluate it on a regular grid.

Port of the reference workflow ``ferreus_rbf/examples/franke_2d.rs``.
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))

import numpy as np

import ferreus_rbf as frt


def main():
    points = frt.generate_random_points(2000, 2, seed=42)
    values = frt.RBFTestFunctions.franke_2d(points)

    settings = frt.InterpolantSettings(
        kernel_type=frt.RBFKernelType.ThinPlateSpline
    )
    rbfi = frt.RBFInterpolator(points, values, settings)

    resid = np.max(np.abs(rbfi.evaluate(points) - values))
    print(f"max residual at sources: {resid:.3e}")

    grid = frt.create_evaluation_grid([(0.0, 1.0), (0.0, 1.0)], [101, 101])
    interpolated = rbfi.evaluate(grid)
    err = np.max(np.abs(interpolated - frt.RBFTestFunctions.franke_2d(grid)))
    print(f"max grid error vs analytic Franke: {err:.3e}")

    frt.point_arrays_to_csv(grid, interpolated, "franke_2d_interpolated.csv")
    print("wrote franke_2d_interpolated.csv")


if __name__ == "__main__":
    main()
