"""Shared helpers for the example scripts."""

import os

import numpy as np

# The real-geology signed-distance dataset (35,801 points: X, Y, Z,
# SignedDistance), vendored under datasets/ at the repo root (the reference
# vendors the same file in its datasets/ dir). Falls back to a synthetic SD
# point cloud if the file is missing so the examples always run.
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALBATITE_CSV = os.environ.get(
    "ALBATITE_CSV", os.path.join(_REPO_ROOT, "datasets", "albatite_SD_points.csv")
)


def load_albatite():
    from ferreus_rbf import csv_to_point_arrays

    if os.path.exists(ALBATITE_CSV):
        pts, vals = csv_to_point_arrays(ALBATITE_CSV, has_headers=True)
        # CI smoke runs subsample so every example finishes in seconds on a
        # CPU backend; unset (the default) loads the full 35,801 points
        cap = int(os.environ.get("FERREUS_EXAMPLES_MAX_POINTS", "0"))
        if 0 < cap < pts.shape[0]:
            sel = np.random.default_rng(0).choice(pts.shape[0], cap, replace=False)
            pts, vals = pts[sel], vals[sel]
        return pts, vals
    # fallback: signed distances to a lumpy closed surface
    rng = np.random.default_rng(42)
    n = 35_801
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    bump = 1.0 + 0.15 * np.sin(4 * dirs[:, 0]) * np.cos(3 * dirs[:, 1])
    radii = rng.choice([0.75, 1.0, 1.25], size=n)
    pts = dirs * (bump * radii)[:, None] * 100.0
    sd = (radii - 1.0) * 100.0
    return pts, sd[:, None]
