"""Smoke-run example scripts end-to-end.

Each example is executed in a subprocess (its own JAX runtime, forced to
CPU the way conftest does — the JAX_PLATFORMS env var is ignored by this
install) with a temporary working directory so artifact files don't land
in the repo.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_DRIVER = """
import jax
jax.config.update("jax_platforms", "cpu")
import os, runpy, sys
# `python examples/foo.py` puts examples/ on sys.path[0] (for `common`);
# runpy.run_path does not, so replicate it
sys.path.insert(0, os.path.dirname(sys.argv[1]))
runpy.run_path(sys.argv[1], run_name="__main__")
"""


@pytest.mark.parametrize(
    "script,expect",
    [
        ("boundary_closure.py", "V="),
        ("franke_2d.py", "max residual at sources"),
        ("isosurface_linear.py", "vertices"),
        ("isosurface_linear_rmt.py", "vertices"),
        ("isosurface_linear_topo.py", "clipped below topography"),
        ("isosurface_sphere.py", "540 vertices, 1076 facets"),
        ("isosurface_spheroidal.py", "vertices"),
        ("isosurface_spheroidal_drift.py", "poly coefficients"),
        ("isosurface_trend_linear.py", "vertices"),
    ],
)
def test_example_runs(tmp_path, script, expect):
    proc = subprocess.run(
        [sys.executable, "-c", _DRIVER, os.path.join(REPO, "examples", script)],
        cwd=tmp_path,
        capture_output=True,
        text=True,
        timeout=600,
        # albatite-backed examples subsample to 3500 points under the smoke
        # cap so each finishes in seconds on the CPU test backend
        # the examples run on the CPU: a second process must not take the
        # card from a pytest run on the GPU
        env={**os.environ, "PYTHONPATH": REPO, "FERREUS_EXAMPLES_MAX_POINTS": "3500",
             "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert expect in proc.stdout
