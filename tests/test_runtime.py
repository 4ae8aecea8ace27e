"""Process-level settings: the compile-cache location and the precision
tiers the FMM accepts."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir_after_import(env_update):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_update, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c",
         "import ferreus_rbf, jax; print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_honours_env(tmp_path):
    target = str(tmp_path / "cache")
    assert _cache_dir_after_import({"JAX_COMPILATION_CACHE_DIR": target}) == target
    from ferreus_rbf import _compile_cache_dir

    assert _compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": target}) is None


def test_compile_cache_default_is_fixed_in_checkout():
    want = os.path.join(REPO, ".jax_cache")
    assert _cache_dir_after_import({}) == want
    from ferreus_rbf import _compile_cache_dir

    assert _compile_cache_dir({}) == want
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_evaluate_device_rejects_unknown_precision():
    from ferreus_rbf.ops.fmm.api import FmmTree
    from ferreus_rbf.ops.kernels import KernelParams, KernelType

    rng = np.random.default_rng(0)
    pts = rng.random((300, 2))
    tree = FmmTree(pts, 3, KernelParams(KernelType.LinearRbf))
    tree.prepare_targets(pts, "src")
    w = jnp.asarray(rng.standard_normal((300, 1)))
    # only the f32 and f64 tiers exist; any other name raises instead of
    # picking a tier
    for bad in ("double-float", "f16", "bf16"):
        with pytest.raises(ValueError, match="precision"):
            tree.evaluate_device(w, "src", precision=bad)
    assert tree.evaluate_device(w, "src", precision="f32").shape == (300, 1)
