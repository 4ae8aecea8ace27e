"""Test configuration: the CPU backend with a virtual 8-device mesh.

The tests run on the CPU unless ``JAX_PLATFORMS`` names another platform:
``xla_force_host_platform_device_count=8`` gives the CPU backend eight
virtual devices, which stand in for a multi-card host in the sharding tests
(SURVEY.md section 4).

Tests marked ``gpu`` need the card; they skip with a reason elsewhere. The
decision is made per test in a fixture, never while a module is imported.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {jax.default_backend()}")
