"""Test configuration: run on CPU with 8 virtual XLA devices (to exercise
mesh/sharding code without several accelerators) and float64 enabled (to compare
against exact linear-Gaussian oracles, mirroring the reference's CI setup:
``.github/workflows/unittest.yml`` runs pytest on ``jax[cpu]``)."""

import os
import subprocess
import sys

# Must be set before the first jax backend initialization.  The platform
# is pinned through jax.config, which wins over any JAX_PLATFORMS value in
# the environment.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


import pytest  # noqa: E402


@pytest.fixture
def gpu_subprocess_env():
    """Environment for a subprocess that runs on the GPU (the suite itself
    is pinned to the CPU); skips the test when no GPU is visible.  Decided
    here, never at import time, so every xdist worker collects the same
    tests."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    probe = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=300)
    if probe.stdout.strip().splitlines()[-1:] != ["gpu"]:
        pytest.skip("no GPU visible")
    return env
