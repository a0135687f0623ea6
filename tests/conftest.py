"""Test env: run on CPU with 8 virtual devices so sharding/halo-exchange tests
work without several cards (SURVEY.md §4: multi-host tests on forced host
platform).  Tests that need a card carry the `gpu` marker and decide in a
fixture (gpu_card) whether one is present."""

import os
import shutil
import subprocess

import pytest

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
# tests that drive the CLI in-process point JAX at the persistent compile
# cache (utils.compile_cache); the suite itself keeps no cache on disk
jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture
def gpu_card():
    """Skip unless an NVIDIA card is present.  This process itself is held
    to the CPU, so a `gpu` test runs its device half in a child process."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True,
                                     timeout=30).returncode != 0:
        pytest.skip("no NVIDIA card on this host")
