"""Test configuration: run everything on a virtual 8-device CPU mesh.

Sharding correctness is validated on XLA:CPU with a forced host device
count.  Tests marked ``gpu`` need a card; they skip here and run on a GPU
host with ``GMPNP_TEST_ACCEL=1 python -m pytest -m gpu tests/``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "xla_cpu_collective_call_terminate_timeout_seconds" not in flags:
    # 8 virtual devices time-share the bench host's single core, so the
    # per-device compute between two collectives (e.g. the replicated
    # SPIKE reduced-system factorization at reference mesh size,
    # parallel/shard.py) can exceed XLA:CPU's default rendezvous
    # terminate timeout — which aborts the process, not just warns
    flags += (" --xla_cpu_collective_call_warn_stuck_timeout_seconds=600"
              " --xla_cpu_collective_call_terminate_timeout_seconds=3600"
              " --xla_cpu_collective_timeout_seconds=3600")
os.environ["XLA_FLAGS"] = flags

import jax  # noqa: E402

# Tests run on the virtual 8-device CPU mesh unless GMPNP_TEST_ACCEL is set
# (the gpu-marked tests on a card).
if not os.environ.get("GMPNP_TEST_ACCEL"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Session-scoped XLA compile cache (the cold suite is compile-dominated).
# Distinct tests independently build IDENTICAL programs (same model config
# + mesh + step count); the persistent cache dedupes those by HLO hash
# within one run.  A fresh temp dir per session keeps it honest on a cold
# host and leaves no machine-specific CPU AOT artifacts behind.
# Set GMPNP_TEST_COMPILE_CACHE=<dir> for a persistent local cache during
# development iteration.
import tempfile  # noqa: E402

_cache_dir = os.environ.get("GMPNP_TEST_COMPILE_CACHE") or tempfile.mkdtemp(
    prefix="gmpnp_xla_cache_")
jax.config.update("jax_compilation_cache_dir", _cache_dir)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)

import pathlib  # noqa: E402

import pytest  # noqa: E402

REFERENCE_DIR = pathlib.Path("/root/reference")


@pytest.fixture(scope="session")
def reference_utilities():
    """Path to the read-only reference data dir, or skip if absent."""
    p = REFERENCE_DIR / "utilities"
    if not p.exists():
        pytest.skip("reference data not mounted")
    return p


@pytest.fixture(scope="session")
def gpu_device():
    """The first GPU, or skip: tests marked ``gpu`` need a card."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs a GPU (GMPNP_TEST_ACCEL=1 on a card)")
    return gpus[0]
