"""
Test configuration: the CPU backend with 8 virtual devices, so the
multi-device sharding paths (jax.sharding.Mesh / shard_map) are exercised
without accelerators. A platform set in JAX_PLATFORMS wins: on a GPU host,
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` runs the tests that
need the card (the rest of the suite expects the 8 CPU devices).

Must run before jax is imported anywhere.
"""

import os
import sys

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Make the repo root importable when pytest is run from anywhere.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from aind_smartspim_destripe_tpu.runtime import enable_compile_cache  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
# Persistent compile cache (the package's own rule: $JAX_COMPILATION_CACHE_DIR
# or the in-checkout .jax_cache): the suite compiles many small graphs whose
# shapes repeat across runs.
enable_compile_cache(min_compile_time_secs=0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


@pytest.fixture
def gpu():
    """The first GPU device, or a skip. Tests that need the card take this
    fixture (and carry the ``gpu`` marker): the check runs when the test
    does, never while the module is imported."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda pytest -m gpu)")
    return devs[0]
