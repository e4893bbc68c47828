"""Test config: run JAX on CPU with 8 virtual devices (a stand-in for a
multi-device backend, SURVEY.md §4) and enable x64 so golden tests
against the NumPy oracle match at tight tolerance.

Tests marked ``gpu`` need a GPU; the ``gpu`` fixture skips them
elsewhere. The suite is pinned to the CPU unless ``JAX_PLATFORMS`` names
the platforms, so on a GPU host ``JAX_PLATFORMS=cuda,cpu pytest -m gpu``
runs them (see the README)."""

import os

import re as _re

flags = os.environ.get("XLA_FLAGS", "")
# replace (not just append) any pre-existing device-count flag: a
# leftover =4 from a dryrun experiment would silently break the
# 8-virtual-device suite
flags = _re.sub(r"--xla_force_host_platform_device_count=\d+", "", flags)
os.environ["XLA_FLAGS"] = (
    flags + " --xla_force_host_platform_device_count=8"
).strip()

import jax

import pytest

# CPU unless JAX_PLATFORMS says otherwise
if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache (JAX_COMPILATION_CACHE_DIR when set, else
# <checkout>/.jax_cache): the suite is compile-bound (hundreds of
# distinct jitted shapes), and repeat runs should not pay XLA again. The
# zeroed thresholds below cache every entry.
from onmf_ontf_ndl_tpu.utils.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none. Decided
    here, when a test runs, never while a module is imported."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU")
    return devs[0]
