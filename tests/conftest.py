"""Test harness: force the CPU backend with 8 virtual devices.

``jax.config.update('jax_platforms', 'cpu')`` takes effect as long as it
happens before any array op. The 8-device virtual CPU mesh is the idiomatic
JAX analogue of a fake distributed backend (SURVEY.md §4): multi-device
sharding logic runs without a GPU.

Tests that need the GPU carry the ``gpu`` marker (pyproject.toml) and the
``gpu`` fixture below, which skips them when no GPU is present. They run on
the card with ``pytest -m gpu`` (README).
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
# Keeps the persistent compile cache off for the test run
# (plantcaduceus_tpu.compile_cache_dir): XLA:CPU entries would only be
# recompiled.
os.environ.setdefault("PCAD_PLATFORM", "cpu")

import jax  # noqa: E402

if os.environ["PCAD_PLATFORM"] == "cpu":
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is a GPU. Decided here,
    at run time, never while a module is imported."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with PCAD_PLATFORM=gpu)")
