"""Test harness: the CPU backend with 8 virtual devices, so sharding
paths run without GPUs.

Tests of code that runs only on the card (the CUDA extension kernel has
no interpret mode) carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them when no GPU is present; chip_smoke.py runs the
same comparisons on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# JAX_PLATFORMS=cuda,cpu lets the gpu-marked tests reach a card
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from aligngraph2_tpu.utils.compile_cache import enable_compile_cache  # noqa

enable_compile_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips on the CPU)")


@pytest.fixture
def gpu():
    """Skip unless a GPU backend is present."""
    try:
        jax.devices("gpu")
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py covers it there")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
