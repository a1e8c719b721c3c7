"""Test harness config.

CPU runs (``JAX_PLATFORMS=cpu``) get an 8-device virtual mesh: XLA's host
platform is forced to expose 8 devices, so sharding tests exercise real
collectives without a cluster (SURVEY.md §4).  Tests marked ``gpu`` need the
card; the ``gpu`` fixture skips them elsewhere (run them with
``pytest -m gpu`` on a GPU host).
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_threefry_partitionable", True)


@pytest.fixture
def gpu():
    """Skip unless JAX's backend is the GPU (decided when the test runs, so
    every pytest worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (compiled Triton kernels)")
