"""Test configuration.

Tests run on the CPU backend with 8 virtual devices, so that the mesh
paths are exercised without accelerators.  ``JAX_PLATFORMS`` names
another backend when one is wanted: on a GPU machine

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu

runs the tests marked ``gpu``, which skip everywhere else.  XLA_FLAGS is
read lazily at backend-client creation, so setting it here works as
long as no computation ran yet.
"""

import os

import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU (decided at run time)."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs a GPU; JAX found {platform}")
