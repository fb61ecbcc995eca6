"""Test environment: JAX on a virtual 8-device CPU mesh unless the caller
chose a platform.

The default test run uses the CPU backend with 8 virtual devices (mesh,
batch and sharding tests rehearse multi-card paths there).
Tests marked ``gpu`` need a card: run them with the platform chosen
explicitly, e.g. ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py``;
they skip (inside their fixture) on any other backend.
"""

import os

import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")


@pytest.fixture
def gpu():
    """The GPU device, or skip: decided when the test runs, never at import."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX's default device is {dev.platform})")
    return dev
