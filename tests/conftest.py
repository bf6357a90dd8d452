"""Test configuration: CPU with a virtual 8-device mesh.

The tests run on the CPU for determinism, and multi-device sharding is
exercised on 8 virtual devices.  Tests marked ``gpu`` need a CUDA device
and skip without one (decided in the ``gpu`` fixture, never at import).
"""
import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()


@pytest.fixture
def gpu():
    """The first CUDA device; skips the test where there is none."""
    import jax
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a CUDA GPU")
    return devices[0]
