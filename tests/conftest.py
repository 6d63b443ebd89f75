"""Test configuration: the CPU backend with 8 virtual devices.

Tests run on the CPU (``JAX_PLATFORMS=cpu``, the default set here);
multi-device sharding runs on virtual CPU devices
(xla_force_host_platform_device_count). Tests that need an NVIDIA GPU
carry the ``gpu`` marker and take the ``gpu`` fixture, which skips them
on any other backend; on a card they run with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``, and
``python chip_smoke.py`` drives the same paths end to end.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips on other backends)"
    )


@pytest.fixture
def gpu():
    """The first GPU device; skips the test on any other backend. The
    decision is taken here, at run time, never at import or collection
    time, so every worker collects the same tests."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; running on {dev.platform}")
    return dev
