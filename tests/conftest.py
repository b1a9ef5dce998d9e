"""Test configuration: an 8-device virtual CPU platform.

The suite runs on the CPU for determinism and to exercise the multi-device
sharding paths on a virtual mesh (SURVEY.md section 4); the Pallas kernels
run in the interpreter there:

    JAX_PLATFORMS=cpu python -m pytest tests/ -m 'not slow'

Tests that need the GPU carry the `gpu` marker and take the `gpu` fixture,
which skips them here; `python chip_smoke.py` runs the same checks on the
card (`--four` for four cards).
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax
import pytest

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavy tests (dense goldens, distributed suites). Fast edit "
        "loop: pytest -m 'not slow'; the FULL suite is the pre-commit gate.")
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; skipped elsewhere (the `gpu` fixture "
        "decides at run time). chip_smoke.py runs these checks on the card.")


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX platform here is {dev.platform!r}")
    return dev
