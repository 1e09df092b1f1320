"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-device sharding tests use the virtual CPU devices.  Tests marked
`gpu` need an NVIDIA GPU and skip elsewhere (the `gpu` fixture decides
while the test runs); `chip_smoke.py` runs them on the card with
VST_TEST_GPU=1, which keeps this file from pinning JAX to the CPU.
"""

import os

# Must be set before jax initializes its backends.
if not os.environ.get("VST_TEST_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if not os.environ.get("VST_TEST_GPU"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; the test skips where JAX has none."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs these tests "
                    "on the card)")
    return devices[0]
