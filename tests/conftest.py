"""Test configuration: CPU backend, float64, 8 virtual devices for sharding
tests.  ``PCX_TEST_PLATFORM=gpu`` keeps the default device instead, for the
`gpu`-marked tests on the card (`PCX_TEST_PLATFORM=gpu python -m pytest
tests/ -m gpu`)."""

import os

_PLATFORM = os.environ.get("PCX_TEST_PLATFORM", "cpu")
if _PLATFORM == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"  # tests run on (virtual-8) CPU
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

# Something may import jax before this conftest (pytest plugins), in which
# case the env vars above are too late — force via config as well.
if _PLATFORM == "cpu":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """The default device, when it is a GPU; skips otherwise (decided here,
    at run time, so every xdist worker collects the same tests)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (default device: {dev.platform})")
    return dev
