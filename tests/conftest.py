"""Test configuration: force the CPU backend with 8 virtual devices so
sharding/pjit logic is exercised without an accelerator."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# jax may already be imported (and pointed at an accelerator) — force the
# CPU backend explicitly.
jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


REFERENCE_DATA = "/root/reference/data"
REFERENCE_RESULTS = "/root/reference/results"


@pytest.fixture(scope="session")
def data_root():
    if not os.path.isdir(REFERENCE_DATA):
        pytest.skip("reference dataset not available")
    return REFERENCE_DATA


@pytest.fixture(scope="session")
def golden_root():
    if not os.path.isdir(REFERENCE_RESULTS):
        pytest.skip("reference goldens not available")
    return REFERENCE_RESULTS


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
