"""Test configuration: force a virtual 8-device CPU mesh and float64 tracing.

Tests run on CPU with 8 virtual XLA host devices so sharding paths can be
validated without real multi-GPU hardware; float64 is enabled for tight
adjoint/accuracy tolerances (the GPU production path runs float32, and
`python chip_smoke.py` checks it on the card).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(19940407)
