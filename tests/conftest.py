"""Test harness configuration.

Tests run on a CPU-simulated 8-device mesh (the analogue of a fake backend —
SURVEY.md §4): sharding, psum, and scatter-merge logic is exercised in CI
without multi-GPU hardware. Must be set before the first jax import.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# in case a plugin imported jax before this file ran: as long as no backend
# is initialized yet, the config flip still wins over the env var
jax.config.update("jax_platforms", "cpu")
assert jax.devices()[0].platform == "cpu", (
    f"tests must run on the CPU mesh, got {jax.devices()}")
assert len(jax.devices()) == 8, "expected 8 virtual CPU devices"

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_CKPT = "/root/reference/nets/miccai2012_v1/miccai2012_v1.pkl"


@pytest.fixture(scope="session")
def reference_ckpt_path():
    if not os.path.exists(REFERENCE_CKPT):
        pytest.skip("reference checkpoint not available")
    return REFERENCE_CKPT


@pytest.fixture()
def rng():
    return np.random.default_rng(1234)
