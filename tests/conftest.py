import os

import pytest

# Tests run on a virtual 8-device CPU mesh so sharding logic is exercised
# without accelerator hardware; chip_smoke.py runs the same paths on a GPU.
# The platform is pinned through jax.config (wins over the environment).
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none (tests
    marked `gpu`). Decided when the test runs, never at import time."""
    try:
        devs = jax.devices("cuda")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    return devs[0]
