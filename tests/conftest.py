"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-card sharding is validated on virtual CPU devices
(``xla_force_host_platform_device_count``); the same sharded programs run
unchanged on a multi-GPU host.  ``JAX_PLATFORMS`` set by the caller wins, so
the card-only tests run on a GPU machine with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``; everywhere else they
skip (the ``gpu_device`` fixture decides, at run time).
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE_ROOT = "/root/reference"


def reference_available() -> bool:
    return os.path.isdir(REFERENCE_ROOT)


@pytest.fixture
def gpu_device():
    """The first GPU JAX sees; skips the test where there is none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA card; JAX's first device is {dev.platform}")
    return dev
