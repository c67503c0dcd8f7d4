"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The platform is JAX_PLATFORMS when set, else the CPU, and is pinned in
the JAX config as well, so a site configuration cannot override it.
Tests that need a card carry the `gpu` marker and skip without one (the
`gpu_device` fixture decides, at run time).  On a GPU machine:

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu
"""
import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

# Note: x64 stays OFF — device math is float32 by design (utils/phase.py);
# all host-side precision-critical math uses numpy float64.

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test when there is none."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("needs a GPU (run on the card: pytest tests/ -m gpu)")
    return devs[0]
