"""Test configuration: an 8-virtual-device CPU mesh by default.

The suite runs on the CPU (`JAX_PLATFORMS=cpu`, the default here) with 8
host devices, so every shard_map/collective path is exercised without a
card. An explicitly set `JAX_PLATFORMS` is honoured, which is how the
tests marked `gpu` run on the card:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

A `gpu` test takes the `gpu_devices` fixture, which skips it (with the
reason) when JAX finds no GPU — decided inside the test, never while
collecting.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402  (import after env setup)
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


@pytest.fixture
def gpu_devices():
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX platform is "
                    f"{devs[0].platform} (run with JAX_PLATFORMS=cuda "
                    "-m gpu on the card)")
    return devs
