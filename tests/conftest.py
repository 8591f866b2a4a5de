"""Test configuration.

By default the tests run on the CPU with 8 virtual devices — the standard
JAX idiom for testing sharded (shard_map / pjit) code without several
accelerators; Pallas kernels run in interpret mode there.

Tests marked ``gpu`` need an NVIDIA card and skip elsewhere.  To run them
on the card, name the platform explicitly, which leaves the backend alone:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

import pytest

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided at run time, never
    at import, so every test worker collects the same tests)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; default device is {dev}")
    return dev
