"""Test configuration: the CPU backend with an 8-device virtual mesh.

JAX_PLATFORMS defaults to cpu here; the card's own tests (marker `gpu`)
run on the chip with `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`.
xla_force_host_platform_device_count must be set before the CPU client
initializes, so it is set at import.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Bound the process-wide compiled-executable accumulation: a full-suite
    run holds hundreds of jitted programs otherwise (an XLA CPU compile
    late in the suite has been seen to segfault under that state)."""
    yield
    jax.clear_caches()


@pytest.fixture
def gpu():
    """The card, for tests marked `gpu`; skips where JAX has no GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX has {dev.platform}")
    return dev
