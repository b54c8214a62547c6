"""Test configuration: the CPU backend with 8 virtual devices by default.

Multi-device sharding is validated on a virtual host-platform mesh.  An
explicit ``JAX_PLATFORMS`` wins over the CPU default, so the chip-marked
tests run on the card with ``JAX_PLATFORMS=cuda python -m pytest -m chip``.
``XLA_FLAGS`` must be set before the first backend use.
"""

import os
import sys

import pytest

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)


@pytest.fixture
def gpu():
    """The GPU device for a ``chip``-marked test; skips where there is none.
    Decided here, at run time, never while a module is imported, so every
    test worker collects the same tests."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is "
                    f"{devices[0].platform!r}")
    return devices[0]
