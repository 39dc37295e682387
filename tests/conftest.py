"""Test harness: run everything on a virtual 8-device CPU mesh.

Must set the env *before* jax is imported anywhere in the test process —
pytest imports this conftest before any test module.  The suite always runs
on the CPU, also on a machine with a GPU; ``python3 chip_smoke.py`` drives
the same paths on the card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def devices():
    return jax.devices()
