"""Test harness setup: JAX on the CPU with a virtual 8-device mesh.

All sharding paths run on a virtual 8-device CPU mesh, set up here before
JAX initializes.  ``JAX_PLATFORMS`` defaults to ``cpu``; the GPU checks of
tests/test_chip.py (marker ``chip``) run on the card with
``JAX_PLATFORMS=cuda,cpu`` and skip everywhere else.
"""

import os
import pathlib

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import pytest  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
ASSETS = REPO / "assets"


@pytest.fixture(scope="session")
def assets() -> pathlib.Path:
    return ASSETS
