"""Test harness config: run everything on a virtual 8-device CPU mesh.

Multi-device sharding paths are exercised without an accelerator by
forcing the CPU platform with 8 virtual devices (SURVEY §4 test-strategy).
Must run before jax is imported anywhere.  Tests that need the GPU carry
the ``gpu`` marker and skip here (see the ``gpu`` fixture).
"""

import os
import sys

# CPU unless the caller chose a platform (chip_smoke.py runs the
# gpu-marked tests in its own process, whose backend is already up)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

# Persistent compilation cache: the suite is XLA-compile-dominated, so
# repeat runs drop sharply once executables are cached on disk.
from rub_mimo_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from rub_mimo_tpu.config import ModemConfig, Modulation, tiny_config  # noqa: E402


@pytest.fixture(scope="session")
def tcfg() -> ModemConfig:
    """Small 2x2 config used across tests."""
    return tiny_config()


@pytest.fixture(scope="session")
def rng() -> np.random.Generator:
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none.  Decided
    here, at run time, never while a module is imported."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (run: python chip_smoke.py)")
    return devs[0]
