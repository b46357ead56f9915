"""The driver's entry points must compile and run on the virtual CPU mesh."""

import sys
from pathlib import Path

import jax

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import __graft_entry__ as graft  # noqa: E402


def test_dryrun_multichip_8():
    graft.dryrun_multichip(8)


def test_dryrun_multichip_2():
    graft.dryrun_multichip(2)


def test_entry_compiles_tiny():
    # entry() builds the full-size config; compile-check the same fn shape
    # on the CPU by evaluating it abstractly only (full eval is the
    # driver's job on real hardware)
    fn, args = graft.entry()
    jitted = jax.jit(fn)
    lowered = jitted.lower(*args)
    assert lowered is not None


import pytest  # noqa: E402


@pytest.mark.slow
def test_dryrun_multichip_8_full_geometry():
    """The sharded program at the REAL OFDM geometry (M=2048, CP=152,
    20 access codes, reduced frames) must compile and sync on the
    8-way virtual mesh."""
    graft.dryrun_multichip(8, full_geometry=True)
