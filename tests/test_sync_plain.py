"""synchronize() — the coarse+refine path and the full chunked scan —
against the per-sample serial port of the reference's sync state machine
(tests/reference_serial.py, framing.cc:591-637)."""

import numpy as np
import jax.numpy as jnp
import pytest

from rub_mimo_tpu.config import CommMode, Modulation, tiny_config
from rub_mimo_tpu.io import simulator
from rub_mimo_tpu.sync import schmidl_cox
from tests.reference_serial import SerialFramesync


def _serial_sync(cfg, cap):
    """Run only the serial SEEK_PLATEAU state: (fired, sync_index,
    fire sample, plateau starts)."""
    ser = SerialFramesync(cfg)
    cap = np.asarray(cap)
    for t in range(cap.shape[1]):
        ser._seek_plateau(cap[:, t])
        if ser.state != "SEEK_PLATEAU":
            return True, ser.sync_index, t, ser.plateau_start.copy()
        ser.num_samples_processed += 1
    return False, 0, 0, None


def _check(cfg, cap, impl, block):
    fired, sidx, t, starts = _serial_sync(cfg, cap)
    r = schmidl_cox.synchronize(jnp.asarray(cap), cfg, impl=impl,
                                block=block)
    assert bool(r.synced) == fired
    if fired:
        assert int(r.sync_index) == sidx
        assert int(r.sync_sample) == t
        np.testing.assert_array_equal(np.asarray(r.plateau_start), starts)
    return r


@pytest.mark.parametrize("impl", ["coarse", "xla"])
@pytest.mark.parametrize(
    "delay,snr,block", [(501, 35.0, 512), (130, 30.0, 512),
                        (2000, 25.0, 1024), (64, 35.0, 256)]
)
def test_synchronize_matches_serial(delay, snr, block, impl):
    cfg = tiny_config(bit_exact=False)
    spec = simulator.ChannelSpec(snr_db=snr, delay=delay, seed=11)
    cap, _, _ = simulator.simulate_capture(cfg, spec)
    r = _check(cfg, cap, impl, block)
    assert bool(r.synced)


@pytest.mark.parametrize("impl", ["coarse", "xla"])
def test_synchronize_no_fire(impl):
    """Noise only: no sync, with the no-fire defaults (t*=0, run starts
    at 1) on every path."""
    cfg = tiny_config(bit_exact=False)
    rng = np.random.default_rng(0)
    cap = (0.01 * (rng.standard_normal((2, 4096))
                   + 1j * rng.standard_normal((2, 4096)))).astype(np.complex64)
    r = _check(cfg, cap, impl, 512)
    assert not bool(r.synced)
    assert int(r.sync_sample) == 0
    np.testing.assert_array_equal(np.asarray(r.plateau_start), [1, 1])


@pytest.mark.parametrize("impl", ["coarse", "xla"])
def test_synchronize_siso_single_stream(impl):
    cfg = tiny_config(
        bit_exact=False, num_streams=1, mode=CommMode.SISO,
        siso_tx=0, siso_rx=0, modulation=Modulation.QPSK,
        plateau_threshold=0.5,
    )
    spec = simulator.ChannelSpec(snr_db=30.0, delay=333, seed=5,
                                 identity=True)
    cap, _, _ = simulator.simulate_capture(cfg, spec)
    r = _check(cfg, cap, impl, 512)
    assert bool(r.synced)
