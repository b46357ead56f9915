"""Block pipeline vs faithful per-sample serial port: semantic parity.

The strongest validation the rebuild has (SURVEY §6): the whole-capture
vectorized decode must reproduce the reference state machine's decisions
— sync index, per-code correlation argmaxes, Ghat (with identity bias),
equalized symbols — as produced by a direct per-sample reimplementation.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from rub_mimo_tpu.config import tiny_config
from rub_mimo_tpu.io import simulator
from rub_mimo_tpu.pipeline import rx
from tests.reference_serial import SerialFramesync


@pytest.fixture(scope="module", params=[(411, 23), (130, 4), (777, 91)])
def pair(request):
    delay, seed = request.param
    cfg = tiny_config(bit_exact=True)  # reference quirks on
    spec = simulator.ChannelSpec(snr_db=35.0, delay=delay, seed=seed)
    cap, tx_data, _ = simulator.simulate_capture(cfg, spec)
    cap_np = np.asarray(cap)

    serial = SerialFramesync(cfg)
    serial.execute(cap_np)

    block = rx.decode(jnp.asarray(cap_np), cfg, keep_debug=True)
    return cfg, serial, block


def test_sync_index_matches(pair):
    cfg, serial, block = pair
    assert serial.state == "MIMO_DONE"
    assert int(block.sync_index) == serial.sync_index


def test_metric_matches(pair):
    cfg, serial, block = pair
    m_serial = np.asarray(serial.metric_log, dtype=np.float32)
    m_block = np.asarray(block.metric)[:, : m_serial.shape[1]]
    ok = np.isfinite(m_serial)
    np.testing.assert_allclose(
        m_block[ok], m_serial[ok], rtol=5e-3, atol=5e-4
    )


def test_ac_index_matches(pair):
    cfg, serial, block = pair
    np.testing.assert_array_equal(np.asarray(block.ac_index), serial.ac_index)


def test_G_matches(pair):
    cfg, serial, block = pair
    np.testing.assert_allclose(
        np.asarray(block.G), serial.G, rtol=2e-3, atol=2e-4
    )


def test_equalized_symbols_match(pair):
    cfg, serial, block = pair
    ser_sym = np.stack(serial.decoded[: cfg.pid_max], axis=0)  # [n, S, occ]
    n = ser_sym.shape[0]
    blk = np.asarray(block.rx_sig).reshape(
        cfg.num_streams, cfg.pid_max, cfg.M_occupied
    ).transpose(1, 0, 2)[:n]
    np.testing.assert_allclose(blk, ser_sym, rtol=5e-3, atol=5e-3)


def test_siso_serial_parity():
    """execute_siso_decode semantics (framing.cc:508-533): the block
    pipeline's SISO path matches the per-sample port."""
    from rub_mimo_tpu.config import CommMode

    cfg = tiny_config(bit_exact=True, mode=CommMode.SISO, siso_tx=1,
                      siso_rx=1)
    spec = simulator.ChannelSpec(snr_db=35.0, delay=411, seed=23)
    cap, tx_data, _ = simulator.simulate_capture(cfg, spec)
    cap_np = np.asarray(cap)

    serial = SerialFramesync(cfg)
    serial.execute(cap_np)
    assert serial.state == "MIMO_DONE"

    block = rx.decode(jnp.asarray(cap_np), cfg)
    assert int(block.sync_index) == serial.sync_index
    ser_sym = np.stack(serial.decoded[: cfg.pid_max], axis=0)
    n = ser_sym.shape[0]
    blk = np.asarray(block.rx_sig).reshape(
        cfg.num_streams, cfg.pid_max, cfg.M_occupied
    ).transpose(1, 0, 2)[:n]
    np.testing.assert_allclose(blk, ser_sym, rtol=5e-3, atol=5e-3)


@pytest.mark.slow
def test_full_geometry_single_seed():
    """One serial-parity case at the REAL OFDM geometry (M=2048, CP=152,
    20 access codes; reduced frames keep the O(T*M) per-sample port
    tractable) — the block pipeline must reproduce the per-sample state
    machine's sync index, per-code argmaxes, and Ghat at full size, not
    just on tiny dims."""
    from rub_mimo_tpu.config import ModemConfig

    cfg = ModemConfig(pid_max=2, bit_exact=True)
    # enough trailing silence for the serial port's windowcf to FILL
    # (it triggers estimation only when the full window has been pushed,
    # framing.cc:639-651)
    spec = simulator.ChannelSpec(snr_db=35.0, delay=2311, seed=17,
                                 trailing=3 * cfg.symbol_len + cfg.window_len
                                 - (41 + cfg.pid_max) * cfg.symbol_len)
    cap, tx_data, _ = simulator.simulate_capture(cfg, spec)
    cap_np = np.asarray(cap)

    serial = SerialFramesync(cfg)
    serial.execute(cap_np)
    assert serial.state == "MIMO_DONE"

    block = rx.decode(jnp.asarray(cap_np), cfg)
    assert int(block.sync_index) == serial.sync_index
    np.testing.assert_array_equal(np.asarray(block.ac_index),
                                  serial.ac_index)
    np.testing.assert_allclose(np.asarray(block.G), serial.G,
                               rtol=2e-3, atol=2e-4)
    dec = np.stack(serial.decoded, axis=0)  # [n_sym, S, m_occ]
    n_sym = dec.shape[0]
    m_occ = cfg.M_occupied
    got = np.asarray(block.rx_sig).reshape(
        cfg.num_streams, cfg.pid_max, m_occ)[:, :n_sym]
    want = dec.transpose(1, 0, 2)[:, : cfg.pid_max]
    got = got[:, : want.shape[1]]
    np.testing.assert_allclose(got, want[:, : got.shape[1]], rtol=4e-3,
                               atol=4e-3)
