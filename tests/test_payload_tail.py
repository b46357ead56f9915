"""The payload tail (CP strip + FFT + equalize + demap) is plain XLA: it
must reproduce a numpy FFT + ZF/MMSE + nearest-neighbour chain, decode
every geometry end to end, and refuse implementation names and options
that no longer exist."""

import jax.numpy as jnp
import numpy as np
import pytest

from rub_mimo_tpu.config import Detector, ModemConfig, Modulation
from rub_mimo_tpu.detect import mmse, zf
from rub_mimo_tpu.io import simulator
from rub_mimo_tpu.ofdm import constellation
from rub_mimo_tpu.parallel import decode_sharded
from rub_mimo_tpu.pipeline import report, rx
from rub_mimo_tpu.sync import schmidl_cox
from rub_mimo_tpu.utils import impl_select


def _numpy_tail(x, W, gain, tab, norm):
    """x [S, n_sym, M] time-domain symbols -> (rx_sig, rx_data) in
    float64 numpy: FFT, per-subcarrier W @ y * gain, nearest point."""
    S, n_sym, M = x.shape
    X = np.fft.fft(x.astype(np.complex128), axis=-1) * norm
    eq = np.einsum("kor,rnk->onk", W.astype(np.complex128), X) \
        * gain[None, None, :]
    sig = eq.reshape(S, n_sym * M)
    d2 = np.abs(sig[..., None] - tab[None, None, :]) ** 2
    return sig, np.argmin(d2, axis=-1), np.sort(d2, axis=-1)


@pytest.mark.parametrize("detector", [Detector.ZF, Detector.MMSE])
@pytest.mark.parametrize("n_sym", [8, 37])
def test_xla_tail_matches_numpy(n_sym, detector):
    rng = np.random.default_rng(3)
    S, M = 2, 2048
    G = (rng.normal(size=(M, S, S))
         + 1j * rng.normal(size=(M, S, S))).astype(np.complex64)
    if detector == Detector.ZF:
        W, gain = zf.invert(jnp.asarray(G))
    else:
        W, gain = mmse.mmse_weights(jnp.asarray(G), 1e-2)
    tab = constellation.table(Modulation.ARB32OPT)
    norm = np.float32(1.0 / np.sqrt(M))
    # transmit known symbols through G so the decisions are meaningful
    sym = rng.integers(0, len(tab), (S, n_sym, M))
    Xtx = tab[sym].astype(np.complex128)
    Xrx = np.einsum("krt,tnk->rnk", G, Xtx)
    x = (np.fft.ifft(Xrx, axis=-1) / norm).astype(np.complex64)

    Xf = jnp.fft.fft(jnp.asarray(x), axis=-1) * norm
    Y = jnp.moveaxis(Xf, 1, 0)
    eq = zf.equalize(Y, W, gain)
    sig = jnp.moveaxis(eq, 0, 1).reshape(S, n_sym * M)
    data = constellation.demodulate(sig, Modulation.ARB32OPT)

    ref_sig, ref_data, d2 = _numpy_tail(
        x, np.asarray(W), np.asarray(gain), tab.astype(np.complex128), norm)
    np.testing.assert_allclose(np.asarray(sig), ref_sig, rtol=0, atol=5e-3)
    safe = (d2[..., 1] - d2[..., 0]) > 1e-3
    np.testing.assert_array_equal(np.asarray(data)[safe], ref_data[safe])


_GEOMETRIES = {
    "M2048_all": dict(),
    "M1024_all": dict(num_subcarriers=1024, cp_len=76),
    "M2048_guard": dict(use_all_carriers=False),
    "M64_small": dict(num_subcarriers=64, cp_len=16, num_access_codes=4),
    "M256_qam256": dict(num_subcarriers=256, cp_len=32, num_access_codes=6,
                        modulation=Modulation.QAM256),
}


@pytest.mark.parametrize("geom", list(_GEOMETRIES))
def test_decode_geometry_ser_zero(geom):
    """Every geometry the payload tail serves decodes its payload exactly
    at high SNR."""
    cfg = ModemConfig(pid_max=6, bit_exact=False, **_GEOMETRIES[geom])
    snr = 45.0 if cfg.modulation == Modulation.QAM256 else 30.0
    spec = simulator.ChannelSpec(snr_db=snr, delay=2000, seed=9)
    capture, tx_data, _ = simulator.simulate_capture(cfg, spec)
    r = rx.decode(jnp.asarray(capture), cfg)
    assert bool(r.synced)
    n = cfg.pid_max * cfg.M_occupied
    errs = int(np.sum(np.asarray(r.rx_data)[:, :n]
                      != np.asarray(tx_data)[:, :n]))
    assert errs == 0


def test_decode_with_cfo_residual():
    """The residual-CFO rotation of the payload keeps SER 0."""
    cfg = ModemConfig(pid_max=12, bit_exact=False, correct_cfo=True)
    spec = simulator.ChannelSpec(snr_db=30.0, delay=3000,
                                 cfo_subcarriers=0.12)
    capture, tx_data, _ = simulator.simulate_capture(cfg, spec)
    r = rx.decode(jnp.asarray(capture), cfg)
    rep = report.score(r, tx_data, cfg)
    assert rep.symbol_error_rate == [0.0, 0.0]


def test_report_scoring_of_decode():
    """report.score reads the natural-order flat outputs directly."""
    cfg = ModemConfig(pid_max=12, bit_exact=False)
    spec = simulator.ChannelSpec(snr_db=30.0, delay=3000, seed=7)
    capture, tx_data, _ = simulator.simulate_capture(cfg, spec)
    r = rx.decode(jnp.asarray(capture), cfg)
    assert r.rx_data.shape == (cfg.num_streams,
                               cfg.pid_max * cfg.M_occupied)
    rep = report.score(r, tx_data, cfg)
    assert rep.synced and rep.symbol_error_rate == [0.0, 0.0]
    assert all(e < 5.0 for e in rep.evm_percent)


@pytest.mark.parametrize("point", sorted(impl_select.FALLBACKS))
def test_auto_impl_on_gpu_is_the_fallback(point):
    """The table holds no GPU row, so "auto" on the GPU takes the plain
    XLA fallback of every dispatch point."""
    impl_select.best_impl.cache_clear()
    assert impl_select.best_impl(point, "gpu") == impl_select.FALLBACKS[point]


@pytest.mark.parametrize("entry,option", [
    (rx.decode, "payload_impl"),
    (rx.make_decoder, "payload_impl"),
    (rx.make_serving_decoder, "payload_impl"),
    (decode_sharded.build_sharded_decoder, "halo_impl"),
])
def test_removed_options_are_rejected(entry, option):
    """The options that only chose a removed kernel are gone: passing one
    fails instead of being ignored."""
    with pytest.raises(TypeError, match=option):
        entry(**{option: "xla"})


@pytest.mark.parametrize("point,name", [
    ("sync", "pallas"),
    ("cpstrip", "pallas"),
    ("window", "dynwin"),
])
def test_removed_impl_names_raise(point, name):
    with pytest.raises(ValueError, match=name):
        impl_select.check_impl(point, name)


def test_removed_names_raise_through_entry_points(tcfg):
    cap = jnp.zeros((tcfg.num_streams, 4096), jnp.complex64)
    with pytest.raises(ValueError, match="pallas"):
        schmidl_cox.synchronize(cap, tcfg, impl="pallas")
    with pytest.raises(ValueError, match="pallas"):
        rx.strip_cp(cap, 4, tcfg.symbol_len, tcfg.cp_len, impl="pallas")
    with pytest.raises(ValueError, match="dynwin"):
        rx.extract_payload(cap, jnp.int32(0), 100, impl="dynwin")
