"""The Schmidl&Cox metric and the hard demapper against plain float64
numpy references."""

import numpy as np
import jax.numpy as jnp
import pytest

from rub_mimo_tpu.config import Modulation
from rub_mimo_tpu.ofdm import constellation
from rub_mimo_tpu.sync import schmidl_cox


def _metric_f64(x: np.ndarray, M: int) -> np.ndarray:
    """framing.cc:626-637 in float64: corr over M/2 delayed products,
    energy 0.5 * sum |x|^2 over M, zero history before t=0."""
    M2 = M // 2
    x = x.astype(np.complex128)
    xd = np.concatenate([np.zeros((x.shape[0], M2)), x[:, :-M2]], axis=1)
    prod = np.conj(xd) * x
    cs_p = np.cumsum(np.pad(prod, ((0, 0), (M2, 0))), axis=1)
    corr = -(cs_p[:, M2:] - cs_p[:, :-M2])
    e = np.abs(x) ** 2
    cs_e = np.cumsum(np.pad(e, ((0, 0), (M, 0))), axis=1)
    energy = 0.5 * (cs_e[:, M:] - cs_e[:, :-M])
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.abs(corr) ** 2 / energy ** 2


@pytest.mark.parametrize("T,block", [(1000, 64), (777, 128)])
def test_sc_metric_matches_float64(T, block):
    M = 32
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, T))
         + 1j * rng.standard_normal((2, T))).astype(np.complex64)
    got, _ = schmidl_cox.sc_metric(jnp.asarray(x), M, block=block)
    want = _metric_f64(x, M)
    got = np.asarray(got)
    ok = np.isfinite(want) & (np.arange(T) >= M)[None, :]
    np.testing.assert_allclose(got[ok], want[ok], rtol=2e-3, atol=1e-4)


def test_sc_metric_detects_preamble():
    from rub_mimo_tpu.config import tiny_config
    from rub_mimo_tpu.io import simulator

    cfg = tiny_config()
    spec = simulator.ChannelSpec(snr_db=30.0, delay=300, seed=5)
    cap, _, _ = simulator.simulate_capture(cfg, spec)
    metric, _ = schmidl_cox.sc_metric(cap, cfg.M, block=256)
    synced, t_star, starts, _ = schmidl_cox.plateau_scan(
        metric, cfg.cp_len, cfg.plateau_threshold
    )
    assert bool(synced)
    # the plateau starts inside the S0 preamble after the 300-sample delay
    assert 300 <= int(np.min(np.asarray(starts))) < 300 + 2 * cfg.symbol_len


@pytest.mark.parametrize("mod", list(Modulation))
def test_demodulate_matches_brute_force(mod):
    """constellation.demodulate == float64 argmin |y - c|^2 wherever the
    two nearest points are separable at float32 resolution."""
    rng = np.random.default_rng(5)
    tab = constellation.table(mod).astype(np.complex128)
    y = tab[rng.integers(0, len(tab), 20_000)]
    y = y + 0.4 * np.abs(tab).mean() * (
        rng.standard_normal(y.shape) + 1j * rng.standard_normal(y.shape))
    d2 = np.abs(y[:, None] - tab[None, :]) ** 2
    srt = np.sort(d2, axis=1)
    safe = (srt[:, 1] - srt[:, 0]) > 1e-5
    want = np.argmin(d2, axis=1)
    got = np.asarray(constellation.demodulate(
        jnp.asarray(y.astype(np.complex64).reshape(4, -1)), mod)).reshape(-1)
    assert safe.mean() > 0.99
    np.testing.assert_array_equal(got[safe], want[safe])
