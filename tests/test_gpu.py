"""GPU-only checks: the float32 decision paths give the CPU's answers.

Every test takes the ``gpu`` fixture, so on a machine without a GPU it
skips with a reason.  ``python chip_smoke.py`` runs this file on the card
(in its own process, no xdist)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rub_mimo_tpu.config import Detector, Modulation, tiny_config
from rub_mimo_tpu.io import simulator
from rub_mimo_tpu.ofdm import constellation, fec
from rub_mimo_tpu.pipeline import rx
from rub_mimo_tpu.sync import schmidl_cox


def _on(x, dev):
    return jax.device_put(x, dev)


@pytest.mark.gpu
@pytest.mark.parametrize("mod", list(Modulation))
def test_demodulate_matches_float64_nearest(gpu, mod):
    """Hard demap on the card == float64 brute-force nearest neighbour
    wherever the float64 margin between the two nearest points exceeds
    float32 resolution (TF32 scores would fail this)."""
    rng = np.random.default_rng(3)
    tab = constellation.table(mod).astype(np.complex128)
    pts = tab[rng.integers(0, len(tab), 200_000)]
    y = pts + 0.3 * np.abs(tab).mean() * (
        rng.standard_normal(pts.shape) + 1j * rng.standard_normal(pts.shape))
    d2 = np.abs(y[:, None] - tab[None, :]) ** 2
    srt = np.sort(d2, axis=1)
    safe = (srt[:, 1] - srt[:, 0]) > 1e-5
    want = np.argmin(d2, axis=1)
    got = np.asarray(constellation.demodulate(
        _on(y.astype(np.complex64), gpu), mod))
    assert safe.mean() > 0.99
    np.testing.assert_array_equal(got[safe], want[safe])


@pytest.mark.gpu
@pytest.mark.parametrize("tile_aligned", [False, True])
def test_coarse_block_sums_match_cpu(gpu, tile_aligned):
    cpu = jax.devices("cpu")[0]
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 1 << 16))
         + 1j * rng.standard_normal((2, 1 << 16))).astype(np.complex64)
    M2, D = 1024, 64
    nD = x.shape[1] // D
    f = jax.jit(lambda v: schmidl_cox.coarse_block_sums(
        v, M2, nD, D, tile_aligned))
    p_g, e_g = f(_on(x, gpu))
    p_c, e_c = f(_on(x, cpu))
    # float32 sums of 64 terms in a different order: a few ulps
    np.testing.assert_allclose(np.asarray(p_g), np.asarray(p_c),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(e_g), np.asarray(e_c),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "detector", [Detector.ZF, Detector.MMSE, Detector.ML, Detector.SIC])
@pytest.mark.parametrize("sync_impl", ["coarse", "xla"])
def test_tiny_decode_matches_cpu(gpu, detector, sync_impl):
    cpu = jax.devices("cpu")[0]
    cfg = tiny_config(bit_exact=False, detector=detector,
                      mmse_noise_var=1e-3)
    cap, tx, _ = simulator.simulate_capture(
        cfg, simulator.ChannelSpec(snr_db=30.0, delay=501, seed=11))
    cap = np.asarray(cap)
    dec = jax.jit(lambda v: rx.decode(v, cfg, sync_impl=sync_impl))
    rg, rc = dec(_on(cap, gpu)), dec(_on(cap, cpu))
    for k in ("synced", "sync_index", "ac_index", "decode_start",
              "rx_data"):
        np.testing.assert_array_equal(np.asarray(getattr(rg, k)),
                                      np.asarray(getattr(rc, k)), err_msg=k)
    np.testing.assert_allclose(np.asarray(rg.G), np.asarray(rc.G),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_soft_viterbi_matches_cpu(gpu):
    cpu = jax.devices("cpu")[0]
    cfg = tiny_config(bit_exact=False)
    msg, txd = fec.encode_payload(cfg, seed=1)
    cap, _, _ = simulator.simulate_capture(
        cfg, simulator.ChannelSpec(snr_db=12.0, delay=300, seed=2),
        tx_data=txd, payload_seed=1)
    rx_sig = rx.decode(jnp.asarray(cap), cfg).rx_sig
    f = jax.jit(lambda s: fec.decode_payload(s, cfg))
    bits_g = np.asarray(f(_on(np.asarray(rx_sig), gpu)))
    bits_c = np.asarray(f(_on(np.asarray(rx_sig), cpu)))
    np.testing.assert_array_equal(bits_g, bits_c)
