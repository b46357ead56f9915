"""Live (per-chunk) SFO correction in the streaming decoder.

Carry resampler fractional phase across chunks so
--sfo-correct works live.  The StreamingResampler keeps a continuous
input-position cursor (the carried fractional phase); the decoder
accumulates the offline estimator's frame-differential moment on device
and engages/retunes the resampler at burst re-arm boundaries.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from rub_mimo_tpu.config import Modulation, tiny_config
from rub_mimo_tpu.estimate import sfo as sfo_mod
from rub_mimo_tpu.io import simulator
from rub_mimo_tpu.ofdm import framegen
from rub_mimo_tpu.pipeline import streaming
from rub_mimo_tpu.utils.resample import (
    StreamingResampler, resample_bandlimited,
)


def test_streaming_resampler_matches_offline():
    """Chunked resampling with carried phase must match the whole-capture
    resampler away from window edges (mid-band tones, <1% amplitude)."""
    T, C = 16384, 1024
    t = np.arange(T)
    f = 1.0 + 100e-6
    x = sum(
        np.exp(2j * np.pi * nu * t) for nu in (82 / T, 2458 / T, 6100 / T)
    ).astype(np.complex64)[None, :]
    ref = np.asarray(resample_bandlimited(jnp.asarray(x), f))
    sr = StreamingResampler(1, C, factor=f)
    outs = []
    for i in range(T // C):
        outs += sr.push(x[:, i * C : (i + 1) * C])
    outs += sr.flush()
    y = np.concatenate([np.asarray(o) for o in outs], axis=-1)[:, :T]
    err = np.abs(y[0, 100 : T - 3000] - ref[0, 100 : T - 3000]).max()
    assert err < 0.01, err


def test_streaming_resampler_origin_and_preload():
    """Mid-stream takeover: with `origin` set and raw history preloaded,
    the first outputs interpolate real samples (no zero-window edge)."""
    T, C = 8192, 512
    t = np.arange(T)
    f = 1.0 - 100e-6
    nu = 642 / T
    x = np.exp(2j * np.pi * nu * t).astype(np.complex64)[None, :]
    origin = 2048
    sr = StreamingResampler(1, C, factor=f, origin=origin)
    for g in range(origin - 2 * C, origin, C):
        sr.preload_history(x[:, g : g + C], g)
    outs = []
    for g in range(origin, T, C):
        outs += sr.push(x[:, g : g + C])
    outs += sr.flush()
    y = np.concatenate([np.asarray(o) for o in outs], axis=-1)
    n = np.arange(origin, origin + y.shape[-1])
    q = origin + (n - origin) * f
    want = np.exp(2j * np.pi * nu * q)
    m = T - origin - 2000
    assert np.abs(y[0, :200] - want[:200]).max() < 0.01  # seam clean
    assert np.abs(y[0, :m] - want[:m]).max() < 0.01


def test_streaming_resampler_set_factor_continuity():
    """Retuning the factor mid-stream must not jump the position cursor:
    the output stays continuous through the change."""
    T, C = 8192, 1024
    t = np.arange(T)
    nu = 300 / T
    x = np.exp(2j * np.pi * nu * t).astype(np.complex64)[None, :]
    sr = StreamingResampler(1, C, factor=1.0 + 200e-6)
    outs, meta = [], []

    def _push(chunk):
        q0, f0 = sr._q, sr.factor
        new = sr.push(chunk)
        for k in range(len(new)):
            meta.append((q0 + k * C * f0, f0))
        outs.extend(new)

    for i in range(T // C):
        if i == 4:
            sr.set_factor(1.0 - 200e-6)
        _push(x[:, i * C : (i + 1) * C])
    q0, f0 = sr._q, sr.factor
    fl = sr.flush()
    for k in range(len(fl)):
        meta.append((q0 + k * C * f0, f0))
    outs.extend(fl)

    y = np.concatenate([np.asarray(o) for o in outs], axis=-1)[0]
    # expected positions from the recorded cursor snapshots: the cursor
    # must be CONTINUOUS across the factor change (no position jump)
    q = np.concatenate([qk + np.arange(C) * fk for qk, fk in meta])
    assert (np.diff(q) > 0).all()
    assert np.abs(np.diff(q) - 1.0).max() < 1e-3  # no jump at the retune
    want = np.exp(2j * np.pi * nu * q)
    m = slice(100, T - 2000)
    assert np.abs(y[m] - want[m]).max() < 0.01


def _three_burst_capture(cfg, ppm):
    spec = simulator.ChannelSpec(
        snr_db=35.0, delay=0, trailing=0, seed=3, sfo_ppm=ppm
    )
    h = simulator.draw_channel(spec, 2, 2)
    ds = [framegen.generate_payload_symbols(cfg, seed=s) for s in (1, 2, 3)]
    txs = [framegen.transmit_frame(cfg, jnp.asarray(d)) for d in ds]
    gap = cfg.window_len + 3 * cfg.symbol_len
    parts = [jnp.zeros((2, 300), jnp.complex64)]
    for t in txs:
        parts += [
            t,
            jnp.zeros((2, max(64, gap - t.shape[-1])), jnp.complex64),
        ]
    parts.append(jnp.zeros((2, 500), jnp.complex64))
    tx = jnp.concatenate(parts, axis=-1)
    return simulator.apply_channel(tx, h, spec, cfg), ds


def _stream(cfg, cap, chunk=512, **kw):
    dec = streaming.StreamingDecoder(cfg, chunk_size=chunk, **kw)
    capn = np.asarray(cap)
    T = capn.shape[-1]
    nc = -(-T // chunk)
    pad = np.pad(capn, ((0, 0), (0, nc * chunk - T)))
    for i in range(nc):
        dec.push(pad[:, i * chunk : (i + 1) * chunk])
    dec.finalize()
    return dec


@pytest.mark.slow
def test_streaming_sfo_estimates_and_corrects():
    """Three bursts at sfo_ppm=100: the live estimate converges to the
    offline two-pass value and later bursts decode better than the
    uncorrected (tracking-only) stream."""
    cfg = tiny_config(
        bit_exact=False, pid_max=64, modulation=Modulation.QAM16,
        track_channel=True, sync_fallback=True,
    )
    cap, ds = _three_burst_capture(cfg, 100.0)

    dec = _stream(cfg, cap, sfo_correct=True)
    assert len(dec.bursts) == 3  # all three bursts, no spurious ones
    # live estimate vs the offline two-pass estimator on an equivalent
    # single-burst capture (same seed / ppm)
    spec1 = simulator.ChannelSpec(
        snr_db=35.0, delay=333, seed=3, sfo_ppm=100.0
    )
    cap1, _, _ = simulator.simulate_capture(
        cfg.replace(track_channel=False), spec1
    )
    _, dtot, _ = sfo_mod.decode_with_sfo(
        cap1, cfg.replace(track_channel=False), iters=3
    )
    assert abs(dec.sfo_hat * 1e6 - 100.0) < 15.0, dec.sfo_hat * 1e6
    assert abs(dec.sfo_hat - float(dtot)) * 1e6 < 15.0

    n = cfg.pid_max * cfg.M_occupied
    sers = []
    for (si, _, rd), d in zip(dec.burst_results(), ds):
        sers.append((rd[:, :n] != np.asarray(d)[:, :n]).mean())
    # corrected bursts (2, 3) decode materially better than the
    # uncorrected first burst
    assert sers[1] < 0.6 * sers[0], sers
    assert sers[2] < 0.6 * sers[0], sers

    # tracking-only stream (no correction): later bursts stay at the
    # uncorrected error level
    dec0 = _stream(cfg, cap, sfo_correct=False)
    assert len(dec0.bursts) >= 2
    (_, _, rd2) = dec0.burst_results()[1]
    ser2_uncorr = (rd2[:, :n] != np.asarray(ds[1])[:, :n]).mean()
    assert sers[1] < 0.7 * ser2_uncorr, (sers[1], ser2_uncorr)


def test_streaming_sfo_requires_tracking():
    cfg = tiny_config(bit_exact=False)
    with pytest.raises(ValueError):
        streaming.StreamingDecoder(cfg, chunk_size=256, sfo_correct=True)
