"""Least-squares MIMO channel estimation from the access-code pilots.

Array-native replacement for framesync::estimate_channel's LS phase
(mimo/framing.cc:801-824): for each access code and (rx, tx) pair, FFT the
M-sample window at that code's matched-filter argmax offset and accumulate

    G[sc][rx][tx] += X_rx[sc] / S1_tx[code][sc]      (occupied sc only)

then scale by dft_normalizer / num_access_codes with
dft_normalizer = 1/sqrt(M_occupied) (framing.cc:330, 817-824).

Bit-exact quirk: the reference's G is initialized to IDENTITY in the
constructor (framing.cc:302-319) and never zeroed before the +=, so the
final estimate carries a dft_normalizer/num_access_codes bias on the
diagonal.  cfg.bit_exact=True replicates it; False computes the clean LS
estimate.

All codes x rx x tx windows are gathered and FFT'd as ONE batched
jnp.fft.fft (the reference runs 80 serial FFTW executes).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from rub_mimo_tpu.config import ModemConfig
from rub_mimo_tpu.ofdm import preamble, sctype
from rub_mimo_tpu.utils import gather


def code_ffts(
    window: jax.Array,
    offsets: jax.Array,
    cfg: ModemConfig,
    *,
    uniform: bool = False,
) -> jax.Array:
    """Unnormalized M-point FFTs of the access-code windows.

    offsets: [n_codes, rx, tx] int32 — any subset of the per-code argmax
    offsets (the subcarrier-sharded decoder hands each 'sc' device its own
    chunk of codes; each output row depends only on its own offsets, so
    chunked evaluation is bitwise identical to the full batch).

    uniform: the caller GUARANTEES the offsets form the joint-timing
    grid — offsets[code, rx, tx] = base + (code*S + tx)*symbol_len,
    identical for every rx (matched_filter.finalize with joint=True
    broadcasts one global argmax).  All codes*S*S windows then live on a
    single dynamically-positioned span, extracted with static slices —
    replacing the per-window dynamic-slice scan and its sequential while
    loop.  The slices are
    pure copies of the same elements, so the result is bit-identical to
    the scan path (asserted in tests/test_ls_uniform.py).

    Returns X [n_codes, S(rx), S(tx), M].
    """
    S = cfg.num_streams
    M = cfg.M
    n_codes = offsets.shape[0]

    if uniform:
        sym = cfg.symbol_len
        n = n_codes * S  # distinct windows: rx-independent offsets
        if not isinstance(offsets, jax.core.Tracer):
            # guard the caller invariant whenever offsets are concrete
            # (tests / eager callers); under jit the invariant is
            # enforced structurally by matched_filter.finalize(joint=True)
            off_np = np.asarray(offsets)
            grid = off_np.reshape(-1)[0] + (
                np.arange(n_codes)[:, None, None] * S
                + np.arange(S)[None, None, :]
            ) * sym
            if not np.array_equal(off_np, np.broadcast_to(grid, off_np.shape)):
                raise ValueError(
                    "code_ffts(uniform=True) requires offsets on the "
                    "joint-timing grid base + (code*S + tx)*symbol_len, "
                    "identical across rx; got a non-uniform offset array "
                    "(use uniform=False for per-code/bit_exact offsets)"
                )
        base = offsets.reshape(-1)[0].astype(jnp.int32)
        span_len = (n - 1) * sym + M
        W = window.shape[-1]
        # the grid always fits the estimation region (base = i0 + sym
        # with i0 in [0, sym), region_len = sym*(1+n) + M, pipeline.rx)
        # but clamp like dynamic_slice would for defensive parity
        base = jnp.clip(base, 0, max(W - span_len, 0))
        span = jax.lax.dynamic_slice(
            window, (jnp.int32(0), base), (S, span_len)
        )
        wins = jnp.stack(
            [span[:, j * sym : j * sym + M] for j in range(n)], axis=1
        )  # [S(rx), n, M]
        wins = wins.reshape(S, n_codes, S, M).transpose(1, 0, 2, 3)
        return jnp.fft.fft(wins, axis=-1)

    flat_off = offsets.reshape(-1)
    rx_ids = jnp.tile(
        jnp.repeat(jnp.arange(S, dtype=jnp.int32), S), n_codes
    )  # [code*S(rx)*S(tx)] — rx varies over the middle axis
    wins = gather.slice_windows(window, rx_ids, flat_off, M)
    return jnp.fft.fft(wins.reshape(n_codes, S, S, M), axis=-1)


def channel_from_ffts(X: jax.Array, cfg: ModemConfig) -> jax.Array:
    """LS estimate from the FULL code-FFT batch X [codes, rx, tx, M]."""
    S = cfg.num_streams
    codes = cfg.num_access_codes
    t = preamble.tables(cfg)
    p = cfg.subcarrier_allocation()
    occ = jnp.asarray(sctype.occupied_mask(p))
    m_occ = cfg.M_occupied
    dft_normalizer = np.float32(1.0 / np.sqrt(m_occ))

    # S1[tx, code, sc] -> [code, 1(rx), tx, sc]
    S1 = jnp.asarray(t.S1).transpose(1, 0, 2)[:, None, :, :]
    ratio = jnp.where(occ[None, None, None, :], X / jnp.where(occ, S1, 1.0), 0.0)
    Gsum = jnp.sum(ratio, axis=0)  # [rx, tx, M]
    Gsum = Gsum.transpose(2, 0, 1)  # [M, rx, tx]

    if cfg.bit_exact:
        eye = jnp.eye(S, dtype=Gsum.dtype)[None, :, :] * occ[:, None, None]
        Gsum = Gsum + eye
    G = Gsum * (dft_normalizer / np.float32(codes))
    return G.astype(jnp.complex64)


def ac_offsets(ac_index: jax.Array, cfg: ModemConfig) -> jax.Array:
    """[codes, rx, tx] offsets from the matched-filter ac_index layout:
    offsets[code, rx, tx] = ac_index[rx, code*S + tx] (framing.cc:804-806)."""
    S = cfg.num_streams
    return ac_index.reshape(S, cfg.num_access_codes, S).transpose(1, 0, 2)


def estimate_channel(
    window: jax.Array,
    ac_index: jax.Array,
    cfg: ModemConfig,
    *,
    uniform: bool = False,
) -> jax.Array:
    """LS channel estimate Ghat: [M, num_streams(rx), num_streams(tx)].

    window:   [streams, W] complex — the replay window
    ac_index: [streams(rx), codes*streams] int32 — absolute window offsets
              of each access code's correlation peak (matched_filter.search)
    uniform:  offsets are the joint-timing grid (see code_ffts)
    """
    X = code_ffts(window, ac_offsets(ac_index, cfg), cfg, uniform=uniform)
    return channel_from_ffts(X, cfg)


def estimate_noise_var(
    window: jax.Array,
    ac_index: jax.Array,
    G: jax.Array,
    cfg: ModemConfig,
) -> jax.Array:
    """Data-aided noise variance at the equalizer input (new capability —
    lets the MMSE detector run parameter-free).

    Model: each access-code symbol's unnormalized FFT satisfies
    X/S1 ~= Ghat * sqrt(M_occ) + noise_f with noise_f variance M*sigma_t^2
    (the LS scaling chain, see estimate_channel).  The payload symbols the
    detector sees are scaled by 1/sqrt(M_occ), so their per-subcarrier
    noise variance is var(noise_f)/M_occ — which is exactly what this
    returns: sigma^2 for detect.mmse.mmse_weights.

    The residual also contains channel-estimation error (order 1/codes),
    which slightly overestimates sigma^2 — a safe direction for MMSE.
    """
    X = code_ffts(window, ac_offsets(ac_index, cfg), cfg)
    return noise_var_from_ffts(X, G, cfg)


def noise_var_from_ffts(
    X: jax.Array, G: jax.Array, cfg: ModemConfig
) -> jax.Array:
    """estimate_noise_var from a precomputed FULL code-FFT batch X."""
    S = cfg.num_streams
    codes = cfg.num_access_codes
    t = preamble.tables(cfg)
    p = cfg.subcarrier_allocation()
    occ = jnp.asarray(sctype.occupied_mask(p))
    m_occ = cfg.M_occupied

    S1 = jnp.asarray(t.S1).transpose(1, 0, 2)[:, None, :, :]
    ratio = X / jnp.where(occ, S1, 1.0)  # [code, rx, tx, M]
    # expected value per (rx, tx, sc): Ghat * sqrt(M_occ)
    mean = G.transpose(1, 2, 0)[None, :, :, :] * np.float32(np.sqrt(m_occ))
    resid2 = jnp.abs(ratio - mean) ** 2
    var_f = jnp.sum(jnp.where(occ[None, None, None, :], resid2, 0.0)) / (
        codes * S * S * m_occ
    )
    return (var_f / m_occ).astype(jnp.float32)
