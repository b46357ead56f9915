"""Synthetic MIMO channel simulator — stands in for the USRP radios.

The reference validates itself only by over-the-air experiments between two
B210s (SURVEY §4); this module provides the deterministic stand-in: AWGN,
random flat or frequency-selective MIMO mixing, timing offset (leading
noise/silence), and carrier frequency offset, so every pipeline config can
be exercised and regression-tested without hardware.

All channel draws are seeded and the channel realization is returned so
tests can compare the estimator's Ghat against ground truth.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from rub_mimo_tpu.config import ModemConfig

_HIGHEST = jax.lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    """Synthetic channel parameters."""

    snr_db: float = 30.0
    # flat MIMO mixing matrix H[rx, tx]; None -> random (seeded)
    flat: bool = True
    num_taps: int = 1           # >1 -> frequency-selective (random FIR taps)
    delay: int = 1000           # leading samples before the frame (timing offset)
    trailing: int = 2048        # trailing samples after the frame
    cfo_subcarriers: float = 0.0  # CFO in subcarrier-spacing units
    # sampling-frequency offset between TX and RX clocks, in parts-per-
    # million: the receiver observes s(t * (1 + sfo_ppm * 1e-6))
    sfo_ppm: float = 0.0
    # RX front-end impairments (direct-conversion receivers like the
    # B210's AD9361): amplitude/phase mismatch between the I and Q arms
    # (z = mu*y + nu*conj(y)) and a residual DC offset
    iq_amp_db: float = 0.0
    iq_phase_deg: float = 0.0
    dc_offset: complex = 0.0
    # per-element phase drift in cycles/sample (time-varying flat channel;
    # each H entry rotates at rate drift_rate * u with u ~ U(-1, 1))
    drift_rate: float = 0.0
    seed: int = 1234
    identity: bool = False      # H = I (loopback)
    diagonal_dominance: float = 2.0  # scales the diagonal of random H for
                                     # well-conditioned 2x2 inversion


def draw_channel(spec: ChannelSpec, num_rx: int, num_tx: int) -> np.ndarray:
    """Channel impulse response h[rx, tx, taps] (complex64)."""
    rng = np.random.default_rng(spec.seed)
    taps = 1 if spec.flat else spec.num_taps
    if spec.identity:
        h = np.zeros((num_rx, num_tx, taps), dtype=np.complex64)
        for i in range(min(num_rx, num_tx)):
            h[i, i, 0] = 1.0
        return h
    h = (
        rng.standard_normal((num_rx, num_tx, taps))
        + 1j * rng.standard_normal((num_rx, num_tx, taps))
    ) / np.sqrt(2.0)
    # exponentially decaying power-delay profile for selective channels
    if taps > 1:
        pdp = np.exp(-np.arange(taps) / max(taps / 3.0, 1.0))
        h *= np.sqrt(pdp / pdp.sum())
    for i in range(min(num_rx, num_tx)):
        h[i, i, 0] *= spec.diagonal_dominance
    return h.astype(np.complex64)


def apply_channel(
    tx: jax.Array,
    h: np.ndarray | jax.Array,
    spec: ChannelSpec,
    cfg: Optional[ModemConfig] = None,
) -> jax.Array:
    """Propagate tx [tx_streams, T] through the channel: returns
    rx [rx_streams, T + delay + trailing + taps - 1] complex64 with AWGN at
    the requested SNR (SNR measured against the mean tx-signal power)."""
    h = jnp.asarray(h)
    num_rx, num_tx, taps = h.shape
    T = tx.shape[-1]

    # MIMO FIR mixing: y[rx] = sum_tx conv(tx[tx], h[rx, tx])
    if taps == 1 and spec.drift_rate != 0.0:
        # time-varying flat channel: each element rotates independently
        rng = np.random.default_rng(spec.seed + 7)
        rates = spec.drift_rate * rng.uniform(-1, 1, (num_rx, num_tx))
        n = jnp.arange(T, dtype=jnp.float32)
        rot = jnp.exp(
            2j * jnp.pi * jnp.asarray(rates[..., None]) * n[None, None, :]
        )  # [rx, tx, T]
        ht = h[..., 0][..., None] * rot
        y = jnp.einsum("rtn,tn->rn", ht, tx, precision=_HIGHEST)
    elif taps == 1:
        y = jnp.einsum("rt,tn->rn", h[..., 0], tx, precision=_HIGHEST)
    else:
        # full convolution via FFT (lengths are large)
        L = T + taps - 1
        nfft = 1 << (L - 1).bit_length()
        Xf = jnp.fft.fft(tx, n=nfft, axis=-1)
        Hf = jnp.fft.fft(h, n=nfft, axis=-1)
        Yf = jnp.einsum("rtn,tn->rn", Hf, Xf, precision=_HIGHEST)
        y = jnp.fft.ifft(Yf, axis=-1)[:, :L]

    # CFO rotation
    if spec.cfo_subcarriers != 0.0:
        if cfg is None:
            raise ValueError("cfo requires cfg for subcarrier spacing")
        n = jnp.arange(y.shape[-1], dtype=jnp.float32)
        y = y * jnp.exp(2j * jnp.pi * spec.cfo_subcarriers * n / cfg.M)[None, :]

    # sampling-clock offset: resample at t * (1 + delta)
    if spec.sfo_ppm != 0.0:
        from rub_mimo_tpu.utils.resample import resample_bandlimited

        y = resample_bandlimited(y, 1.0 + spec.sfo_ppm * 1e-6)

    # timing offset + trailing
    y = jnp.pad(y, ((0, 0), (spec.delay, spec.trailing)))

    # AWGN at the requested SNR relative to mean tx power
    sig_power = jnp.mean(jnp.abs(tx) ** 2)
    noise_var = sig_power * 10.0 ** (-spec.snr_db / 10.0)
    key = jax.random.PRNGKey(spec.seed + 1)
    kr, ki = jax.random.split(key)
    noise = jnp.sqrt(noise_var / 2.0) * (
        jax.random.normal(kr, y.shape) + 1j * jax.random.normal(ki, y.shape)
    )
    y = (y + noise).astype(jnp.complex64)

    # RX front-end: IQ imbalance z = mu*y + nu*conj(y), then DC offset
    if spec.iq_amp_db != 0.0 or spec.iq_phase_deg != 0.0:
        g = 10.0 ** (spec.iq_amp_db / 20.0)
        phi = np.deg2rad(spec.iq_phase_deg)
        mu = np.complex64((1.0 + g * np.exp(1j * phi)) / 2.0)
        nu = np.complex64((1.0 - g * np.exp(-1j * phi)) / 2.0)
        y = (mu * y + nu * jnp.conj(y)).astype(jnp.complex64)
    if spec.dc_offset != 0.0:
        y = (y + jnp.complex64(spec.dc_offset)).astype(jnp.complex64)
    return y


def inject_fault(
    capture: np.ndarray,
    kind: str,
    *,
    seed: int = 0,
    position: float = 0.5,
    length: int = 256,
) -> np.ndarray:
    """Fault injection for recovery testing (SURVEY §5 — the reference has
    none; bad captures just silently never sync).

    kinds: 'truncate' (cut the capture at `position` fraction),
           'nan_burst' (length-`length` NaN burst),
           'dropout'   (length-`length` zero burst),
           'spike'     (single huge sample).
    """
    x = np.array(capture, copy=True)
    T = x.shape[-1]
    pos = int(T * position)
    if kind == "truncate":
        return x[..., :pos]
    if kind == "nan_burst":
        x[..., pos : pos + length] = np.nan
        return x
    if kind == "dropout":
        x[..., pos : pos + length] = 0
        return x
    if kind == "spike":
        x[..., pos] = 1e6
        return x
    raise ValueError(f"unknown fault kind {kind!r}")


def simulate_capture(
    cfg: ModemConfig,
    spec: ChannelSpec,
    tx_data: Optional[np.ndarray] = None,
    payload_seed: int = 0,
):
    """End-to-end synthetic experiment: returns (capture, tx_data, h).

    capture: [num_streams, T] complex64 — what rx_worker would have logged
    tx_data: [num_streams, pid_max * M_occupied] int32 ground truth
    h:       [rx, tx, taps] channel realization
    """
    from rub_mimo_tpu.ofdm import framegen

    if tx_data is None:
        tx_data = framegen.generate_payload_symbols(cfg, seed=payload_seed)
    h = draw_channel(spec, cfg.num_streams, cfg.num_streams)

    # one jitted program for the whole TX+channel chain
    def _gen(td):
        tx = framegen.transmit_frame(cfg, td)
        return apply_channel(tx, jnp.asarray(h), spec, cfg)

    capture = jax.jit(_gen)(jnp.asarray(tx_data))
    return capture, tx_data, h
