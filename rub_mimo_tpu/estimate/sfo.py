"""Sampling-frequency-offset estimation and correction.

SFO (TX/RX sampling clocks differing by delta = ppm * 1e-6) makes each
successive OFDM symbol's FFT window slide by delta * symbol_len samples,
which appears as a per-subcarrier phase ramp growing linearly with BOTH
the frame index n and the (signed) subcarrier index k:

    phase(n, k) ~= 2*pi * delta * k * n * symbol_len / M  (+ CPE terms)

The reference sidesteps SFO entirely by wiring both radios to one 10 MHz
reference (mimo/main.cc:270-276); a replay framework must estimate it
from the data.  Estimator: decision-directed, differential in n (no
unwrapping needed) — for each subcarrier, average r[n+1] * conj(r[n])
of the decision residuals r = y * conj(s_hat) over frames and streams,
then fit the resulting per-subcarrier phase increment against k with a
weighted LS that includes an intercept (so common phase error / residual
CFO, which is constant in k, does not bias the slope).

Correction: resample the capture by 1/(1+delta) (utils.resample) and
decode again (a two-pass flow).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from rub_mimo_tpu.config import ModemConfig
from rub_mimo_tpu.ofdm import constellation, sctype


def estimate_sfo(
    rx_sig: jax.Array,
    cfg: ModemConfig,
    n_frames: int | None = None,
    decisions: jax.Array | None = None,
) -> jax.Array:
    """Estimate delta (fractional clock offset; ppm = delta * 1e6) from a
    decoded run's equalized symbols rx_sig [S, pid_max * M_occupied]
    (equalized with the STATIC preamble estimate, so the ramp is intact).

    Decision-directed: by default decisions come from rx_sig itself,
    which is only reliable while the accumulated ramp stays inside the
    decision margin (limit the fit with n_frames for that regime).  For
    large offsets pass `decisions` from a tracking decode
    (track_channel=True follows the ramp, so its decisions stay good
    across the whole run) — decode_with_sfo wires this up.
    """
    self_decide = decisions is None
    if self_decide:
        decisions = jnp.zeros(rx_sig.shape, jnp.int32)  # ignored
    return _estimate_sfo_jit(rx_sig, decisions, cfg, n_frames, self_decide)


@functools.partial(
    jax.jit, static_argnames=("cfg", "n_frames", "self_decide")
)
def _estimate_sfo_jit(
    rx_sig: jax.Array,
    decisions: jax.Array,
    cfg: ModemConfig,
    n_frames: int | None,
    self_decide: bool,
) -> jax.Array:
    S = rx_sig.shape[0]
    m_occ = cfg.M_occupied
    y = rx_sig.reshape(S, cfg.pid_max, m_occ)
    if self_decide:
        d = constellation.demodulate(y, cfg.modulation)
    else:
        d = decisions.reshape(S, cfg.pid_max, m_occ)
    if n_frames is not None:
        y = y[:, : int(n_frames)]
        d = d[:, : int(n_frames)]
    s_hat = jnp.asarray(constellation.table(cfg.modulation))[d]
    r = y * jnp.conj(s_hat)                     # decision residuals

    # differential across frames, averaged over streams and frames
    z = jnp.sum(r[:, 1:, :] * jnp.conj(r[:, :-1, :]), axis=(0, 1))  # [m_occ]
    return fit_subcarrier_slope(z, cfg)


@functools.partial(jax.jit, static_argnames=("cfg",))
def fit_subcarrier_slope(z: jax.Array, cfg: ModemConfig) -> jax.Array:
    """Fit delta from the per-subcarrier frame-differential moment
    z[m_occ] = sum over frame pairs of r[n+1] * conj(r[n]): a weighted LS
    of angle(z) ~= a + b*k_signed over occupied subcarriers (the
    intercept absorbs CPE/residual CFO; the Nyquist bin, whose shift
    phase aliases, is excluded); b = 2*pi*delta*symbol_len/M.  Shared by
    the offline estimator and the streaming accumulator
    (pipeline.streaming sfo_correct)."""
    dphi = jnp.angle(z)
    w = jnp.abs(z)

    occ = sctype.occupied_indices(cfg.subcarrier_allocation())
    k_np = ((np.asarray(occ) + cfg.M // 2) % cfg.M) - cfg.M // 2
    k = jnp.asarray(k_np, jnp.float32)
    # the Nyquist bin (k = -M/2) aliases its shift phase (e^{-j pi tau}
    # flips sign per whole-sample slip) — exclude it from the fit
    w = w * jnp.asarray(k_np != -(cfg.M // 2), jnp.float32)

    # weighted LS fit dphi ~= a + b*k (intercept absorbs CPE/residual CFO)
    w0 = jnp.sum(w)
    wk = jnp.sum(w * k)
    wkk = jnp.sum(w * k * k)
    wp = jnp.sum(w * dphi)
    wkp = jnp.sum(w * k * dphi)
    det = w0 * wkk - wk * wk
    b = (w0 * wkp - wk * wp) / jnp.where(det == 0, 1.0, det)

    # b = 2*pi * delta * symbol_len / M  (per frame, per subcarrier unit)
    return b * cfg.M / (2.0 * jnp.pi * cfg.symbol_len)


@functools.partial(jax.jit, static_argnames=("cfg",))
def preamble_sfo(
    region: jax.Array, ac_index: jax.Array, cfg: ModemConfig
) -> jax.Array:
    """DATA-AIDED SFO estimate from the known S1 access codes (round 5).

    At the full reference geometry (M=2048, 41 preamble symbols) even a
    few ppm of clock offset rotates the band edges by ~0.5 rad ACROSS
    the preamble itself: the LS channel estimate averages codes over a
    rotating phase, the payload decodes at 20%+ SER from frame 0, and
    every decision-directed estimator starves.  The access codes are
    known pilots, so no decisions are needed: per subcarrier, the phase
    ADVANCE between consecutive same-tx code observations
    R_c = X_c * conj(S1) (windows S*symbol_len samples apart on the
    TDMA grid, framing.cc:182-204) has slope 2*pi*delta*k*S*sym/M —
    the same moment/fit machinery as the frame-differential estimator,
    scaled by the S-symbol code pitch.  Unambiguous to
    |delta| < M / (2*S*symbol_len*(M/2)) (~230 ppm at the reference
    point), far beyond any real TCXO."""
    from rub_mimo_tpu.estimate import ls
    from rub_mimo_tpu.ofdm import preamble

    X = ls.code_ffts(
        region, ls.ac_offsets(ac_index, cfg), cfg,
        uniform=(not cfg.bit_exact) and cfg.timing_mode == "joint",
    )  # [codes, rx, tx, M]
    t = preamble.tables(cfg)
    S1 = jnp.asarray(t.S1).transpose(1, 0, 2)[:, None, :, :]
    R = X * jnp.conj(S1)  # phase == X / S1 (|S1| is a positive scale)
    occ = jnp.asarray(
        sctype.occupied_indices(cfg.subcarrier_allocation())
    )
    R = R[..., occ]
    z = jnp.sum(R[1:] * jnp.conj(R[:-1]), axis=(0, 1, 2))
    # fit_subcarrier_slope assumes a symbol_len step; codes step S*sym
    return fit_subcarrier_slope(z, cfg) / cfg.num_streams


def correct_sfo(iq: jax.Array, delta: float | jax.Array) -> jax.Array:
    """Undo rx[t] = s(t * (1 + delta)): resample at t / (1 + delta)."""
    from rub_mimo_tpu.utils.resample import resample_bandlimited

    return resample_bandlimited(
        iq, 1.0 / (1.0 + jnp.asarray(delta, jnp.float32))
    )


def decode_with_sfo(
    iq: jax.Array, cfg: ModemConfig, *, iters: int = 2,
    track_block_frames: int | None = None,
):
    """SFO-corrected decode (full-MIMO modes).

    Each pass: (1) decode with decision-directed channel tracking, whose
    per-block refits follow the SFO ramp, yielding reliable symbol
    decisions across the whole run; (2) decode statically and fit the
    intact per-(frame, subcarrier) phase ramp against those decisions;
    (3) resample the capture by 1/(1+delta).  A second pass refines the
    estimate on the nearly-corrected capture.

    Both helper decodes run with a ZF-family detector regardless of
    cfg.detector: tracking refits through the linear equalizer, and the
    fit needs SOFT equalized symbols (ML's remodulated hard decisions
    quantize the ramp away).  The final decode uses cfg as given.

    Returns (final DecodeResult, delta_total, corrected iq); each pass
    costs two decodes."""
    from rub_mimo_tpu.config import CommMode, Detector
    from rub_mimo_tpu.pipeline import rx as rx_mod

    if cfg.mode not in (CommMode.RX_ZF, CommMode.RX_BEAMFORMING):
        # the tracked helper decode needs decision-directed refits through
        # the linear equalizer, which config.validate restricts to the
        # ZF-family modes — fail loudly instead of silently running the
        # full-MIMO tracking path on a single-stream config
        raise ValueError(
            "decode_with_sfo requires a ZF-family mode (RX_ZF or "
            f"RX_BEAMFORMING); got {cfg.mode.value}. For single-stream "
            "modes, resample with estimate/correct_sfo directly."
        )

    bf = track_block_frames
    if bf is None:
        # small blocks: the tracker must out-pace the within-block ramp
        bf = min(cfg.track_block_frames, 4)
        while cfg.pid_max % bf:
            bf -= 1
    cfg_fit = cfg.replace(track_channel=False)
    if cfg.detector in (Detector.ML, Detector.SIC):
        cfg_fit = cfg_fit.replace(detector=Detector.ZF)
    cfg_track = cfg_fit.replace(
        track_channel=True, track_block_frames=bf
    ).validate()

    dec_fit = rx_mod.make_decoder(cfg_fit)
    dec_track = rx_mod.make_decoder(cfg_track)

    delta_total = jnp.float32(0.0)
    fit_result = dec_fit(iq)
    # stage 0 — data-aided acquisition from the known access codes
    # (see preamble_sfo): pulls the offset to within the decision-
    # directed refiners' capture range even when the payload decodes at
    # high SER from frame 0 (the full-geometry regime)
    region = rx_mod._extract_region(iq, fit_result.sync_index, cfg_fit)
    d0 = preamble_sfo(region, fit_result.ac_index, cfg_fit)
    delta_total = delta_total + d0
    iq = correct_sfo(iq, d0)
    fit_result = dec_fit(iq)
    for _ in range(iters):
        tracked = dec_track(iq)
        d = estimate_sfo(
            fit_result.rx_sig, cfg_fit, decisions=tracked.rx_data
        )
        delta_total = delta_total + d
        iq = correct_sfo(iq, d)
        fit_result = dec_fit(iq)
    if cfg_fit == cfg:
        result = fit_result
    else:
        result = rx_mod.make_decoder(cfg)(iq)
    return result, delta_total, iq
