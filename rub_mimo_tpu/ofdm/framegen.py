"""TX frame generation: sync words + batched OFDM payload framing.

Array-native replacement for ``rx_beamforming::framegen``
(mimo/framing.cc:79-266).  Where the reference assembles one OFDM symbol at
a time per stream with per-symbol FFTW plans (assemble_mimo_packet,
framing.cc:210-235, called in the tx_worker hot loop main.cc:1074-1112),
this module maps/IFFTs ALL payload symbols of all streams in one batched
jnp.fft.ifft over [streams, num_symbols, M] and prepends cyclic prefixes
with a single concatenate — one fused XLA computation.

Conventions (matching the reference exactly):
  - IFFT is unnormalized FFTW_BACKWARD (= M * jnp.fft.ifft), scaled by
    1/sqrt(M_occupied) (framing.cc:115,224).
  - The sync-word block is (num_access_codes*num_streams + 1) symbols:
    CP+S0 on stream 0 only, then the access codes TDMA — exactly one stream
    transmits per symbol slot, the others are zero (framing.cc:170-208).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from rub_mimo_tpu.config import ModemConfig
from rub_mimo_tpu.ofdm import preamble, sctype


def write_sync_words(cfg: ModemConfig) -> np.ndarray:
    """Build the sync-word block: [num_streams, sync_words_len] complex64.

    Layout (framing.cc:182-204):
      stream 0: [CP+s0] then its TDMA access-code slots
      stream k: zeros until its TDMA slots
    Slot order: for each code, for each stream — (code*num_streams + stream)
    symbol slots after the S0 symbol.
    """
    t = preamble.tables(cfg)
    S = cfg.num_streams
    sym = cfg.symbol_len
    out = np.zeros((S, cfg.sync_words_len), dtype=np.complex64)

    def place(stream: int, slot: int, x: np.ndarray) -> None:
        base = slot * sym
        out[stream, base : base + cfg.cp_len] = x[-cfg.cp_len :]
        out[stream, base + cfg.cp_len : base + sym] = x

    place(0, 0, t.s0)
    for code in range(cfg.num_access_codes):
        for stream in range(S):
            place(stream, 1 + code * S + stream, t.s1[stream, code])
    return out


def assemble_payload(
    cfg: ModemConfig, payload: jax.Array, precoder: jax.Array | None = None
) -> jax.Array:
    """Map payload constellation points into OFDM symbols with CP.

    payload: [num_streams, num_symbols, M_occupied] complex
    precoder: optional [M_occupied, tx_antenna, stream] per-subcarrier
        precoding matrix (detect.precode) — the working version of the
        reference's dead fg.set_W path (main.cc:498-505)
    returns: [num_streams, num_symbols * symbol_len] complex64 time signal

    Per symbol (framing.cc:210-235): occupied subcarriers get payload values
    in increasing subcarrier order, nulls get 0; unnormalized IFFT; scale by
    1/sqrt(M_occupied); prepend the last cp_len samples as cyclic prefix.
    """
    p = cfg.subcarrier_allocation()
    occ = jnp.asarray(sctype.occupied_indices(p))
    S, n_sym, m_occ = payload.shape
    M = cfg.M
    payload = payload.astype(jnp.complex64)
    if precoder is not None:
        # antenna a transmits sum_k P[sc, a, k] * stream_k[sc]
        payload = jnp.einsum(
            "sak,kns->ans", precoder.astype(jnp.complex64), payload,
            precision=jax.lax.Precision.HIGHEST,
        )
    X = jnp.zeros((S, n_sym, M), dtype=jnp.complex64)
    X = X.at[:, :, occ].set(payload)
    # FFTW_BACKWARD = M * ifft; then * 1/sqrt(M_occupied)
    x = jnp.fft.ifft(X, axis=-1) * (M / np.sqrt(m_occ))
    x = x.astype(jnp.complex64)
    with_cp = jnp.concatenate([x[:, :, M - cfg.cp_len :], x], axis=-1)
    return with_cp.reshape(S, n_sym * cfg.symbol_len)


def write_sync_words_precoded(cfg: ModemConfig, precoder: jax.Array) -> jax.Array:
    """Sync-word block with the access codes precoded.

    S0 stays on antenna 0 (S&C sync is precoder-agnostic); each TDMA slot
    for (code, stream k) transmits P[:, :, k] * S1[k, code] across all
    antennas, so the receiver's estimator measures the EFFECTIVE channel
    G @ P and the ordinary ZF detection becomes transparent to precoding —
    the working closed loop the reference's TX_BEAMFORMING path sketches.
    """
    t = preamble.tables(cfg)
    p = cfg.subcarrier_allocation()
    occ = jnp.asarray(sctype.occupied_indices(p))
    S = cfg.num_streams
    sym = cfg.symbol_len
    M = cfg.M
    cp = cfg.cp_len
    out = jnp.zeros((S, cfg.sync_words_len), dtype=jnp.complex64)

    # S0 on antenna 0
    s0_t = jnp.zeros((S, M), dtype=jnp.complex64).at[0].set(jnp.asarray(t.s0))
    blocks = [(0, s0_t)]
    P = precoder.astype(jnp.complex64)  # [m_occ, a, k]
    S1 = jnp.asarray(t.S1)  # [k, code, M]
    for code in range(cfg.num_access_codes):
        for k in range(S):
            Xk = jnp.zeros((S, M), dtype=jnp.complex64)
            vals = P[:, :, k].T * S1[k, code][occ][None, :]  # [a, m_occ]
            Xk = Xk.at[:, occ].set(vals)
            # FFTW_BACKWARD (=M*ifft) scaled by 1/sqrt(M) (framing.cc:1228)
            xt = (jnp.fft.ifft(Xk, axis=-1) * (M / np.sqrt(M))).astype(
                jnp.complex64
            )
            blocks.append((1 + code * S + k, xt))

    for slot, sig_t in blocks:
        base = slot * sym
        block = jnp.concatenate([sig_t[:, M - cp :], sig_t], axis=-1)
        out = jax.lax.dynamic_update_slice(out, block, (0, base))
    return out


def generate_payload_symbols(cfg: ModemConfig, seed: int = 0) -> np.ndarray:
    """Random integer payload like the reference's rand()%ARITY stream
    (main.cc:1235-1238): [num_streams, pid_max * M_occupied] int32."""
    rng = np.random.default_rng(seed)
    n = cfg.pid_max * cfg.M_occupied
    if cfg.mode.value in ("siso", "rx_diversity", "alamouti"):
        # one logical data stream (antenna mapping happens at framing time)
        data = np.zeros((cfg.num_streams, n), dtype=np.int32)
        active = 0 if cfg.mode.value == "alamouti" else cfg.siso_tx
        data[active] = rng.integers(0, cfg.arity, size=n, dtype=np.int32)
    elif cfg.same_signal_on_all_tx:
        # SAME_SIGNAL_ON_ALL_TX variant (mimo/main.cc:1223-1233): every
        # antenna repeats stream 0's symbols
        row = rng.integers(0, cfg.arity, size=n, dtype=np.int32)
        data = np.broadcast_to(row, (cfg.num_streams, n)).copy()
    else:
        data = rng.integers(
            0, cfg.arity, size=(cfg.num_streams, n), dtype=np.int32
        )
    return data


def transmit_frame(
    cfg: ModemConfig,
    tx_data: jax.Array,
    include_sync: bool = True,
    precoder: jax.Array | None = None,
) -> jax.Array:
    """Full TX baseband signal for an experiment run.

    tx_data: [num_streams, pid_max * M_occupied] integer symbols
    precoder: optional [M_occupied, antenna, stream] per-subcarrier
        precoding matrix applied to access codes AND payload (closed-loop
        TX beamforming; see detect.precode)
    returns: [num_streams, total_len] complex64 at baseband_gain scale

    Mirrors the tx_worker send sequence (main.cc:1027-1112): sync words then
    pid_max payload OFDM symbols, all scaled by BASEBAND_GAIN (0.25).
    """
    from rub_mimo_tpu.ofdm import constellation

    sig = constellation.modulate(tx_data, cfg.modulation)
    if cfg.mode.value == "alamouti":
        if precoder is not None:
            # Alamouti exists for the no-CSI case; a precoder would remix
            # the antennas and destroy the space-time code's structure
            raise ValueError("ALAMOUTI mode cannot be combined with a precoder")
        # stream 0 carries the data; space-time code it onto both antennas
        from rub_mimo_tpu.detect import alamouti as alamouti_mod

        one = sig[0].reshape(cfg.pid_max, cfg.M_occupied)
        sig_ant = alamouti_mod.encode_pairs(one)  # [2, pid, m_occ]
        payload_t = assemble_payload(cfg, sig_ant)
        parts = []
        if include_sync:
            parts.append(jnp.asarray(write_sync_words(cfg)))
        parts.append(payload_t)
        out = jnp.concatenate(parts, axis=-1)
        return (out * cfg.baseband_gain).astype(jnp.complex64)
    if cfg.mode.value in ("siso", "rx_diversity"):
        # only SISO_TX transmits; the other streams' tx_sig buffers stay
        # zero-filled (main.cc:1213-1219: std::fill then modulate only
        # chan == SISO_TX)
        mask = jnp.zeros((cfg.num_streams, 1), dtype=sig.dtype)
        mask = mask.at[cfg.siso_tx, 0].set(1.0)
        sig = sig * mask
    sig = sig.reshape(cfg.num_streams, cfg.pid_max, cfg.M_occupied)
    payload_t = assemble_payload(cfg, sig, precoder=precoder)
    parts = []
    if include_sync:
        if precoder is not None:
            parts.append(write_sync_words_precoded(cfg, precoder))
        else:
            parts.append(jnp.asarray(write_sync_words(cfg)))
    parts.append(payload_t)
    out = jnp.concatenate(parts, axis=-1)
    return (out * cfg.baseband_gain).astype(jnp.complex64)
