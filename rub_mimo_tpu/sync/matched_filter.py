"""Matched-filter timing refinement over the access-code region.

Array-native replacement for the channel estimator's offset search
(mimo/framing.cc:702-744, USE_NEW_CHANNEL_EST): for every candidate offset
i in [0, symbol_len), every rx stream, and every one of the
1 + num_access_codes*num_streams sequences (S0 plus each (code, tx) access
code), the reference FFTs an M-sample window and conjugate-dot-products it
against the frequency-domain sequence — ~180k serial FFT+dot pairs.

Because the DFT is unitary up to scale, that frequency-domain dot product
equals a time-domain correlation against the sequence's unnormalized
inverse FFT:

    sum_k FFT(w)[k] * conj(S[k])  ==  sum_n w[n] * conj(ifft_fftw(S)[n])

so the whole (offset x sequence x rx) search collapses to a batch of
FFT-based cross-correlations over the search region — a few dozen large
FFTs instead of ~180k small ones.  corr values are |.|^2 / M^2 exactly as
the reference computes them (framing.cc:716-717, 733-734).

A direct windowed-einsum variant is kept for validation (method="direct").
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from rub_mimo_tpu.config import ModemConfig
from rub_mimo_tpu.ofdm import preamble


class MatchedFilterResult(NamedTuple):
    s0_index: jax.Array    # int32[streams] — argmax offset for S0
    s0_peak: jax.Array     # float32[streams]
    ac_index: jax.Array    # int32[streams, codes*streams] — absolute offsets
    ac_peak: jax.Array     # float32[streams, codes*streams]
    # full correlation traces over the search offsets, for the reference's
    # corr_<chan>_<ac>.dat debug artifacts (framing.cc:874-881):
    # [streams, 1 + codes*streams, symbol_len]
    traces: jax.Array | None


def templates(cfg: ModemConfig) -> np.ndarray:
    """[1 + codes*streams, M] unnormalized time-domain templates.

    Row 0 is S0; row 1 + code*streams + tx is access code (code, tx) —
    matching the reference's _ac_id = code*num_streams + tx_chan ordering
    (framing.cc:724).
    """
    t = preamble.tables(cfg)
    rows = [t.s0_unnormalized]
    for code in range(cfg.num_access_codes):
        for tx in range(cfg.num_streams):
            rows.append(t.s1_unnormalized[tx, code])
    return np.stack(rows).astype(np.complex64)


_templates = templates  # backward-compat alias


def _fft_len(n: int) -> int:
    """Next power of two >= n."""
    return 1 << (n - 1).bit_length()


def corr_vals(
    window: jax.Array,
    cfg: ModemConfig,
    tmpl: jax.Array,
    seq_base: jax.Array,
    *,
    method: str = "xcorr",
) -> jax.Array:
    """Correlation magnitudes for a (possibly partial) template set.

    window:   [streams, W] complex — replay window
    tmpl:     [n_tmpl, M] time-domain templates (any subset of
              ``templates(cfg)`` rows — the subcarrier-sharded decoder
              hands each 'sc' device its own chunk)
    seq_base: [n_tmpl] int32 — each row's base offset (= global sequence
              index * symbol_len, framing.cc:707/725)

    Returns vals [streams, n_tmpl, symbol_len]: |corr|^2 / M^2 at offsets
    seq_base[q] + i for i in [0, symbol_len).  Each output row depends only
    on its own template row, so chunked evaluation is bitwise identical to
    the full batch.
    """
    S = cfg.num_streams
    sym = cfg.symbol_len
    M = cfg.M
    n_seq = 1 + cfg.num_access_codes * S  # FULL count — fixes region/L so
    n_tmpl = tmpl.shape[0]                # chunked runs match the full run

    if method == "xcorr":
        # Each template q only ever scores offsets in its OWN symbol_len
        # lane [seq_base[q], seq_base[q] + sym), so the correlation needs
        # just a (sym + M)-sample window per template — small per-row FFTs
        # (L ~ 8k at the reference operating point) instead of one shared
        # region-length FFT (L ~ 131k): ~5x fewer FFT FLOPs, no
        # region-sized [S, n_seq, L] complex intermediate (86 MB of HBM
        # traffic at the operating point), and the per-lane output gather
        # disappears — row q's first sym outputs ARE its lane.
        region_len = sym * n_seq + M
        Lw = sym + M  # window covering all of row q's offsets + template
        L = _fft_len(Lw)
        w = window[:, :region_len]
        if w.shape[1] < region_len:
            w = jnp.pad(w, ((0, 0), (0, region_len - w.shape[1])))
        if isinstance(seq_base, np.ndarray):
            # static bases (the single-chip path): plain slices, fused by
            # XLA into one contiguous copy
            wins = jnp.stack(
                [w[:, int(b): int(b) + Lw] for b in seq_base], axis=1
            )  # [S, n_tmpl, Lw]
        else:
            # traced bases (the 'sc'-sharded template chunks): a short
            # scan of contiguous dynamic slices (see
            # utils.gather.slice_windows)
            def _grab(carry, b):
                win = jax.lax.dynamic_slice(
                    w, (jnp.int32(0), b.astype(jnp.int32)), (S, Lw)
                )
                return carry, win

            _, wins = jax.lax.scan(_grab, 0, jnp.asarray(seq_base))
            wins = jnp.moveaxis(wins, 0, 1)  # [S, n_tmpl, Lw]
        Wf = jnp.fft.fft(wins, n=L, axis=-1)  # [S, n_tmpl, L]
        if isinstance(tmpl, np.ndarray):
            # static templates (the single-chip path): the template FFT
            # is config-constant, but XLA does NOT constant-fold the fft
            # custom-call, so the [n_tmpl, L] template FFT would re-run
            # every decode.  Precompute conj(FFT) host-side.
            # Float caveat: numpy's FFT rounds differently from XLA's in
            # ulps — same class as every dispatched-impl seam (argmax
            # consumers are tie-robust; parity tests gate the decode).
            Tfc = jnp.asarray(
                np.conj(np.fft.fft(tmpl, n=L, axis=-1)).astype(np.complex64)
            )
        else:
            # traced template chunks (the 'sc'-sharded decoder)
            Tfc = jnp.conj(jnp.fft.fft(tmpl, n=L, axis=-1))
        corr = jnp.fft.ifft(Wf * Tfc[None, :, :], axis=-1)
        # corr[r, q, i] = sum_n w[r, seq_base[q] + i + n] conj(t[q, n]):
        # i + n < sym + M = Lw <= L, so the circular lags never wrap
        vals = (
            jnp.real(corr[..., :sym]) ** 2 + jnp.imag(corr[..., :sym]) ** 2
        ).astype(jnp.float32) / np.float32(M * M)
    elif method == "direct":
        # reference-shaped: gather each M-window and dot against templates
        offs = (
            seq_base[:, None]
            + jnp.arange(sym, dtype=jnp.int32)[None, :]
        )  # [n_tmpl, sym]
        gather = offs[:, :, None] + jnp.arange(M, dtype=jnp.int32)
        wins = window[:, gather]  # [S, n_tmpl, sym, M]
        dots = jnp.einsum(
            "rqim,qm->rqi", wins, jnp.conj(tmpl),
            precision=jax.lax.Precision.HIGHEST,
        )  # [S, n_tmpl, sym]
        vals = (
            jnp.real(dots) ** 2 + jnp.imag(dots) ** 2
        ).astype(jnp.float32) / np.float32(M * M)
    else:  # pragma: no cover
        raise ValueError(f"unknown matched-filter method {method!r}")
    return vals


def finalize(
    vals: jax.Array,
    cfg: ModemConfig,
    *,
    joint: bool = False,
    keep_traces: bool = False,
) -> MatchedFilterResult:
    """Argmax + absolute-offset bookkeeping over full [S, n_seq, sym] vals."""
    S = cfg.num_streams
    sym = cfg.symbol_len
    n_seq = 1 + cfg.num_access_codes * S

    if joint:
        # pool correlation energy over all rx streams and sequences at a
        # common base offset; all peaks then sit exactly symbol_len apart —
        # the property the reference's FIXME (framing.cc:797-800) wishes
        # for but never enforces.
        score = jnp.sum(vals, axis=(0, 1))  # [sym]
        i0 = jnp.argmax(score).astype(jnp.int32)
        i_star = jnp.broadcast_to(i0, (S, n_seq)).astype(jnp.int32)
    else:
        i_star = jnp.argmax(vals, axis=-1).astype(jnp.int32)  # [S, n_seq]
    peaks = jnp.take_along_axis(vals, i_star[..., None], axis=-1)[..., 0]
    abs_idx = i_star + jnp.asarray(
        np.arange(n_seq, dtype=np.int32) * sym
    )[None, :]

    return MatchedFilterResult(
        s0_index=abs_idx[:, 0],
        s0_peak=peaks[:, 0],
        ac_index=abs_idx[:, 1:],
        ac_peak=peaks[:, 1:],
        traces=vals if keep_traces else None,
    )


def search(
    window: jax.Array,
    cfg: ModemConfig,
    *,
    method: str = "xcorr",
    joint: bool = False,
    keep_traces: bool = False,
) -> MatchedFilterResult:
    """Run the (offset, sequence, rx) correlation search.

    window: [streams, >= symbol_len*(1 + codes*streams) + M] complex — the
    replay window starting one symbol before sync_index (framing.cc:284,
    639-651; see pipeline.rx for the slicing).

    Sequence q's candidate offsets are i + symbol_len*q for i in
    [0, symbol_len) (framing.cc:707, 725: S0 at q=0, access code ac_id at
    q=ac_id+1).
    """
    S = cfg.num_streams
    n_seq = 1 + cfg.num_access_codes * S
    # numpy templates: corr_vals precomputes the template FFT host-side
    tmpl = templates(cfg)  # [n_seq, M]
    # static bases: corr_vals takes the cheap fused-slice window path
    seq_base = np.arange(n_seq, dtype=np.int32) * cfg.symbol_len
    vals = corr_vals(window, cfg, tmpl, seq_base, method=method)
    return finalize(vals, cfg, joint=joint, keep_traces=keep_traces)
