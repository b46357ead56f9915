"""Ordered successive interference cancellation (MMSE V-BLAST).

Fills the gap between the linear detectors and the exhaustive lattice
search (detect.ml): ML is capped at arity^T <= 4096 combinations, so a
4x4 64-QAM system (16.7M combos) needs something smarter than MMSE but
cheaper than the lattice.  Classic V-BLAST:

  repeat T times (T = tx streams, a static Python loop under jit):
    1. MMSE filter for the still-active streams
       (A = G^H G + sigma^2 I over active columns, batched [n_sc, T, T])
    2. detect the stream with the best post-detection SINR
       (min diag(A^-1), the V-BLAST ordering rule) — per subcarrier
    3. hard-decide it, subtract its reconstructed contribution from y,
       deactivate its column

Everything is batched over (symbols x subcarriers) — the per-stream loop
is length T (2..4), so the device sees [n_sc, T, T] solves and
[n_sym, n_sc, rx] cancellations, not scalar code.  Each cancellation
removes a detected stream's interference, so later (weaker) streams see
progressively cleaner observations — the detection-order gain ZF/MMSE
leave on the table.

The emitted per-stream soft values are the unbiased MMSE outputs seen at
detection time, so downstream demapping reproduces the in-loop decisions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rub_mimo_tpu.config import ModemConfig
from rub_mimo_tpu.ofdm import constellation

_HIGHEST = jax.lax.Precision.HIGHEST


def sic_equalize(
    Y: jax.Array,
    G_occ: jax.Array,
    cfg: ModemConfig,
    noise_var: float | jax.Array = 1e-3,
) -> jax.Array:
    """Y: [n_sym, rx, n_sc], G_occ: [n_sc, rx, tx] ->
    eq [n_sym, tx, n_sc] (unbiased per-stream soft estimates)."""
    n_sc, _, T = G_occ.shape
    table = jnp.asarray(constellation.table(cfg.modulation))
    nv = jnp.asarray(noise_var, jnp.float32)

    y = jnp.moveaxis(Y, 1, 2).astype(jnp.complex64)  # [n_sym, n_sc, rx]
    G = G_occ.astype(jnp.complex64)
    active = jnp.ones((n_sc, T), bool)
    eq_out = jnp.zeros((Y.shape[0], T, n_sc), jnp.complex64)
    big = jnp.float32(3e38)
    eyeT = jnp.eye(T, dtype=jnp.complex64)

    for _ in range(T):
        Gm = G * active[:, None, :]
        Gh = jnp.conj(jnp.swapaxes(Gm, -1, -2))
        A = jnp.matmul(Gh, Gm, precision=_HIGHEST) + nv * eyeT
        inv = jnp.linalg.inv(A)                      # [n_sc, T, T]
        err = jnp.real(jnp.diagonal(inv, axis1=-2, axis2=-1))
        err = jnp.where(active, err, big)
        j = jnp.argmin(err, axis=-1)                 # [n_sc]
        onehot = jax.nn.one_hot(j, T, dtype=jnp.complex64)  # [n_sc, T]

        W0 = jnp.matmul(inv, Gh, precision=_HIGHEST)  # [n_sc, T, rx]
        w = jnp.einsum("st,str->sr", onehot, W0,
                       precision=_HIGHEST)           # row j per sc
        g_j = jnp.einsum("srt,st->sr", G, onehot,
                         precision=_HIGHEST)         # column j per sc
        d = jnp.einsum("sr,sr->s", w, g_j,
                       precision=_HIGHEST)           # bias (W0 G)_jj
        w = w / d[:, None]

        s_hat = jnp.einsum("sr,nsr->ns", w, y,
                           precision=_HIGHEST)       # [n_sym, n_sc]
        eq_out = eq_out + jnp.einsum(
            "ns,st->nts", s_hat, onehot, precision=_HIGHEST
        ).astype(jnp.complex64)

        dec = constellation.demodulate(s_hat, cfg.modulation)
        s_dec = table[dec]                           # [n_sym, n_sc]
        y = y - g_j[None] * s_dec[..., None]
        active = active & (jnp.real(onehot) < 0.5)

    return eq_out
