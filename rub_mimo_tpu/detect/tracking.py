"""Decision-directed channel tracking for long payload streams.

The reference estimates the channel ONCE from the preamble and equalizes
all 1000 payload frames with it (framing.cc:826-868) — correct for its
static-lab setup, but a real link drifts (oscillator phase, motion).
track_phase fixes COMMON phase error only; this module tracks the full
per-subcarrier MIMO matrix across the payload:

  blocks of `block_frames` OFDM symbols are processed sequentially
  (lax.scan; each step batched over all subcarriers):

    1. equalize the block with the carried Ghat (ZF)
    2. hard decisions -> remodulated reference symbols s_hat
    3. per-subcarrier LS refit:  G_new = (sum_n y s^H) (sum_n s s^H + eI)^-1
    4. exponential update:       G <- (1-alpha) G + alpha G_new

Tracking follows drift as long as the per-block decision quality stays
reasonable; the scan is over ~pid_max/block_frames steps, each a batched
[n_sc, S, S] solve — negligible cost next to the FFTs.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from rub_mimo_tpu.config import ModemConfig
from rub_mimo_tpu.detect import zf as zf_mod
from rub_mimo_tpu.ofdm import constellation

_HIGHEST = jax.lax.Precision.HIGHEST


def ls_refit(
    Yblk: jax.Array,
    s_hat: jax.Array,
    ridge: float = 1e-3,
) -> jax.Array:
    """Per-subcarrier LS channel refit from decisions.

    Yblk, s_hat: [B, S, n_sc] (set unowned symbols to zero in BOTH to
    exclude them).  Returns G_new [n_sc, S, S].
    """
    S = Yblk.shape[1]
    eye = jnp.eye(S, dtype=jnp.complex64)
    A = jnp.einsum("nts,nus->stu", s_hat, jnp.conj(s_hat),
                   precision=_HIGHEST)
    B = jnp.einsum("nrs,nus->sru", Yblk, jnp.conj(s_hat),
                   precision=_HIGHEST)
    return jnp.matmul(B, jnp.linalg.inv(A + ridge * eye),
                      precision=_HIGHEST)


def track_and_equalize(
    Y: jax.Array,
    G0: jax.Array,
    cfg: ModemConfig,
    *,
    block_frames: int = 16,
    alpha: float = 0.5,
    ridge: float = 1e-3,
) -> Tuple[jax.Array, jax.Array]:
    """Sequentially equalize Y with a tracked channel estimate.

    Y:  [n_sym, S, n_sc] received frequency-domain symbols
    G0: [n_sc, S, S] initial (preamble) channel estimate
    returns (eq [n_sym, S, n_sc], G_last [n_sc, S, S])

    n_sym must be divisible by block_frames (pad/mask upstream if not).
    """
    n_sym, S, n_sc = Y.shape
    nb = n_sym // block_frames
    Yb = Y.reshape(nb, block_frames, S, n_sc)
    table = jnp.asarray(constellation.table(cfg.modulation))

    def body(G, Yblk):
        W, gain = zf_mod.invert(G, cfg.invert_to_unity)
        eq = zf_mod.equalize(Yblk, W, gain)  # [B, S, n_sc]
        d = constellation.demodulate(eq, cfg.modulation)
        s_hat = table[d]  # [B, S, n_sc]
        G_new = ls_refit(Yblk, s_hat, ridge)
        G = ((1.0 - alpha) * G + alpha * G_new).astype(jnp.complex64)
        return G, eq

    G_last, eqs = jax.lax.scan(body, G0.astype(jnp.complex64), Yb)
    return eqs.reshape(n_sym, S, n_sc), G_last
