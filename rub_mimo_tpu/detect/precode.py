"""TX precoding (closed-loop beamforming) — completing the reference's
dead TX_BEAMFORMING path.

The reference sketches CSI feedback -> design_mimo_precoder -> fg.set_W(W)
-> precoded transmission, but the precoder is an empty stub and the
framegen methods don't exist (mimo/main.cc:98-102, 381-790 — would not
compile if enabled).  Here the loop is real:

  1. decode a first (non-precoded) exchange -> Ghat
  2. design a per-subcarrier ZF or MMSE precoder from Ghat
  3. transmit with the precoder applied to BOTH the TDMA access codes and
     the payload (ofdm.framegen supports `precoder=`); the receiver then
     estimates the effective channel Ghat2 = G @ P =~ I and its ordinary
     ZF detection recovers the streams transparently

Precoders are power-normalized so the per-subcarrier average transmit
power matches the unprecoded frame.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


_HIGHEST = jax.lax.Precision.HIGHEST

def _normalize(P: jax.Array) -> jax.Array:
    """Scale each subcarrier's precoder to unit average TX power per
    stream: ||P[sc]||_F^2 == n_streams."""
    n = P.shape[-1]
    fro2 = jnp.sum(jnp.real(P) ** 2 + jnp.imag(P) ** 2, axis=(-2, -1))
    scale = jnp.sqrt(n / jnp.maximum(fro2, 1e-20))
    return (P * scale[..., None, None]).astype(jnp.complex64)


def zf_precoder(G_occ: jax.Array) -> jax.Array:
    """Per-subcarrier channel-inversion precoder: P = G^{-1}, normalized.

    G_occ: [n_sc, rx, tx] -> P [n_sc, tx_antenna, stream].
    """
    return _normalize(jnp.linalg.inv(G_occ))


def mmse_precoder(G_occ: jax.Array, noise_var: float) -> jax.Array:
    """Regularized (Wiener) precoder: P = G^H (G G^H + nI)^{-1}, normalized."""
    n = G_occ.shape[-1]
    Gh = jnp.conj(jnp.swapaxes(G_occ, -1, -2))
    A = jnp.matmul(G_occ, Gh, precision=_HIGHEST) + noise_var * jnp.eye(
        n, dtype=G_occ.dtype)
    P = jnp.swapaxes(
        jnp.linalg.solve(jnp.swapaxes(A, -1, -2), jnp.conj(G_occ)), -1, -2
    )
    return _normalize(P)


def effective_channel(G_occ: jax.Array, P: jax.Array) -> jax.Array:
    """What the receiver sees after precoding: G @ P per subcarrier."""
    return jnp.matmul(G_occ, P, precision=_HIGHEST).astype(jnp.complex64)
