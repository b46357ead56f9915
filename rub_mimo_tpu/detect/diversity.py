"""Receive diversity (maximum-ratio combining) — MODE_RX_DIVERSITY.

The GUI's mode enum lists MODE_RX_DIVERSITY (Interface/types.h:21-26) but
the reference never implements it.  Here: a single TX stream is received
on all antennas and combined with MRC per subcarrier,

    xhat[sc] = sum_r conj(g_r[sc]) y_r[sc] / sum_r |g_r[sc]|^2

the SNR-optimal linear combiner for one stream.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def mrc_combine(Y: jax.Array, G_occ: jax.Array, tx_stream: int) -> jax.Array:
    """Y: [..., n_rx, n_sc]; G_occ: [n_sc, rx, tx] -> [..., n_sc]."""
    g = G_occ[:, :, tx_stream]  # [n_sc, rx]
    denom = jnp.sum(jnp.real(g) ** 2 + jnp.imag(g) ** 2, axis=-1)  # [n_sc]
    num = jnp.einsum("sr,...rs->...s", jnp.conj(g), Y,
                     precision=jax.lax.Precision.HIGHEST)
    return (num / denom[None, :]).astype(jnp.complex64)
