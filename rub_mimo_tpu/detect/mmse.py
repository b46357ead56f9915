"""Linear MMSE detection — a new capability beyond the reference.

The reference only implements ZF (mimo/framing.cc:1344-1367); its types.h
mode list and the BASELINE configs call for an MMSE detector as well.  The
MMSE equalizer per subcarrier is

    W = G^H (G G^H + sigma^2 I)^{-1}

which regularizes the inversion at subcarriers where ZF blows up noise
(|det| small).  Batched over all subcarriers as one solve.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

_HIGHEST = jax.lax.Precision.HIGHEST


def mmse_weights(G: jax.Array, noise_var: float | jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Per-subcarrier MMSE equalizer.

    G: [..., N, N] channel (rx x tx).  Returns (W [..., N, N], gain [...])
    with gain == 1 so the result plugs into detect.zf.equalize unchanged.
    """
    N = G.shape[-1]
    Gh = jnp.conj(jnp.swapaxes(G, -1, -2))
    A = jnp.matmul(G, Gh, precision=_HIGHEST) + noise_var * jnp.eye(
        N, dtype=G.dtype)
    # W0 = G^H A^{-1}  ==  solve(A^T, G*)^T  — use solve for stability
    W0 = jnp.swapaxes(
        jnp.linalg.solve(jnp.swapaxes(A, -1, -2), jnp.conj(G)), -1, -2
    )
    # Unbiased MMSE: the raw estimator shrinks each stream by
    # d_k = (W0 G)_kk < 1, which breaks hard-decision QAM demapping.
    # Normalize rows by 1/d_k so decisions are unbiased.
    d = jnp.einsum("...ij,...ji->...i", W0, G, precision=_HIGHEST)
    W = W0 / d[..., :, None]
    gain = jnp.ones(G.shape[:-2], dtype=jnp.float32)
    return W.astype(jnp.complex64), gain
