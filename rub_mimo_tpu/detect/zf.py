"""Zero-forcing (channel-inversion) detection, batched per subcarrier.

Array-native replacement for invert() (mimo/framing.cc:1344-1367) and its
application in execute_mimo_decode (framing.cc:557-586).  The reference's
invert() is hardcoded 2x2 ("FIXME works only for 2 x 2", framing.cc:567);
here the 2x2 closed form is replicated exactly and a general NxN path is
added (adjugate-equivalent via det * inverse), so 4x4 wideband configs are
batched solves.

Reference algebra (INVERT_TO_UNITY=false, mimo/config.h:103):
    det  = G00 G11 - G01 G10
    W    = conj(det) * adj(G)
    gain = 1 / |det|^2
so W @ y * gain == inv(G) @ y, with W and gain stored separately and both
applied in the decode hot loop (framing.cc:570-585).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def invert(G: jax.Array, invert_to_unity: bool = False) -> Tuple[jax.Array, jax.Array]:
    """Per-subcarrier equalizer from channel estimate.

    G: [..., N, N] (leading dims = subcarriers etc.)
    Returns (W [..., N, N], normalize_gain [...]).
    """
    N = G.shape[-1]
    if N == 2:
        g00, g01 = G[..., 0, 0], G[..., 0, 1]
        g10, g11 = G[..., 1, 0], G[..., 1, 1]
        det = g00 * g11 - g01 * g10
        det_inv = 1.0 / det if invert_to_unity else jnp.conj(det)
        W = jnp.stack(
            [
                jnp.stack([det_inv * g11, -det_inv * g01], axis=-1),
                jnp.stack([-det_inv * g10, det_inv * g00], axis=-1),
            ],
            axis=-2,
        )
    else:
        det = jnp.linalg.det(G)
        adj = jnp.linalg.inv(G) * det[..., None, None]
        det_inv = (1.0 / det if invert_to_unity else jnp.conj(det))[
            ..., None, None
        ]
        W = det_inv * adj
    if invert_to_unity:
        gain = jnp.ones(G.shape[:-2], dtype=jnp.float32)
    else:
        gain = (
            1.0
            / (jnp.real(det) ** 2 + jnp.imag(det) ** 2)
        ).astype(jnp.float32)
    return W.astype(jnp.complex64), gain


def equalize(
    Y: jax.Array, W: jax.Array, gain: jax.Array
) -> jax.Array:
    """Apply the equalizer to received frequency-domain symbols.

    Y:    [..., n_streams, n_sc]  (rx streams)
    W:    [n_sc, n_out, n_streams]
    gain: [n_sc]
    returns [..., n_out, n_sc] — x[out, sc] = gain[sc] * sum_j W[sc,out,j] Y[j,sc]
    (framing.cc:570-585).

    Formulation note: the per-subcarrier contraction is written as an
    UNROLLED broadcast multiply-add over the (small, static) rx-stream
    axis rather than an einsum: with K = n_streams = 2 a matmul has
    nothing to do, and the unrolled form fuses into one elementwise
    pass over Y with exact float32 products.
    """
    S = W.shape[-1]
    Wt = jnp.moveaxis(W, 0, -1)  # [n_out, n_streams, n_sc]
    eq = Wt[..., 0, :] * Y[..., 0, None, :]
    for j in range(1, S):
        eq = eq + Wt[..., j, :] * Y[..., j, None, :]
    return (eq * gain[None, :]).astype(jnp.complex64)
