"""Numerically robust, parallel moving sums (streaming FIR replacement).

The reference's Schmidl&Cox detector runs liquid-dsp streaming filters one
sample at a time (firfilt_crcf/firfilt_rrrf with constant taps and a
wdelaycf delay line, mimo/framing.cc:626-637).  A length-w FIR with constant
taps is a causal moving sum; over whole capture blocks it becomes a
cumsum-difference — O(T) instead of O(T*w).

A single float32 cumsum over multi-million-sample captures loses precision
(the running sum grows unbounded while the window sum stays small), so the
moving sum is computed per overlapping chunk (overlap-save): each chunk of
length B is extended with w samples of left context, cumsum'd locally, and
differenced.  Error scales with B, not T.  The same chunking is the seam
used to shard the time axis across devices (see rub_mimo_tpu/parallel).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def moving_sum(
    x: jax.Array,
    window: int,
    *,
    block: int = 1 << 15,
    axis: int = -1,
) -> jax.Array:
    """Causal moving sum along `axis`:  out[t] = sum_{k=0}^{w-1} x[t-k],
    with zeros assumed before t=0 — exactly a length-w constant-tap FIR fed
    sample-by-sample from zero-initialized state (liquid firfilt semantics).

    Works for real and complex dtypes; any leading batch dimensions.
    """
    if axis != -1:
        x = jnp.moveaxis(x, axis, -1)
    T = x.shape[-1]
    w = int(window)
    B = max(int(block), w)
    nb = -(-T // B)  # ceil
    pad_total = nb * B - T
    # left pad with the w-sample zero history, right pad to a whole number
    # of blocks
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(w, pad_total)])
    # overlapping chunks [..., nb, B + w]
    chunks = jnp.stack(
        [xp[..., i * B : i * B + B + w] for i in range(nb)], axis=-2
    )
    cs = jnp.cumsum(chunks, axis=-1)
    out = cs[..., w : w + B] - cs[..., :B]
    out = out.reshape(*x.shape[:-1], nb * B)[..., :T]
    if axis != -1:
        out = jnp.moveaxis(out, -1, axis)
    return out


def delay(x: jax.Array, n: int, axis: int = -1) -> jax.Array:
    """Delay by n samples with zero fill (liquid wdelaycf semantics,
    framing.cc:629-630): out[t] = x[t-n], zeros for t < n."""
    if n == 0:
        return x
    pads = [(0, 0)] * x.ndim
    pads[axis] = (n, 0)
    padded = jnp.pad(x, pads)
    return jax.lax.slice_in_dim(padded, 0, x.shape[axis], axis=axis)
