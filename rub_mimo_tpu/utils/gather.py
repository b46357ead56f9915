"""Batched window gathers that lower to a single XLA gather.

The obvious way to grab many M-sample windows at dynamic offsets —
``jax.vmap(lambda off, rx: lax.dynamic_slice(window[rx], (off,), (M,)))``
— is a perf trap: the vmapped row index ``window[rx]`` becomes a
batched gather of ENTIRE rows, which XLA can lower to a while loop that
materializes one full window-length copy per batch element.  Flattening
to one element-level gather of [n, length] indices avoids that.

Semantics match the dynamic_slice version exactly, including the start
clamp to [0, W - length] (out-of-range starts are clipped, not wrapped).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def gather_windows(
    arr: jax.Array, rows: jax.Array, starts: jax.Array, length: int
) -> jax.Array:
    """Stacked ``dynamic_slice(arr[rows[i]], (starts[i],), (length,))``.

    arr:    [R, W] (any dtype)
    rows:   [n] integer row ids (static or traced)
    starts: [n] integer window starts (traced); clamped to [0, W - length]
    returns [n, length]
    """
    W = arr.shape[-1]
    starts = jnp.clip(jnp.asarray(starts).astype(jnp.int32), 0, W - length)
    rows = jnp.asarray(rows).astype(jnp.int32)
    flat = arr.reshape(-1)
    idx = (
        (rows * W)[:, None]
        + starts[:, None]
        + jnp.arange(length, dtype=jnp.int32)[None, :]
    )
    return flat[idx]


def slice_windows(
    arr: jax.Array, rows: jax.Array, starts: jax.Array, length: int
) -> jax.Array:
    """Same semantics as gather_windows, implemented as a lax.scan of
    per-window dynamic_slice: a short sequence of contiguous slice
    copies instead of one large element-level gather.  Each scan step
    slices one [1, length] row window (the row index is a dynamic slice
    START, not a gather), so no full-array copies enter the loop carry.

    Prefer this for tens-of-windows extractions on the hot path; prefer
    gather_windows when the window count is large enough that the
    sequential scan dominates."""
    W = arr.shape[-1]
    starts = jnp.clip(jnp.asarray(starts).astype(jnp.int32), 0, W - length)
    rows = jnp.asarray(rows).astype(jnp.int32)

    def body(carry, rs):
        r, s = rs
        win = jax.lax.dynamic_slice(arr, (r, s), (1, length))
        return carry, win[0]

    _, wins = jax.lax.scan(body, 0, (rows, starts))
    return wins
