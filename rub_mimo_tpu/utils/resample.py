"""Fractional resampling for sampling-clock (SFO) impairment/correction.

The reference has no SFO handling at all — its two B210s share a 10 MHz
reference via the clock_source setting (mimo/main.cc:270-276), sidestepping
clock offset in hardware.  A file-replay framework must model and correct
it numerically instead.

Two grades:

- resample_linear: one gather + fma, O(T).  Fine for signals with little
  energy near Nyquist, but an all-carriers OFDM waveform (the reference
  default) occupies the FULL band, and linear interpolation's midpoint
  gain at Nyquist is cos(pi/2) = 0 — it silently erases edge subcarriers.
- resample_bandlimited: exact FFT 4x upsampling (zero-stuffed spectrum)
  followed by Catmull-Rom cubic interpolation on the dense grid; worst-bin
  error falls to ~1e-3 amplitude.  This is the one the SFO paths use.
"""

from __future__ import annotations

import functools
from typing import List

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def resample_linear(x: jax.Array, factor: float | jax.Array) -> jax.Array:
    """Evaluate x at positions t * factor, t = 0..T-1 (same length out).

    x: [..., T] complex64 or float32.  Positions past the end clamp to the
    last sample (the tail is padding/noise in every use here).

    Precision note: positions are computed as t + t*(factor-1) so the
    fractional part keeps full float32 resolution even at t in the
    millions (t itself is exact below 2^24; the t*(factor-1) correction is
    small for ppm-scale factors) — a naive float32 t*factor would quantize
    the interpolation phase to whole samples beyond t ~ 2^23.
    """
    T = x.shape[-1]
    t = jnp.arange(T, dtype=jnp.float32)
    off = t * (jnp.asarray(factor, jnp.float32) - 1.0)   # small for ~ppm
    shift = jnp.floor(off)
    frac = off - shift
    i0 = jnp.clip(jnp.arange(T, dtype=jnp.int32) + shift.astype(jnp.int32),
                  0, T - 1)
    i1 = jnp.minimum(i0 + 1, T - 1)
    a = x[..., i0]
    b = x[..., i1]
    return (a + (b - a) * frac).astype(x.dtype)


def _fft_upsample(x: jax.Array, up: int) -> jax.Array:
    """Exact band-limited upsampling by integer `up`: zero-stuff the
    spectrum (splitting the Nyquist bin symmetrically for even T).
    Any length T: the FFT takes it as it is."""
    T = x.shape[-1]
    X = jnp.fft.fft(x.astype(jnp.complex64), axis=-1)
    h = T // 2
    if T % 2 == 0:
        lead = X[..., :h]          # bins 0 .. h-1
        tail = X[..., h + 1 :]     # bins -(h-1) .. -1
        nyq = X[..., h : h + 1] * 0.5
        mid_z = jnp.zeros(x.shape[:-1] + (up * T - T - 1,), X.dtype)
        Xu = jnp.concatenate([lead, nyq, mid_z, nyq, tail], axis=-1)
    else:
        lead = X[..., : h + 1]     # bins 0 .. +h (all positive freqs)
        tail = X[..., h + 1 :]     # bins -h .. -1
        mid_z = jnp.zeros(x.shape[:-1] + (up * T - T,), X.dtype)
        Xu = jnp.concatenate([lead, mid_z, tail], axis=-1)
    return jnp.fft.ifft(Xu, axis=-1) * up


@jax.jit
def resample_bandlimited(
    x: jax.Array, factor: float | jax.Array
) -> jax.Array:
    """Evaluate x at positions t * factor with band-limited accuracy:
    FFT 4x upsample, then Catmull-Rom cubic on the dense grid.  Intended
    for |factor - 1| at ppm..1e-3 scale (the gather index never strays
    more than a few samples from 4t, but any factor works).
    """
    up = 4
    T = x.shape[-1]
    xu = _fft_upsample(x, up)                           # [..., 4T]
    Tu = up * T

    t = jnp.arange(T, dtype=jnp.float32)
    # dense-grid positions 4 * t * factor, split for f32 precision:
    # base 4t is exact; the correction 4t(factor-1) is small
    off = t * (jnp.asarray(factor, jnp.float32) - 1.0) * up
    shift = jnp.floor(off)
    frac = off - shift                                   # in [0, 1)
    i1 = jnp.arange(T, dtype=jnp.int32) * up + shift.astype(jnp.int32)
    i0 = jnp.clip(i1 - 1, 0, Tu - 1)
    i2 = jnp.clip(i1 + 1, 0, Tu - 1)
    i3 = jnp.clip(i1 + 2, 0, Tu - 1)
    i1 = jnp.clip(i1, 0, Tu - 1)

    p0, p1, p2, p3 = xu[..., i0], xu[..., i1], xu[..., i2], xu[..., i3]
    u = frac
    # Catmull-Rom coefficients
    c0 = -0.5 * u * (1 - u) * (1 - u)
    c1 = 1 + u * u * (1.5 * u - 2.5)
    c2 = u * (0.5 + u * (2.0 - 1.5 * u))
    c3 = 0.5 * u * u * (u - 1)
    out = p0 * c0 + p1 * c1 + p2 * c2 + p3 * c3
    if not jnp.issubdtype(x.dtype, jnp.complexfloating):
        out = jnp.real(out)
    return out.astype(x.dtype)


@jax.jit
def _srs_mask_tail(chunk, n_real):
    """Zero every output sample at index >= n_real."""
    j = jnp.arange(chunk.shape[-1], dtype=jnp.int32)
    return jnp.where(j[None, :] < n_real, chunk, jnp.complex64(0.0))


@functools.partial(jax.jit, static_argnames=("R", "C"))
def _srs_write(ring, chunk, gpos, R, C):
    """Write chunk at absolute-modulo ring slots (sample g <-> slot g%R)."""
    idx = (gpos + jnp.arange(C, dtype=jnp.int32)) % R
    return ring.at[:, idx].set(chunk)


@functools.partial(jax.jit, static_argnames=("R", "L", "C", "up"))
def _srs_window_resample(ring, win_start, rel0, f_minus_1, R, L, C, up=4):
    """Interpolate C output samples from the input ring.

    Window = ring[win_start : win_start+L] (absolute-modulo addressing),
    FFT-4x upsampled; output j sits at window-relative input position
    rel0 + j + j*f_minus_1 (rel0 in [margin, margin+1), so the cubic
    stencil stays inside the guard band).  Same split-position precision
    trick as resample_bandlimited."""
    idx = (win_start + jnp.arange(L, dtype=jnp.int32)) % R
    window = ring[:, idx]
    xu = _fft_upsample(window, up)  # [S, up*L]
    Tu = up * L
    j = jnp.arange(C, dtype=jnp.float32)
    off = (rel0 + j * f_minus_1) * up          # small: <= (margin+1+drift)*4
    shift = jnp.floor(off)
    frac = off - shift
    i1 = jnp.arange(C, dtype=jnp.int32) * up + shift.astype(jnp.int32)
    i0 = jnp.clip(i1 - 1, 0, Tu - 1)
    i2 = jnp.clip(i1 + 1, 0, Tu - 1)
    i3 = jnp.clip(i1 + 2, 0, Tu - 1)
    i1 = jnp.clip(i1, 0, Tu - 1)
    p0, p1, p2, p3 = xu[:, i0], xu[:, i1], xu[:, i2], xu[:, i3]
    u = frac
    c0 = -0.5 * u * (1 - u) * (1 - u)
    c1 = 1 + u * u * (1.5 * u - 2.5)
    c2 = u * (0.5 + u * (2.0 - 1.5 * u))
    c3 = 0.5 * u * u * (u - 1)
    out = p0 * c0 + p1 * c1 + p2 * c2 + p3 * c3
    return out.astype(window.dtype)


class StreamingResampler:
    """Chunked band-limited fractional resampler with carried state —
    the live analog of resample_bandlimited for the streaming pipeline
    (pipeline.streaming with sfo_correct): input arrives in fixed-size
    chunks; output sample n is the input evaluated at a continuous
    cursor q advanced by `factor` per output sample, so set_factor()
    retunes mid-stream (e.g. per-burst SFO refinement) WITHOUT a
    position jump — the carried fractional phase is exactly the state
    the offline two-pass resampler keeps implicitly in its global
    position formula.

    Each output chunk interpolates an FFT-4x-upsampled window of the
    input ring with `margin` guard samples absorbing the windowed
    upsampling's periodic-extension leakage; middle-band tones match the
    whole-capture resample_bandlimited to ~1e-3 amplitude
    (tests/test_sfo_streaming.py).
    """

    def __init__(self, n_streams: int, chunk_size: int,
                 factor: float = 1.0, margin: int = 256,
                 origin: int = 0):
        """origin: global position where this resampler takes over a
        stream mid-flight (input and output positions coincide there) —
        used when SFO correction engages after a burst has already been
        consumed raw."""
        self.S = int(n_streams)
        self.C = int(chunk_size)
        self.margin = int(margin)
        self.factor = float(factor)
        self.L = self.C + 2 * self.margin + 16
        self.R = 3 * self.C + 8 * self.margin + 64
        self._ring = jax.jit(
            lambda: jnp.zeros((self.S, self.R), jnp.complex64)
        )()
        self._in_end = int(origin)  # input samples received (global)
        self._q = float(origin)     # input-position cursor (f64 host state)
        self._out_next = int(origin)  # output samples emitted (global)

    def set_factor(self, factor: float) -> None:
        """Retune the resampling ratio; takes effect from the next output
        sample (the cursor is continuous across the change)."""
        self.factor = float(factor)

    def preload_history(self, chunk, gpos: int) -> None:
        """Write an already-received [S, C] input chunk at positions
        [gpos, gpos+C) BEFORE the origin — seam backfill when the
        resampler takes over a stream mid-flight, so the first output
        window interpolates real history instead of zeros."""
        if chunk.shape != (self.S, self.C):
            raise ValueError(f"chunk must be [{self.S}, {self.C}]")
        if isinstance(chunk, np.ndarray):
            chunk = jnp.asarray(chunk)
        self._ring = _srs_write(
            self._ring, chunk, jnp.int32(gpos % self.R), self.R, self.C,
        )

    def flush(self) -> List[jax.Array]:
        """Zero-pad the input so every output sample whose position falls
        within the real input is emitted.  Output positions BEYOND the
        real input are forced to exact zeros: the windowed upsampler's
        sinc ringing into the pad region is smooth and self-correlated at
        every lag, which would otherwise read as a Schmidl&Cox plateau
        (a false sync) downstream."""
        real_end = self._in_end
        out: List[jax.Array] = []
        zero = jax.jit(lambda: jnp.zeros((self.S, self.C), jnp.complex64))()
        # enough padding to cover the window lookahead of the last
        # real-input output position
        for _ in range(2 + (self.L // self.C)):
            out += self.push(zero, _mask_beyond=real_end)
        return out

    def push(self, chunk, _mask_beyond: int | None = None):
        """Feed one [S, C] input chunk; returns the list of completed
        [S, C] output chunks now producible."""
        if chunk.shape != (self.S, self.C):
            raise ValueError(f"chunk must be [{self.S}, {self.C}]")
        if isinstance(chunk, np.ndarray):
            chunk = jnp.asarray(chunk)
        self._ring = _srs_write(
            self._ring, chunk, jnp.int32(self._in_end % self.R),
            self.R, self.C,
        )
        self._in_end += self.C
        return self._drain(_mask_beyond)

    def _drain(self, mask_beyond: int | None = None) -> List[jax.Array]:
        out: List[jax.Array] = []
        while True:
            win_start = int(np.floor(self._q)) - self.margin
            if win_start + self.L > self._in_end:
                break
            rel0 = self._q - win_start  # in [margin, margin+1)
            chunk = _srs_window_resample(
                self._ring, jnp.int32(win_start % self.R),
                jnp.float32(rel0), jnp.float32(self.factor - 1.0),
                self.R, self.L, self.C,
            )
            if mask_beyond is not None:
                # number of output samples whose input position q + j*f
                # is still inside the real input
                n_real = int(np.clip(
                    np.ceil((mask_beyond - self._q) / self.factor), 0,
                    self.C,
                ))
                if n_real < self.C:
                    chunk = _srs_mask_tail(chunk, jnp.int32(n_real))
            out.append(chunk)
            self._q += self.C * self.factor
            self._out_next += self.C
        return out
