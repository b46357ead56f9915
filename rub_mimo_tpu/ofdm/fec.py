"""Forward error correction: convolutional coding + batched Viterbi.

New capability beyond the reference (its modem is uncoded — symbols go
straight from rand()%ARITY to the air, mimo/main.cc:1235-1238, and errors
are only *counted*, main.cc:1403-1411).  This module adds the classic
rate-1/2 constraint-length-7 convolutional code (generators 171/133
octal — the 802.11a/Voyager code) with a soft-decision Viterbi decoder,
closing the loop from the pipeline's max-log-MAP LLRs
(ofdm/constellation.soft_demodulate_llr) to corrected bits.

Array-native design: the trellis is dense tensor arithmetic —

  - the add-compare-select step updates all 64 path metrics at once as
    two gathers + a [64]-wide max (the state butterfly), scanned over
    time with lax.scan;
  - independent codewords (per stream / per capture) batch along a
    leading axis through the same scan, so each step is [batch, 64]
    wide;
  - branch metrics are one static [64, 2]-sign matmul against the
    per-step LLR pair.

Traceback is a second (reversed) scan over the stored per-step winner
bits.  Termination: the encoder appends K-1 zero tail bits so the final
state is 0; the decoder pins both the start and end state.

LLR convention matches soft_demodulate_llr: llr = logP(bit=0) - logP(bit=1)
(positive -> bit 0), bits packed MSB-first within each symbol.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rub_mimo_tpu.config import ModemConfig, Modulation

_HIGHEST = jax.lax.Precision.HIGHEST

K = 7                      # constraint length
POLYS = (0o171, 0o133)     # generator polynomials, MSB = current input
RATE_DEN = 2               # mother code rate 1/2
N_STATES = 1 << (K - 1)    # 64
TAIL = K - 1

# 802.11a puncturing patterns over the interleaved (A1 B1 A2 B2 ...) coded
# stream; 1 = transmit, 0 = puncture (depunctured as zero-LLR at RX)
PUNCTURE = {
    "1/2": None,
    "2/3": (1, 1, 1, 0),
    "3/4": (1, 1, 1, 0, 0, 1),
}


def _kept_bits(L: int, rate: str) -> int:
    """Punctured (transmitted) length of an L-bit mother-coded stream."""
    pat = PUNCTURE[rate]
    if pat is None:
        return L
    P = len(pat)
    return (L // P) * sum(pat) + sum(pat[: L % P])


def puncture(coded: jax.Array, rate: str) -> jax.Array:
    """[..., L] mother-coded bits -> [..., kept] transmitted bits."""
    pat = PUNCTURE[rate]
    if pat is None:
        return coded
    L = coded.shape[-1]
    mask = np.tile(np.asarray(pat, bool), -(-L // len(pat)))[:L]
    return coded[..., np.flatnonzero(mask)]


def depuncture_llrs(llrs: jax.Array, L: int, rate: str) -> jax.Array:
    """[..., kept] received LLRs -> [..., L] with zero LLRs (erasures) at
    the punctured positions."""
    pat = PUNCTURE[rate]
    if pat is None:
        return llrs[..., :L]
    mask = np.tile(np.asarray(pat, bool), -(-L // len(pat)))[:L]
    out = jnp.zeros(llrs.shape[:-1] + (L,), llrs.dtype)
    return out.at[..., np.flatnonzero(mask)].set(
        llrs[..., : int(mask.sum())]
    )


def _parity(x: np.ndarray) -> np.ndarray:
    p = np.zeros_like(x)
    while np.any(x):
        p ^= x & 1
        x >>= 1
    return p


@functools.lru_cache(maxsize=None)
def _trellis() -> Tuple[np.ndarray, np.ndarray]:
    """(out_bits [N_STATES, 2, 2], next_state [N_STATES, 2]).

    Standard shift-register convention (new bit enters at the MSB): the
    state holds the K-1 most recent input bits [b_{t-1} .. b_{t-6}]
    MSB-first, the full register is (u << (K-1)) | s =
    [b_t, b_{t-1}, .., b_{t-6}], and next_state[s, u] =
    (s >> 1) | (u << (K-2)).  out_bits[s, u] = parity(register & poly).
    """
    s = np.arange(N_STATES)[:, None]          # [64, 1]
    u = np.arange(2)[None, :]                 # [1, 2]
    reg = (u << (K - 1)) | s                  # [64, 2] full K-bit register
    outs = np.stack([_parity(reg & g) for g in POLYS], axis=-1)  # [64,2,2]
    nxt = (s >> 1) | (u << (K - 2))
    return outs.astype(np.int32), nxt.astype(np.int32)


def conv_encode(bits: jax.Array) -> jax.Array:
    """Rate-1/2 K=7 encoder with zero-tail termination.

    bits: [..., n] in {0,1}  ->  coded [..., 2 * (n + TAIL)].

    Pure convolution form (no scan needed at TX): coded bit j of output
    stream g at time t is parity(window[t] & poly_g) where window[t] is
    the K newest-first input bits.
    """
    bits = bits.astype(jnp.int32)
    n = bits.shape[-1]
    padded = jnp.concatenate(
        [jnp.zeros(bits.shape[:-1] + (K - 1,), jnp.int32), bits,
         jnp.zeros(bits.shape[:-1] + (TAIL,), jnp.int32)],
        axis=-1,
    )
    total = n + TAIL
    # windows[..., t, k] = input bit t - k (k=0 is the current bit)
    idx = (np.arange(total)[:, None] + (K - 1) - np.arange(K)[None, :])
    windows = padded[..., idx]                       # [..., total, K]
    taps = np.stack(
        [[(g >> (K - 1 - k)) & 1 for k in range(K)] for g in POLYS]
    )                                                # [2, K], MSB = current
    coded = (windows @ jnp.asarray(taps.T, jnp.int32)) & 1  # [..., total, 2]
    return coded.reshape(*bits.shape[:-1], 2 * total)


def _viterbi_pairs(pairs: jax.Array, pm0: jax.Array,
                   end_state: jax.Array | int) -> jax.Array:
    """Core Viterbi over llr pairs [T, 2] with a parameterized initial
    path metric and traceback start state; returns bits [T]."""
    outs, _ = _trellis()

    sp = np.arange(N_STATES)
    p0 = (sp << 1) & (N_STATES - 1)
    p1 = p0 | 1
    u = sp >> (K - 2)
    sign0 = jnp.asarray((1.0 - 2.0 * outs[p0, u]) * 0.5)   # [64, 2]
    sign1 = jnp.asarray((1.0 - 2.0 * outs[p1, u]) * 0.5)
    p0j, p1j = jnp.asarray(p0), jnp.asarray(p1)

    def step(pm, pair):
        cand0 = pm[p0j] + jnp.matmul(sign0, pair, precision=_HIGHEST)
        cand1 = pm[p1j] + jnp.matmul(sign1, pair, precision=_HIGHEST)
        take1 = cand1 > cand0
        pm_new = jnp.where(take1, cand1, cand0)
        # renormalize so long codewords don't overflow float32
        pm_new = pm_new - jnp.max(pm_new)
        return pm_new, take1

    pm_f, decisions = jax.lax.scan(step, pm0, pairs)

    start = jnp.where(
        jnp.asarray(end_state, jnp.int32) >= 0,
        jnp.asarray(end_state, jnp.int32),
        jnp.argmax(pm_f).astype(jnp.int32),
    )

    def back(state, dec_t):
        took1 = dec_t[state]
        bit = state >> (K - 2)                        # input bit consumed
        prev = ((state << 1) & (N_STATES - 1)) | took1.astype(jnp.int32)
        return prev.astype(jnp.int32), bit.astype(jnp.int32)

    _, bits_rev = jax.lax.scan(back, start, decisions, reverse=True)
    return bits_rev


def _viterbi_1d(llrs: jax.Array) -> jax.Array:
    """Soft Viterbi over one codeword: llrs [2*T] -> bits [T] (incl. tail).

    Known start state 0 (encoder reset) and traceback from state 0
    (zero-tail termination)."""
    T = llrs.shape[0] // 2
    pairs = llrs.reshape(T, 2).astype(jnp.float32)
    pm0 = jnp.full((N_STATES,), jnp.float32(-1e30)).at[0].set(0.0)
    return _viterbi_pairs(pairs, pm0, 0)


_PAD_LLR = 1e4  # "coded bit is certainly 0" — consistent with both the
                # encoder reset (all-zero history) and the zero tail


@functools.partial(jax.jit, static_argnames=("window", "margin"))
def _viterbi_windowed_1d(llrs: jax.Array, window: int,
                         margin: int) -> jax.Array:
    """Block-parallel Viterbi: overlapping windows decoded as ONE
    batched scan of length window + 2*margin, keeping each window's
    interior.

    The sequential scan over the whole codeword is the throughput wall
    of FEC serving (a 10M-step scan ran ~17 s on chip at the reference
    operating point).  Path decisions converge within ~5 constraint
    lengths, so with margin >> 5*(K-1) = 30 the interior decisions
    match the full Viterbi except in adversarial noise (pinned equal on
    noisy random payloads in tests/test_fec.py).  Pad llrs are +_PAD_LLR
    ("certainly 0"): exactly the encoder-reset prior on the left of
    window 0 and the zero-tail on the right of the last window, so
    every window runs the same uniform-prior, argmax-traceback program
    — fully batched, no special cases."""
    T = llrs.shape[0] // 2
    pairs = llrs.reshape(T, 2).astype(jnp.float32)
    W = window
    B = -(-T // W)
    padded = jnp.full((B * W + 2 * margin, 2), jnp.float32(_PAD_LLR))
    padded = jax.lax.dynamic_update_slice(
        padded, pairs, (margin, 0))
    idx = (np.arange(B)[:, None] * W
           + np.arange(W + 2 * margin)[None, :])
    wins = padded[idx]                        # [B, W + 2*margin, 2]
    pm0 = jnp.zeros((N_STATES,), jnp.float32)  # uniform prior
    bits = jax.vmap(
        lambda w: _viterbi_pairs(w, pm0, -1)   # argmax traceback
    )(wins)                                    # [B, W + 2*margin]
    return bits[:, margin : margin + W].reshape(B * W)[:T]


@functools.partial(jax.jit, static_argnames=("window", "margin"))
def viterbi_decode(llrs: jax.Array, window: int | None = None,
                   margin: int = 128) -> jax.Array:
    """Soft-decision Viterbi.  llrs [..., 2*(n+TAIL)] -> bits [..., n]
    (tail stripped).  Leading axes are batched through one scan.

    window=None decodes each codeword with one full-length scan (the
    exact maximum-likelihood path); an integer window uses the
    block-parallel windowed decoder (see _viterbi_windowed_1d) — the
    serving-throughput mode for long codewords."""
    shape = llrs.shape
    flat = llrs.reshape(-1, shape[-1])
    if window is None:
        bits = jax.vmap(_viterbi_1d)(flat)           # [B, n + TAIL]
    else:
        bits = jax.vmap(
            lambda v: _viterbi_windowed_1d(v, window, margin)
        )(flat)
    return bits[:, : bits.shape[-1] - TAIL].reshape(*shape[:-1], -1)


# --------------------------------------------------------------- packing
def bits_to_symbols(bits: jax.Array, modulation: Modulation) -> jax.Array:
    """Pack bits (MSB-first, matching soft_demodulate_llr's order) into
    integer symbols: [..., n*b] -> [..., n]."""
    b = modulation.bits_per_symbol
    g = bits.reshape(*bits.shape[:-1], -1, b).astype(jnp.int32)
    weights = jnp.asarray(1 << np.arange(b - 1, -1, -1), jnp.int32)
    return g @ weights


def symbols_to_bits(symbols: jax.Array, modulation: Modulation) -> jax.Array:
    b = modulation.bits_per_symbol
    shifts = np.arange(b - 1, -1, -1)
    bits = (symbols[..., None] >> jnp.asarray(shifts)) & 1
    return bits.reshape(*symbols.shape[:-1], -1).astype(jnp.int32)


# ------------------------------------------------------- interleaving
@functools.lru_cache(maxsize=None)
def _interleave_perm(n: int, spread: int) -> np.ndarray:
    """Stride permutation: out[i] = in[perm[i]] with perm[i] = (i * s) % n
    for the smallest s >= spread coprime to n — adjacent coded bits land
    ~s positions apart, so a burst of b bad symbols touches trellis
    positions spaced far beyond the K=7 memory."""
    s = max(int(spread), 1)
    while np.gcd(s, n) != 1:
        s += 1
    return (np.arange(n, dtype=np.int64) * s) % n


def interleave(bits: jax.Array, spread: int) -> jax.Array:
    """[..., n] -> [..., n] stride interleaver (pair with deinterleave)."""
    perm = _interleave_perm(bits.shape[-1], spread)
    return bits[..., perm]


def deinterleave(x: jax.Array, spread: int) -> jax.Array:
    perm = _interleave_perm(x.shape[-1], spread)
    inv = np.argsort(perm)
    return x[..., inv]


# ----------------------------------------------------- payload plumbing
def _lanes(cfg: ModemConfig) -> Tuple[list, list]:
    """(tx lanes carrying data, rx output lanes) — mirrors the one-
    logical-stream conventions of framegen.generate_payload_symbols and
    report.score."""
    mode = cfg.mode.value
    if mode == "siso":
        return [cfg.siso_tx], [cfg.siso_rx]
    if mode == "rx_diversity":
        return [cfg.siso_tx], [cfg.siso_tx]
    if mode == "alamouti":
        return [0], [0]
    return list(range(cfg.num_streams)), list(range(cfg.num_streams))


def message_bits_per_stream(cfg: ModemConfig, rate: str = "1/2") -> int:
    """Message payload (info bits) per stream at the given code rate
    (mother 1/2 + optional puncturing + tail) over the
    pid_max * M_occupied symbol budget."""
    budget = cfg.pid_max * cfg.M_occupied * cfg.modulation.bits_per_symbol
    if PUNCTURE[rate] is None:
        return budget // RATE_DEN - TAIL
    # largest n with kept(2 * (n + TAIL)) <= budget
    pat = PUNCTURE[rate]
    n = (budget * len(pat)) // (2 * sum(pat)) - TAIL
    while _kept_bits(2 * (n + TAIL), rate) > budget:
        n -= 1
    while _kept_bits(2 * (n + 1 + TAIL), rate) <= budget:
        n += 1
    return n


INTERLEAVE_SPREAD = 127


def encode_payload(
    cfg: ModemConfig, seed: int = 0, *, interleave_bits: bool = True,
    rate: str = "1/2",
) -> Tuple[np.ndarray, np.ndarray]:
    """Random coded payload: returns (msg_bits [n_lanes, n_msg] int32,
    tx_data [num_streams, pid_max * M_occupied] int32 symbols) where
    n_lanes follows the mode's logical-stream convention.  Coded bits
    beyond an exact symbol multiple are zero-padded (and simply unused by
    the decoder).  interleave_bits spreads adjacent coded bits across
    far-apart payload symbols so per-subcarrier fades decorrelate at the
    trellis (on by default; decode_payload must match).  rate selects
    802.11a puncturing: '1/2', '2/3', '3/4'."""
    rng = np.random.default_rng(seed)
    n_msg = message_bits_per_stream(cfg, rate)
    tx_lanes, _ = _lanes(cfg)
    msg = rng.integers(
        0, 2, size=(len(tx_lanes), n_msg), dtype=np.int64
    ).astype(np.int32)
    return msg, _msg_to_tx_data(msg, cfg, rate, interleave_bits)


# ------------------------------------------------------- data transport
_HEADER_BITS = 64  # 32-bit length (bytes) + 32-bit CRC-32


def data_capacity_bytes(cfg: ModemConfig, rate: str = "1/2") -> int:
    """Max user-data bytes one coded payload carries (all lanes pooled,
    minus the length+CRC header).  0 means the config cannot even carry
    the header (encode_data refuses such configs)."""
    tx_lanes, _ = _lanes(cfg)
    total_bits = len(tx_lanes) * message_bits_per_stream(cfg, rate)
    if total_bits < _HEADER_BITS:
        return 0
    return (total_bits - _HEADER_BITS) // 8


def _msg_to_tx_data(
    msg: np.ndarray, cfg: ModemConfig, rate: str, interleave_bits: bool
) -> np.ndarray:
    """[n_lanes, n_msg] message bits -> tx_data [num_streams, n_sym]
    symbols (encode -> puncture -> pad -> interleave -> pack -> lane
    scatter) — the one coding tail shared by encode_payload/encode_data."""
    tx_lanes, _ = _lanes(cfg)
    n_sym = cfg.pid_max * cfg.M_occupied
    bps = cfg.modulation.bits_per_symbol
    coded = np.asarray(conv_encode(jnp.asarray(msg)))  # [L, 2*(n+TAIL)]
    coded = np.asarray(puncture(jnp.asarray(coded), rate))
    coded = np.pad(coded, ((0, 0), (0, n_sym * bps - coded.shape[-1])))
    if interleave_bits:
        coded = np.asarray(
            interleave(jnp.asarray(coded), INTERLEAVE_SPREAD)
        )
    syms = np.asarray(bits_to_symbols(jnp.asarray(coded), cfg.modulation))
    tx_data = np.zeros((cfg.num_streams, n_sym), dtype=np.int32)
    tx_data[tx_lanes] = syms
    return tx_data


def encode_data(
    data: bytes, cfg: ModemConfig, *, rate: str = "1/2",
    interleave_bits: bool = True,
) -> np.ndarray:
    """Pack REAL bytes (not a random test payload) into coded payload
    symbols: [32-bit length][32-bit CRC-32][data bits][zero pad], split
    across the mode's data lanes, convolutionally encoded per lane.
    Returns tx_data [num_streams, pid_max * M_occupied] int32."""
    import binascii

    tx_lanes, _ = _lanes(cfg)
    n_msg = message_bits_per_stream(cfg, rate)
    if len(tx_lanes) * n_msg < _HEADER_BITS:
        raise ValueError(
            "payload too small to carry the 64-bit length+CRC header"
        )
    cap = data_capacity_bytes(cfg, rate)
    if len(data) > cap:
        raise ValueError(
            f"{len(data)} bytes exceed the payload capacity {cap}"
        )
    header = np.frombuffer(
        np.uint32(len(data)).tobytes() +
        np.uint32(binascii.crc32(data) & 0xFFFFFFFF).tobytes(),
        np.uint8,
    )
    stream = np.concatenate([header, np.frombuffer(data, np.uint8)])
    bits = np.unpackbits(stream)
    msg = np.zeros((len(tx_lanes), n_msg), np.int32)
    flat = msg.reshape(-1)
    flat[: bits.size] = bits
    msg = flat.reshape(len(tx_lanes), n_msg)
    return _msg_to_tx_data(msg, cfg, rate, interleave_bits)


def decode_data(
    rx_sig, cfg: ModemConfig, *, rate: str = "1/2",
    interleave_bits: bool = True, noise_var: float = 1.0,
):
    """Inverse of encode_data: returns (data bytes, crc_ok bool).

    rx_sig may be the equalized-symbol array OR a whole DecodeResult —
    an ML decode (result.Y kept) then routes through the joint soft-LLR
    path (its rx_sig holds hard remodulated points that would saturate
    the Viterbi).  Truncated/garbled headers yield (b'', False) rather
    than raising."""
    import binascii

    if hasattr(rx_sig, "rx_sig"):  # a DecodeResult
        result = rx_sig
        if result.Y is not None:
            msg = np.asarray(decode_payload_ml(
                result, cfg, noise_var,
                interleave_bits=interleave_bits, rate=rate,
            ))
        else:
            msg = np.asarray(decode_payload(
                result.rx_sig, cfg, noise_var,
                interleave_bits=interleave_bits, rate=rate,
            ))
    else:
        msg = np.asarray(decode_payload(
            rx_sig, cfg, noise_var, interleave_bits=interleave_bits,
            rate=rate,
        ))
    if msg.size < _HEADER_BITS:
        return b"", False
    bits = msg.reshape(-1)
    header = np.packbits(bits[:_HEADER_BITS].astype(np.uint8))
    length = int(np.frombuffer(header[:4].tobytes(), np.uint32)[0])
    crc_want = int(np.frombuffer(header[4:8].tobytes(), np.uint32)[0])
    cap = data_capacity_bytes(cfg, rate)
    if length > cap:
        return b"", False
    body_bits = bits[_HEADER_BITS : _HEADER_BITS + 8 * length]
    data = np.packbits(body_bits.astype(np.uint8)).tobytes()[:length]
    ok = (binascii.crc32(data) & 0xFFFFFFFF) == crc_want
    return data, ok


def decode_payload(
    rx_sig: jax.Array, cfg: ModemConfig,
    noise_var: float | jax.Array = 1.0, *, interleave_bits: bool = True,
    rate: str = "1/2",
) -> jax.Array:
    """Equalized symbols [S, pid_max * M_occupied] -> decoded message bits
    [S, n_msg]: soft max-log-MAP LLRs, deinterleave, depuncture, strip the
    zero-bit padding, batched Viterbi (one jitted program)."""
    return _decode_payload_jit(
        rx_sig, jnp.asarray(noise_var, jnp.float32), cfg,
        interleave_bits, rate,
    )


@functools.partial(
    jax.jit, static_argnames=("cfg", "interleave_bits", "rate")
)
def _decode_payload_jit(
    rx_sig: jax.Array, noise_var: jax.Array, cfg: ModemConfig,
    interleave_bits: bool, rate: str,
) -> jax.Array:
    from rub_mimo_tpu.ofdm import constellation

    _, rx_lanes = _lanes(cfg)
    y = rx_sig[jnp.asarray(rx_lanes)]
    llrs = constellation.soft_demodulate_llr(
        y, cfg.modulation, noise_var
    )                                                # [L, n_sym, bps]
    return _decode_from_llrs(
        llrs.reshape(len(rx_lanes), -1), cfg, interleave_bits, rate
    )


def _decode_from_llrs(
    llrs: jax.Array, cfg: ModemConfig, interleave_bits: bool,
    rate: str = "1/2",
) -> jax.Array:
    """[L, n_coded] LLRs in TX wire order -> message bits [L, n_msg]."""
    if interleave_bits:
        llrs = deinterleave(llrs, INTERLEAVE_SPREAD)
    n_msg = message_bits_per_stream(cfg, rate)
    used = 2 * (n_msg + TAIL)
    llrs = depuncture_llrs(
        llrs[:, : _kept_bits(used, rate)], used, rate
    )
    # long codewords decode block-parallel (the serving-throughput mode:
    # a full-length sequential scan over a multi-Mbit codeword ran ~17 s
    # on chip); short ones keep the exact one-scan ML path
    window = 4096 if n_msg + TAIL > 4 * 4096 else None
    return viterbi_decode(llrs, window=window)


def decode_payload_ml(
    result, cfg: ModemConfig,
    noise_var: float | jax.Array = 1.0, *, interleave_bits: bool = True,
    rate: str = "1/2",
) -> jax.Array:
    """Coded decode with JOINT soft-output ML demodulation: LLRs come from
    detect.ml.ml_soft_llrs over the raw payload grid (result.Y, kept by
    pipeline.rx.decode when cfg.detector == Detector.ML), marginalizing
    inter-stream interference in the lattice instead of after a linear
    equalizer.  Full-MIMO modes only (every lane carries data)."""
    if result.Y is None:
        raise ValueError(
            "result.Y missing: decode with cfg.detector == Detector.ML"
        )
    return _decode_payload_ml_jit(
        result.Y, result.G, jnp.asarray(noise_var, jnp.float32), cfg,
        interleave_bits, rate,
    )


@functools.partial(
    jax.jit, static_argnames=("cfg", "interleave_bits", "rate")
)
def _decode_payload_ml_jit(
    Y: jax.Array, G: jax.Array, noise_var: jax.Array, cfg: ModemConfig,
    interleave_bits: bool, rate: str,
) -> jax.Array:
    from rub_mimo_tpu.detect import ml as ml_mod
    from rub_mimo_tpu.ofdm import sctype

    occ = jnp.asarray(
        sctype.occupied_indices(cfg.subcarrier_allocation())
    )
    llrs = ml_mod.ml_soft_llrs(Y, G[occ], cfg, noise_var)
    # [n_sym, tx, n_sc, bps] -> TX wire order [L, (frame, sc, bit)]
    llrs = jnp.moveaxis(llrs, 1, 0).reshape(cfg.num_streams, -1)
    return _decode_from_llrs(llrs, cfg, interleave_bits, rate)
