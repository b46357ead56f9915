"""Schmidl&Cox frame synchronization as whole-block array ops.

Array-native replacement for the reference's per-sample sync state machine
(STATE_SEEK_PLATEAU, mimo/framing.cc:591-637):

  per sample, per stream (framing.cc:626-637):
    xd[t]     = x[t - M/2]                       (wdelaycf, zero history)
    corr[t]   = -sum_{k<M/2} conj(xd[t-k]) x[t-k]  (firfilt_crcf, taps -1.0;
                 the sign is squared away — the "FIXME why not 1.0f" quirk
                 at framing.cc:342 is metric-neutral)
    energy[t] = 0.5 * sum_{k<M} |x[t-k]|^2        (firfilt_rrrf, taps 0.5)
    metric[t] = |corr[t]|^2 / energy[t]^2

  plateau logic (framing.cc:601-623): per stream track the current run of
  metric > 0.95; sync fires at the first sample where EVERY stream is in a
  run longer than cp_len; sync_index = floor(mean of per-stream run starts).

Here the streaming filters become chunked cumsum-differences
(utils.movsum), the run tracking becomes a cummax over "last index below
threshold", and the first-fire search becomes one argmax — the entire
multi-million-sample scan is a single fused XLA computation.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from rub_mimo_tpu.config import ModemConfig
from rub_mimo_tpu.utils.impl_select import best_impl, check_impl
from rub_mimo_tpu.utils.movsum import delay, moving_sum

_HIGHEST = jax.lax.Precision.HIGHEST


class SyncResult(NamedTuple):
    """Everything the reference's sync stage reports (main.cc:1430-1440)."""

    synced: jax.Array          # bool — did sync fire anywhere in the capture
    sync_sample: jax.Array     # int32 — sample at which sync fired (t*)
    sync_index: jax.Array      # int32 — floor(mean of per-stream run starts)
    plateau_start: jax.Array   # int32[streams] — run start at t*
    plateau_end: jax.Array     # int32[streams] — == t* while in plateau
    metric: jax.Array | None   # float32[streams, T] (optional debug output)
    cfo_hat: jax.Array         # float32 — CFO estimate, subcarrier units


def sc_metric(x: jax.Array, M: int, *, block: int = 1 << 15):
    """S&C timing metric for the whole capture.

    x: [streams, T] complex; returns (metric[streams, T] float32,
    corr[streams, T] complex64 — the un-squared moving correlation, kept for
    CFO estimation).
    """
    M2 = M // 2
    xd = delay(x, M2)
    prod = jnp.conj(xd) * x
    corr = -moving_sum(prod, M2, block=block)
    energy = 0.5 * moving_sum(
        (jnp.real(x) ** 2 + jnp.imag(x) ** 2).astype(jnp.float32),
        M,
        block=block,
    )
    corr_mag2 = (jnp.real(corr) ** 2 + jnp.imag(corr) ** 2).astype(jnp.float32)
    metric = corr_mag2 / (energy * energy)
    return metric, corr


def plateau_scan(
    metric: jax.Array,
    cp_len: int,
    threshold: float,
    quorum: int | None = None,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Vectorized replication of the serial plateau state machine.

    metric: [streams, T].  Returns (synced, t_star,
    run_start[streams]_at_t*, participates[streams]_at_t*).

    For each stream the current run start at t is (last index with
    metric <= threshold before t) + 1; the per-stream condition at t is
      metric[s,t] > thr  AND  t - run_start[s,t] > cp_len
    The fire condition is ALL streams satisfying it (framing.cc:601-623:
    with in_plateau, plateau_end == t and plateau_start == run_start),
    or — robust mode — at least ``quorum`` streams (cfg.sync_quorum).
    t* is the first firing t; ``participates`` marks which streams
    satisfied the condition there (all of them under the all-streams
    rule).
    """
    S, T = metric.shape
    q = S if quorum is None else quorum
    above = metric > threshold  # NaN > thr -> False, same as C float
    idx = jnp.arange(T, dtype=jnp.int32)[None, :]
    # last index not-above (or -1); cummax of masked indices
    last_below = jax.lax.cummax(
        jnp.where(above, jnp.int32(-1), idx), axis=1
    )
    run_start = last_below + 1
    cond = above & ((idx - run_start) > cp_len)
    fire = jnp.sum(cond, axis=0) >= q
    t_star = jnp.argmax(fire).astype(jnp.int32)
    synced = fire[t_star]
    starts = run_start[:, t_star]
    return synced, t_star, starts, cond[:, t_star]


def sync_index_from(starts: jax.Array, mask: jax.Array) -> jax.Array:
    """floor-mean of the PARTICIPATING streams' run starts — identical
    to the reference's all-streams mean (framing.cc:616) when the mask
    is full (quorum == num_streams / None)."""
    n = jnp.maximum(jnp.sum(mask.astype(jnp.int32)), 1)
    return (jnp.sum(jnp.where(mask, starts, 0)) // n).astype(jnp.int32)


def _coarse_stride(cfg: ModemConfig) -> int:
    """Largest power of two <= min(cp_len/2, M/2).  D <= cp/2 guarantees
    any (cp+1)-sample all-streams plateau contains TWO consecutive
    D-aligned coarse points (the candidate-necessity invariant); powers
    of two divide M/2, so the coarse metric at aligned points equals the
    exact metric (block-partial summation)."""
    D = 1
    lim = min(cfg.cp_len // 2, cfg.M // 2)
    while D * 2 <= lim:
        D *= 2
    return D


def coarse_block_sums(x: jax.Array, M2: int, nD: int, D: int,
                      tile_aligned: bool):
    """Per-D-block partial sums of the S&C delayed product and energy
    over x[:, :nD*D]: ([S, nD] complex, [S, nD] f32).  Shared by the
    offline coarse scan and the sharded coarse stage
    (parallel.decode_sharded._coarse_sync_stage).

    tile_aligned=True ("coarse128"): reshape each f32 plane to chunks
    of 128 blocks (minor dim 128*D) and compute the 128 block sums of a
    chunk as ONE matmul against a constant 0/1 block-indicator matrix.
    Summation order differs between the two formulations
    (dispatched-impl float caveat class).

    Every dot here runs at Precision.HIGHEST: these sums feed the 0.95
    plateau threshold, and a reduced-precision (bf16 / TF32) pass would
    move metric values across it."""
    S = x.shape[0]
    n_full = nD * D
    prod = jnp.conj(x[:, : n_full - M2]) * x[:, M2:n_full]
    # left-pad (not concatenate-with-zeros): fresh zeros confuse sharding
    # propagation when decode runs inside a sharded-batch jit
    prod = jnp.pad(prod, ((0, 0), (M2, 0)))
    e_in = (jnp.real(x[:, :n_full]) ** 2
            + jnp.imag(x[:, :n_full]) ** 2).astype(jnp.float32)
    if tile_aligned:
        chunk = 128 * D
        nDp = -(-nD // 128) * 128
        Bm = jnp.asarray(
            (np.arange(chunk)[:, None] // D
             == np.arange(128)[None, :]).astype(np.float32)
        )

        def bsum(q):  # [B, n_full] f32 -> [B, nD] per-block sums
            B = q.shape[0]
            q = jnp.pad(q, ((0, 0), (0, nDp * D - n_full)))
            # ONE 2-D dot, not a batched einsum: folding the chunk
            # groups into rows loads the indicator constant once
            out = jnp.dot(
                q.reshape(B * (nDp // 128), chunk), Bm,
                precision=_HIGHEST, preferred_element_type=jnp.float32,
            )
            return out.reshape(B, nDp)[:, :nD]

        # all three planes (prod re/im, energy) through ONE dot: each
        # output row depends only on its own input row, so this is
        # bit-identical to three separate calls
        all3 = bsum(jnp.concatenate(
            [jnp.real(prod), jnp.imag(prod), e_in], axis=0))
        bs_p = jax.lax.complex(all3[:S], all3[S:2 * S])
        bs_e = all3[2 * S:]
    else:
        # the D-block sums as a [*, D] x [D] contraction
        ones_d = jnp.ones((D,), jnp.float32)
        prod3 = prod.reshape(S, nD, D)
        bs_p = (
            jnp.einsum("snd,d->sn", jnp.real(prod3), ones_d,
                       precision=_HIGHEST,
                       preferred_element_type=jnp.float32)
            + 1j * jnp.einsum("snd,d->sn", jnp.imag(prod3), ones_d,
                              precision=_HIGHEST,
                              preferred_element_type=jnp.float32)
        ).astype(x.dtype)                                  # [S, nD] complex
        bs_e = jnp.einsum(
            "snd,d->sn", e_in.reshape(S, nD, D), ones_d,
            precision=_HIGHEST, preferred_element_type=jnp.float32,
        )                                                  # [S, nD]
    return bs_p, bs_e


def _metric_from_slice(win: jax.Array, M: int):
    """Exact metric/corr for a capture slice that CONTAINS its own M-1
    samples of left context: outputs are valid from index M-1 on (or from
    0 when the slice begins at the true capture start)."""
    return sc_metric(win, M, block=win.shape[-1])


def _synchronize_coarse_prefix(
    x: jax.Array, cfg: ModemConfig, block: int, tile_aligned: bool = False
) -> SyncResult:
    """Early-exit wrapper around the coarse scan: run it on a static
    PREFIX of the capture first and only fall through to the full-
    capture scan (lax.cond — the expensive branch never executes at
    runtime) when the prefix shows no confident fire.

    The fire condition is causal and local, so a fire found at
    t* < Tpre - margin inside the prefix IS the global first fire —
    everything the result carries (run starts, corr at t*) is computed
    from samples at or before t*.  Sync typically fires within the
    first ~10k samples of a multi-million-sample capture (the TX burst
    leads the payload), so sync cost drops from O(T) to O(Tpre).
    Fires inside the margin band are re-derived by the full scan to
    keep boundary semantics identical."""
    S, T = x.shape
    margin = 2 * cfg.M + 2 * cfg.cp_len
    Tpre = max(1 << 18, 8 * margin)
    if Tpre + margin >= T:
        return _synchronize_coarse(x, cfg, block, tile_aligned)
    pre = _synchronize_coarse(x[:, :Tpre], cfg, block, tile_aligned)
    ok = pre.synced & (pre.sync_sample < Tpre - margin)

    def use_pre(_):
        return (pre.synced, pre.sync_sample, pre.sync_index,
                pre.plateau_start, pre.plateau_end, pre.cfo_hat)

    def full(_):
        r = _synchronize_coarse(x, cfg, block, tile_aligned)
        return (r.synced, r.sync_sample, r.sync_index,
                r.plateau_start, r.plateau_end, r.cfo_hat)

    synced, t_o, si, st, pe, cfo = jax.lax.cond(
        ok, use_pre, full, operand=None
    )
    return SyncResult(
        synced=synced, sync_sample=t_o, sync_index=si,
        plateau_start=st, plateau_end=pe, metric=None, cfo_hat=cfo,
    )


def _synchronize_coarse(
    x: jax.Array, cfg: ModemConfig, block: int, tile_aligned: bool = False
) -> SyncResult:
    """Sync in ~3 passes over the capture instead of ~8.

    The fire condition is LOCAL — fire at t <=> metric > threshold at
    every position in [t-cp-1, t] on every stream — so the full-rate
    metric is only ever needed in small windows:

      1. COARSE: the exact metric at D-aligned positions
         t_i = i*D + D - 1, computed from per-block partial sums (the
         moving sums' windows are whole numbers of blocks).  One fused
         read of the capture; no full-rate intermediates.
      2. CANDIDATES: any fire's plateau covers two consecutive coarse
         points above threshold on all streams (D <= cp/2), so
         candidate pairs are NECESSARY for a fire.  The first K=4
         candidates are refined with exact-metric windows of
         ~(M + 2cp) samples each; the earliest refined fire is the
         global first fire (candidate spacing D > cp/4 makes later
         candidates' windows start after earlier ones' ends).
      3. RUN STARTS: per-stream exact scan over a (2M+2cp)-sample
         window left of t*.

    Falls back to the full scan (lax.cond) when the first K candidates
    all refine to no-fire but more exist, or when a plateau run extends
    past the run-start window — so the fast path never changes results,
    it only changes speed.  Float caveat: block-partial summation order
    differs from the chunked full scan's (same ulp-at-threshold class as
    every other chunking seam, documented in module docstrings)."""
    S, T = x.shape
    M = cfg.M
    M2 = M // 2
    cp = cfg.cp_len
    thr = cfg.plateau_threshold
    q = S if cfg.sync_quorum is None else cfg.sync_quorum
    D = _coarse_stride(cfg)
    K = 4
    if D < 2 or M2 % D or T < 2 * M + 4 * cp + 4 * D:
        return _synchronize_full(x, cfg, False, block)

    nD = T // D
    n_full = nD * D
    kp, ke = M2 // D, M // D

    # ---- coarse pass: block-partial sums -> exact metric at t_i ----
    bs_p, bs_e = coarse_block_sums(x, M2, nD, D, tile_aligned)

    def _mov(bs, k):
        cs = jnp.cumsum(bs, axis=-1)
        return cs - jnp.pad(cs[:, :-k], ((0, 0), (k, 0)))

    corr_c = -_mov(bs_p, kp)
    e_c = 0.5 * _mov(bs_e, ke)
    metric_c = (
        (jnp.real(corr_c) ** 2 + jnp.imag(corr_c) ** 2).astype(jnp.float32)
        / (e_c * e_c)
    )
    # >= q streams above at a coarse point (q = S: the all-streams rule;
    # candidate NECESSITY holds per participating stream — each of the
    # q streams' (cp+1)-runs covers two consecutive aligned points)
    all_c = jnp.sum(metric_c > thr, axis=0) >= q       # [nD]
    pair = all_c[:-1] & all_c[1:]                      # pair j <-> (j, j+1)
    n_cand = jnp.sum(pair)
    big = jnp.int32(T + 10 * M)
    jidx = jnp.arange(nD - 1, dtype=jnp.int32)
    neg = jax.lax.top_k(
        jnp.where(pair, -jidx, -big), K
    )[0]
    cand_j = -neg                                      # K smallest, sorted

    # ---- refine each candidate: exact fire search in its window ----
    # fire positions for pair (j, j+1): p in [t_{j+1}, t_{j+1} + cp];
    # needs exact metric over [p - cp - 1, p] -> slice with M-1 context
    Lp = 2 * cp + 2                                    # metric positions
    Lw = (M - 1) + Lp                                  # slice length
    run_w = 2 * M + 2 * cp                             # run-start window
    Lr = (M - 1) + run_w

    # all K candidates refined in ONE batched metric computation: the K
    # windows are sliced separately (tiny copies) but their metric +
    # fire-rule math runs as single [K*S, .] / [K, S, .] ops.
    # Bit-identical per candidate (every row of the batched ops depends
    # only on its own window).
    t_i = (cand_j + 1) * D + D - 1                     # [K]
    p0 = t_i - cp - 1                                  # first metric pos
    cl = jnp.clip(p0 - (M - 1), 0, T - Lw)             # [K]
    wins = jnp.stack([
        jax.lax.dynamic_slice(
            x, (jnp.int32(0), cl[k].astype(jnp.int32)), (S, Lw)
        )
        for k in range(K)
    ])                                                 # [K, S, Lw]
    m_w, _ = _metric_from_slice(wins.reshape(K * S, Lw), M)
    m_w = m_w.reshape(K, S, Lw)
    # positions cl + q; valid exact from q >= M-1 unless cl == 0
    q0 = p0 - cl                                       # q of position p0
    qs = jnp.clip(
        q0[:, None] + jnp.arange(Lp, dtype=jnp.int32)[None, :], 0, Lw - 1
    )                                                  # [K, Lp]
    pos = cl[:, None] + qs                             # [K, Lp]
    above_s = jnp.take_along_axis(
        m_w, jnp.broadcast_to(qs[:, None, :], (K, S, Lp)), axis=2
    ) > thr                                            # [K, S, Lp]
    # fire at p <=> >= q streams each above for the whole cp+2
    # window ending at p (per-stream runs — NOT "q streams above at
    # each position", which would let participants rotate); for
    # q = S this is bitwise the old all-streams formulation
    rl = jnp.cumsum(above_s.astype(jnp.int32), axis=2)
    rl = rl - jnp.pad(rl[:, :, : -(cp + 2)], ((0, 0), (0, 0), (cp + 2, 0)))
    fire_k = ((jnp.sum(rl >= cp + 2, axis=1) >= q)
              & (pos >= t_i[:, None]) & (pos < T))     # [K, Lp]
    p_fire = jnp.min(jnp.where(fire_k, pos, big), axis=1)
    ok = (cand_j < nD - 1) & (t_i + cp < T)            # in-range candidates
    fires = jnp.where(ok, p_fire, big)

    # ---- tail guard: fires whose coarse pair would fall past the grid
    # (last ~2 blocks of the capture) — exact scan of the capture tail ----
    Wt = 2 * cp + 4 * D + 2
    tail_cl = T - ((M - 1) + Wt + cp + 2)
    twin = jax.lax.dynamic_slice(
        x, (jnp.int32(0), jnp.int32(tail_cl)), (S, (M - 1) + Wt + cp + 2)
    )
    m_t, _ = _metric_from_slice(twin, M)
    qs_t = (M - 1) + jnp.arange(Wt + cp + 2, dtype=jnp.int32)
    pos_t = tail_cl + qs_t
    above_t = m_t[:, qs_t] > thr                       # [S, Wt+cp+2]
    rl_t = jnp.cumsum(above_t.astype(jnp.int32), axis=1)
    rl_t = rl_t - jnp.pad(rl_t[:, : -(cp + 2)], ((0, 0), (cp + 2, 0)))
    fire_t = ((jnp.sum(rl_t >= cp + 2, axis=0) >= q)
              & (pos_t >= T - 2 * D - cp) & (pos_t < T))
    p_tail = jnp.min(jnp.where(fire_t, pos_t, big))

    t_star = jnp.minimum(jnp.min(fires), p_tail)
    synced = t_star < big
    t_star = jnp.where(synced, t_star, 0).astype(jnp.int32)

    # ---- per-stream run starts: exact scan left of t* ----
    r_start = t_star - run_w + 1 - (M - 1)
    r_cl = jnp.clip(r_start, 0, jnp.maximum(T - Lr, 0))
    rwin = jax.lax.dynamic_slice(
        x, (jnp.int32(0), r_cl.astype(jnp.int32)), (S, Lr)
    )
    m_r, corr_r = _metric_from_slice(rwin, M)
    pos_r = r_cl + jnp.arange(Lr, dtype=jnp.int32)
    in_scan = (pos_r <= t_star) & (pos_r > t_star - run_w)
    below = (~(m_r > thr)) & in_scan[None, :]
    last_below = jnp.max(
        jnp.where(below, pos_r[None, :], jnp.int32(-1)), axis=1
    )
    starts = (last_below + 1).astype(jnp.int32)
    # a stream whose window shows NO below sample has its run extending
    # past the window — unless the window already reaches position 0, in
    # which case run_start = 0 is exact (matches the full scan's
    # last_below = -1).  Only the former needs the exactness fallback.
    run_saturated = (
        synced
        & (t_star - run_w + 1 > 0)
        & jnp.any(last_below == -1)
    )
    # corr + metric at t* from the same window (t* is inside it by
    # construction); the metric drives the quorum participation mask
    onehot = (pos_r == t_star).astype(jnp.float32)
    c_at = jnp.sum(corr_r * onehot[None, :], axis=1)
    m_at = jnp.sum(m_r * onehot[None, :], axis=1)
    mask = (m_at > thr) & ((t_star - starts) > cp)

    # no-fire defaults must match the full scan's (t*=0 -> corr[0]=0,
    # last_below[.,0]=0 -> starts=1)
    starts = jnp.where(synced, starts, jnp.ones((S,), jnp.int32))
    c_at = jnp.where(synced, c_at, jnp.zeros((S,), c_at.dtype))
    mask = mask | (q == S)  # all-streams rule: full mask, bit-identical
    mask = mask & synced | (~synced)

    need_full = run_saturated | ((~synced) & (n_cand > K))

    def fast(_):
        sync_index = sync_index_from(starts, mask)
        cfo_hat = jnp.angle(
            jnp.sum(-jnp.where(mask, c_at, 0))
        ).astype(jnp.float32) / np.pi
        return (synced, t_star, sync_index, starts,
                jnp.broadcast_to(t_star, (S,)).astype(jnp.int32), cfo_hat)

    def full(_):
        r = _synchronize_full(x, cfg, False, block)
        return (r.synced, r.sync_sample, r.sync_index, r.plateau_start,
                r.plateau_end, r.cfo_hat)

    synced_o, t_o, si_o, st_o, pe_o, cfo_o = jax.lax.cond(
        need_full, full, fast, operand=None
    )
    return SyncResult(
        synced=synced_o,
        sync_sample=t_o,
        sync_index=si_o,
        plateau_start=st_o,
        plateau_end=pe_o,
        metric=None,
        cfo_hat=cfo_o,
    )


def _synchronize_full(
    x: jax.Array, cfg: ModemConfig, keep_metric: bool, block: int
) -> SyncResult:
    metric, corr = sc_metric(x, cfg.M, block=block)
    synced, t_star, starts, mask = plateau_scan(
        metric, cfg.cp_len, cfg.plateau_threshold, cfg.sync_quorum
    )
    sync_index = sync_index_from(starts, mask)
    # CFO from the participating streams' correlations only (identical
    # to the all-streams sum under the reference rule)
    c_at = jnp.where(mask, corr[:, t_star], 0)
    cfo_hat = jnp.angle(jnp.sum(-c_at)).astype(jnp.float32) / np.pi
    return SyncResult(
        synced=synced,
        sync_sample=t_star,
        sync_index=sync_index,
        plateau_start=starts,
        plateau_end=jnp.broadcast_to(
            t_star, (cfg.num_streams,)
        ).astype(jnp.int32),
        metric=metric if keep_metric else None,
        cfo_hat=cfo_hat,
    )


def synchronize(
    x: jax.Array,
    cfg: ModemConfig,
    *,
    keep_metric: bool = False,
    block: int = 1 << 15,
    impl: str = "auto",
) -> SyncResult:
    """Full sync stage: metric + plateau scan + CFO estimate.

    impl: "auto" consults the committed on-device measurement table
    (utils.impl_select, regenerated by ``bench.py --check``) when the
    caller does not need the metric array, picking the fastest impl
    that passed the equality check on this backend; unmeasured backends
    fall back to "coarse".  "coarse" forces the coarse+refine path
    (_synchronize_coarse); "xla" forces the chunked full scan;
    "coarse_full" is coarse without the prefix early-exit; the "...128"
    variants use the indicator-matmul block sums.  Any other name
    raises ValueError."""
    check_impl("sync", impl)
    if impl == "auto" and not keep_metric:
        impl = best_impl("sync", jax.default_backend())
    if impl in ("coarse_full", "coarse_full128") and not keep_metric:
        # plain coarse without the prefix early-exit: for vmapped
        # (batched) decodes, where vmap turns the prefix's lax.cond
        # into a select that runs BOTH branches — the prefix would be
        # pure overhead there
        return _synchronize_coarse(x, cfg, block,
                                   impl == "coarse_full128")
    if not keep_metric and impl in ("auto", "coarse", "coarse128"):
        # coarse128: tile-aligned f32-plane block sums (see
        # _synchronize_coarse) — measured against "coarse" by
        # ``bench.py --check``; float summation order differs, so it is
        # a dispatched impl, not a silent replacement
        return _synchronize_coarse_prefix(x, cfg, block,
                                          impl == "coarse128")
    # CFO note: the delayed product accumulates phase 2*pi*eps/M per
    # sample over an M/2 lag, so angle(P) = pi * eps (eps in
    # subcarrier-spacing units); the extra pi from the negated taps
    # (framing.cc:342) is removed by negating corr.
    return _synchronize_full(x, cfg, keep_metric, block)


def correct_cfo(x: jax.Array, cfo_subcarriers: jax.Array, M: int) -> jax.Array:
    """De-rotate the capture by a CFO given in subcarrier-spacing units
    (new capability — the reference leaves this as a FIXME,
    framing.cc:486)."""
    T = x.shape[-1]
    n = jnp.arange(T, dtype=jnp.float32)
    rot = jnp.exp(-2j * jnp.pi * cfo_subcarriers * n / M)
    return (x * rot[None, :]).astype(jnp.complex64)
