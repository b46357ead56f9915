"""Multi-chip decode: time-sharded sync + replicated CSI + sharded payload.

The headline distributed feature (SURVEY §5 long-context): the capture's
time axis — millions of IQ samples the reference walks serially per sample
(framing.cc:481) — is sharded across devices in three shard_map stages:

  stage A — S&C sync: each shard computes the metric over its block with an
    (M-1)-sample overlap-save halo fetched from its left neighbor via
    ppermute; plateau run-tracking is a local cummax whose cross-shard
    carry is a prefix-max exchanged with all_gather; the global first-fire
    election is a min-reduction over per-shard candidates.

  stage B — preamble-region gather: each shard masks out its overlap with
    the ~(n_seq+1)-symbol estimation region and a psum over 'time'
    replicates it everywhere (the CSI all-gather of SURVEY §2.6); the
    matched-filter search then shards its 41-template axis over 'sc'
    (_mf_stage) and the LS estimate shards its 20-code FFT batch over
    'sc' (_estimate_stage) — the sharded equivalent of the reference's
    single windowcf buffer (framing.cc:700) with the second mesh axis
    doing real work.

  stage C — payload FFT: every shard CP-strips + FFTs exactly the OFDM
    symbols whose first sample lands in its block, reading up to
    symbol_len samples into a right-neighbor halo (ppermute again), with
    the symbols striped over 'sc' so an (n_time x n_sc) mesh divides the
    FFT work n_time*n_sc ways; the per-device symbol slabs are
    scatter/psum-assembled into the global [pid_max, streams, M_occupied]
    frequency grid.

  stage D (fused into C, round 4) — equalize: the per-subcarrier MIMO
    solves (the reference's "model dim", framing.cc:570-578/826-832)
    run on the symbols' owning devices inside stage C with replicated
    CSI (every device owns whole symbols, so the solves stay striped
    over time x sc) — one grid assembly instead of two, which halved
    the measured 1-device sharding overhead.  The cross-symbol
    Alamouti/tracking tails still run replicated on the assembled raw
    grid.

Constraint: T / n_time >= symbol_len (each shard must own at least one
symbol start).  Captures are padded by parallel.mesh.shard_capture.

Equality with the single-chip decode is exact on all tested splits; note
the per-shard metric cumsum restarts at shard boundaries (same math,
different float32 summation order than offline), so a metric value within
one ulp of the plateau threshold at a boundary could in principle tip a
sync decision differently.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from rub_mimo_tpu.config import CommMode, Detector, ModemConfig
from rub_mimo_tpu.estimate import ls
from rub_mimo_tpu.ofdm import constellation, sctype
from rub_mimo_tpu.sync import matched_filter, schmidl_cox

_BIG = jnp.int32(2**30)


class ShardedDecodeResult(NamedTuple):
    synced: jax.Array
    sync_index: jax.Array
    sync_sample: jax.Array
    cfo_hat: jax.Array
    G: jax.Array
    decode_start: jax.Array
    rx_sig: jax.Array
    rx_data: jax.Array


# --------------------------------------------------------------- stage A
def halo_from_left(x: jax.Array, halo: int, n_time: int) -> jax.Array:
    """The last ``halo`` samples of the left neighbour's block along the
    'time' axis ([S, halo]; zeros on shard 0).  A ppermute, which XLA
    lowers to a device-to-device collective."""
    if n_time == 1:
        return jnp.zeros((x.shape[0], halo), dtype=x.dtype)
    return jax.lax.ppermute(
        x[:, -halo:], "time", [(j, j + 1) for j in range(n_time - 1)]
    )


def _sync_stage(local: jax.Array, cfg: ModemConfig, n_time: int):
    """Per-shard sync: [S, Tloc] block -> (t_global [1], starts [1,S],
    fired [1]) candidates for the global first-fire election."""
    S, Tloc = local.shape
    halo = cfg.M - 1
    me = jax.lax.axis_index("time")
    left = halo_from_left(local, halo, n_time)
    ext = jnp.concatenate([left, local], axis=-1)
    block = min(1 << 15, Tloc + halo)
    metric_ext, corr_ext = schmidl_cox.sc_metric(ext, cfg.M, block=block)
    metric = metric_ext[:, halo:]
    corr = corr_ext[:, halo:]

    gidx = me * Tloc + jnp.arange(Tloc, dtype=jnp.int32)
    above = metric > cfg.plateau_threshold
    masked = jnp.where(above, jnp.int32(-1), gidx[None, :])
    local_cm = jax.lax.cummax(masked, axis=1)
    shard_max = local_cm[:, -1]
    all_max = jax.lax.all_gather(shard_max, "time", axis=0)  # [n, S]
    prev = jnp.arange(n_time, dtype=jnp.int32)[:, None] < me
    prefix = jnp.max(jnp.where(prev, all_max, jnp.int32(-1)), axis=0)
    last_below = jnp.maximum(local_cm, prefix[:, None])
    run_start = last_below + 1
    cond = above & ((gidx[None, :] - run_start) > cfg.cp_len)
    # all-streams rule, or >= sync_quorum streams (robust mode)
    q = S if cfg.sync_quorum is None else cfg.sync_quorum
    cond_all = jnp.sum(cond, axis=0) >= q
    fired = jnp.any(cond_all)
    t_loc = jnp.argmax(cond_all).astype(jnp.int32)
    t_global = jnp.where(fired, gidx[t_loc], _BIG)
    starts = run_start[:, t_loc]
    pmask = jnp.where(fired & (q < S), cond[:, t_loc],
                      jnp.ones((S,), jnp.bool_))

    # global first-fire election, fully inside the shard_map: the winner is
    # the shard with the smallest fire sample; its run starts are broadcast
    # by a masked psum.  All outputs replicated.
    best_t = jax.lax.pmin(t_global, "time")
    fired_any = jax.lax.pmax(fired.astype(jnp.int32), "time") > 0
    win = fired & (t_global == best_t)
    starts_out = jax.lax.psum(
        jnp.where(win, starts, jnp.int32(0)), "time"
    )
    pmask_out = jax.lax.psum(
        jnp.where(win, pmask.astype(jnp.int32), jnp.int32(0)), "time"
    )
    pmask_out = jnp.where(fired_any, pmask_out > 0,
                          jnp.ones((S,), jnp.bool_))
    # elect the complex S&C correlation at the fire sample (CFO source,
    # matching schmidl_cox.synchronize's corr[:, t_star]); quorum mode
    # combines only the participating streams
    corr_at = jnp.where(pmask, corr[:, t_loc], 0)
    corr_out = jax.lax.psum(
        jnp.where(win, corr_at, jnp.complex64(0)), "time"
    )
    return best_t, starts_out, fired_any, corr_out, pmask_out


def coarse_left_halo(cfg: ModemConfig) -> int:
    """D-aligned LEFT-halo length of _coarse_sync_stage: covers the
    coarse block sums, candidate refinement, and the run-start scan left
    of any locally-owned fire.  build_sharded_decoder's coarse_ok gate
    must require Tloc >= this (a shard smaller than its own halo slices
    short and misaligns every ext/global coordinate — round-5 fix)."""
    D = schmidl_cox._coarse_stride(cfg)
    return -(-(3 * cfg.M + 2 * cfg.cp_len + 2 * D) // D) * D


def _coarse_sync_stage(local: jax.Array, cfg: ModemConfig, n_time: int,
                       T_total: int):
    """Coarse+refine per-shard sync (stage A fast path).

    The full-rate per-shard metric scan (_sync_stage) reads every sample
    ~8x.  This stage ports the offline
    coarse scan (sync/schmidl_cox._synchronize_coarse) into shard_map:

      - exact metric at D-aligned GLOBAL positions from per-D-block
        partial sums over [left halo | local] (halo = a D-aligned
        ~(3M + 2cp) window exchanged via ppermute, enough for block
        sums, candidate refinement, AND the run-start scan);
      - candidate pairs: local pairs plus the boundary pair owned as
        j = -1 (this shard's first coarse point with the neighbor's
        last, computed from the halo — every global pair is counted
        exactly once);
      - the first K candidates refine with exact-metric windows; the
        LAST shard also runs the offline tail guard.

    Falls back (lax.cond on a REPLICATED flag, so every device takes
    the same branch) to the full-rate scan whenever any shard sees a
    saturated run-start window or more than K unrefined candidates —
    the same exactness rule as the offline coarse path, so results
    always match the full scan (same float caveat class as the offline
    chunk seams).  Returns (need_full, best_t, starts, fired, corr_at);
    the caller runs _sync_stage when need_full.
    """
    S, Tloc = local.shape
    M = cfg.M
    M2 = M // 2
    cp = cfg.cp_len
    thr = cfg.plateau_threshold
    D = schmidl_cox._coarse_stride(cfg)
    K = 4
    me = jax.lax.axis_index("time")
    shard0 = me * Tloc

    halo = coarse_left_halo(cfg)
    # RIGHT halo: a shard's last local pair owns fires in
    # [shard_end, shard_end + cp], and the refine/run-start windows need
    # exact metric there — i.e. samples through shard_end + cp.  Without
    # it, cl/qs clamping duplicated the last in-shard metric sample and
    # could fabricate (or misplace) a fire at the boundary (round-5 fix;
    # the offline scan has no such seam, framing.cc:601-623).
    rhalo = cp + 2
    if n_time > 1:
        left = jax.lax.ppermute(
            local[:, -halo:], "time", [(j, j + 1) for j in range(n_time - 1)]
        )
        right = jax.lax.ppermute(
            local[:, :rhalo], "time", [(j + 1, j) for j in range(n_time - 1)]
        )
    else:
        left = jnp.zeros((S, halo), dtype=local.dtype)
        right = jnp.zeros((S, rhalo), dtype=local.dtype)
    # ext coordinates: position i maps to global shard0 - halo + i, with
    # the conceptual buffer ext_r = [left | local | right].  The buffer
    # is NEVER materialized (no shard-sized concatenate).  Instead:
    #   - block sums split at edge = halo + M2 into a small
    #     [left | local[:M2]] prefix plus sums over `local` itself
    #     (identical per-block values and summation order);
    #   - refine/run-start windows are served from one of three
    #     sources (small left-edge buffer | local | small right-edge
    #     buffer) selected per window by a lax.switch.
    Te = halo + Tloc
    Ter = Te + rhalo

    Lp = 2 * cp + 2
    Lw = (M - 1) + Lp
    run_w = 2 * M + 2 * cp
    Lr = (M - 1) + run_w
    Lmax = max(Lw, Lr)
    edge_l = jnp.concatenate([left, local[:, :Lmax]], axis=-1)
    edge_r = jnp.concatenate([local[:, -Lmax:], right], axis=-1)

    def _make_window(L):
        def win(cl):
            cl = cl.astype(jnp.int32)
            idx = jnp.where(cl < halo, 0,
                            jnp.where(cl + L <= Te, 1, 2)).astype(jnp.int32)

            def from_left(_):
                c = jnp.clip(cl, 0, halo + Lmax - L)
                return jax.lax.dynamic_slice(
                    edge_l, (jnp.int32(0), c), (S, L))

            def from_local(_):
                c = jnp.clip(cl - halo, 0, Tloc - L)
                return jax.lax.dynamic_slice(
                    local, (jnp.int32(0), c), (S, L))

            def from_right(_):
                c = jnp.clip(cl - Te + Lmax, 0, Lmax + rhalo - L)
                return jax.lax.dynamic_slice(
                    edge_r, (jnp.int32(0), c), (S, L))

            return jax.lax.switch(
                idx, [from_left, from_local, from_right], None)

        return win

    _window_Lw = _make_window(Lw)
    _window_Lr = _make_window(Lr)

    # ---- coarse pass ("coarse128" indicator-matmul block sums, split
    # so no shard-sized ext is formed) ----
    nD = Te // D
    kp, ke = M2 // D, M // D
    kM2 = M2 // D
    b0 = halo // D
    x1 = jnp.concatenate([left, local[:, :M2]], axis=-1)
    bs1_p, bs1_e = schmidl_cox.coarse_block_sums(
        x1, M2, b0 + kM2, D, True)
    bsl_p, bsl_e = schmidl_cox.coarse_block_sums(
        local, M2, Tloc // D, D, True)
    bs_p = jnp.concatenate([bs1_p, bsl_p[:, kM2:]], axis=-1)
    bs_e = jnp.concatenate([bs1_e, bsl_e[:, kM2:]], axis=-1)

    def _mov(bs, k):
        cs = jnp.cumsum(bs, axis=-1)
        return cs - jnp.pad(cs[:, :-k], ((0, 0), (k, 0)))

    corr_c = -_mov(bs_p, kp)
    e_c = 0.5 * _mov(bs_e, ke)
    metric_c = (
        (jnp.real(corr_c) ** 2 + jnp.imag(corr_c) ** 2).astype(jnp.float32)
        / (e_c * e_c)
    )
    # coarse point i (ext blocks) sits at ext position i*D + D - 1; the
    # LOCAL points start at block halo//D; block halo//D - 1 is the
    # neighbor's last point (for the j = -1 boundary pair)
    nloc = Tloc // D
    all_c = jnp.all(metric_c > thr, axis=0)          # [nD]
    loc_above = jax.lax.dynamic_slice(
        all_c, (b0 - 1,), (nloc + 1,)
    )  # [prev_last, local points...]
    # shard 0 has a zero halo; its "neighbor point" must not pair
    loc_above = loc_above.at[0].set(
        jnp.where(me > 0, loc_above[0], False)
    )
    pair = loc_above[:-1] & loc_above[1:]            # [nloc] pair j-1
    n_cand = jnp.sum(pair)
    big = jnp.int32(T_total + 10 * M)
    jidx = jnp.arange(nloc, dtype=jnp.int32)         # pair index - 1
    neg = jax.lax.top_k(jnp.where(pair, -jidx, -big), K)[0]
    cand_j = -neg                                    # smallest first

    def refine_fire(j):
        # pair (j-1, j) in LOCAL point coords: second point at local
        # block j -> ext position halo + j*D + D - 1
        t_e = halo + j * D + D - 1
        p0 = t_e - cp - 1
        start = p0 - (M - 1)
        cl = jnp.clip(start, 0, Ter - Lw)
        win = _window_Lw(cl)
        m_w, _ = schmidl_cox._metric_from_slice(win, M)
        q0 = p0 - cl
        qs = jnp.clip(q0 + jnp.arange(Lp, dtype=jnp.int32), 0, Lw - 1)
        pos = cl + qs                                 # ext coords
        gpos = shard0 - halo + pos                    # global coords
        above = jnp.all(
            jnp.take_along_axis(
                m_w, jnp.broadcast_to(qs[None, :], (S, Lp)), axis=1
            ) > thr,
            axis=0,
        )
        runlen = jnp.cumsum(above.astype(jnp.int32))
        runlen = runlen - jnp.pad(runlen[: -(cp + 2)], (cp + 2, 0))
        fire = ((runlen >= cp + 2) & (pos >= t_e)
                & (gpos >= 0) & (gpos < T_total))
        p_fire = jnp.min(jnp.where(fire, gpos, big))
        ok = (j < nloc) & (shard0 + j * D + D - 1 + cp < T_total)
        return jnp.where(ok, p_fire, big)

    fires = jnp.stack([refine_fire(cand_j[k]) for k in range(K)])

    # ---- tail guard (LAST shard only): burst in the final ~2D samples
    # whose coarse pair falls past the aligned grid ----
    Wt = 2 * cp + 4 * D + 2
    tail_len = (M - 1) + Wt + cp + 2
    twin = local[:, Tloc - tail_len:]  # the capture tail is local-only
    m_t, _ = schmidl_cox._metric_from_slice(twin, M)
    qs_t = (M - 1) + jnp.arange(Wt + cp + 2, dtype=jnp.int32)
    gpos_t = shard0 - halo + (Te - tail_len) + qs_t
    above_t = jnp.all(m_t[:, qs_t] > thr, axis=0)
    rl_t = jnp.cumsum(above_t.astype(jnp.int32))
    rl_t = rl_t - jnp.pad(rl_t[: -(cp + 2)], (cp + 2, 0))
    fire_t = ((rl_t >= cp + 2) & (gpos_t >= T_total - 2 * D - cp)
              & (gpos_t < T_total))
    p_tail = jnp.where(
        me == n_time - 1,
        jnp.min(jnp.where(fire_t, gpos_t, big)),
        big,
    )

    t_loc_best = jnp.minimum(jnp.min(fires), p_tail)
    synced_loc = t_loc_best < big

    # ---- run starts + corr at t* (the ~(3M+2cp) halo covers the whole
    # exact-scan window left of any locally-owned t*) ----
    t_e_star = jnp.where(
        synced_loc, t_loc_best - shard0 + halo, jnp.int32(halo)
    )
    r_start_g = (t_loc_best - run_w + 1) - (M - 1)   # global
    r_cl_g = jnp.clip(r_start_g, 0, jnp.maximum(T_total - Lr, 0))
    r_cl_e = r_cl_g - shard0 + halo                  # ext coords (>= 0)
    r_cl_e = jnp.clip(r_cl_e, 0, Ter - Lr)
    rwin = _window_Lr(r_cl_e)
    m_r, corr_r = schmidl_cox._metric_from_slice(rwin, M)
    gpos_r = (shard0 - halo + r_cl_e) + jnp.arange(Lr, dtype=jnp.int32)
    in_scan = (gpos_r <= t_loc_best) & (gpos_r > t_loc_best - run_w)
    below = (~(m_r > thr)) & in_scan[None, :]
    last_below = jnp.max(
        jnp.where(below, gpos_r[None, :], jnp.int32(-1)), axis=1
    )
    starts_loc = (last_below + 1).astype(jnp.int32)
    run_saturated = (
        synced_loc
        & (t_loc_best - run_w + 1 > 0)
        & jnp.any(last_below == -1)
    )
    onehot = (gpos_r == t_loc_best).astype(jnp.float32)
    c_at_loc = jnp.sum(corr_r * onehot[None, :], axis=1)

    # ---- global election + exactness flag ----
    best_t = jax.lax.pmin(jnp.where(synced_loc, t_loc_best, big), "time")
    fired_any = best_t < big
    win_shard = synced_loc & (t_loc_best == best_t)
    starts_out = jax.lax.psum(
        jnp.where(win_shard, starts_loc, jnp.int32(0)), "time"
    )
    corr_out = jax.lax.psum(
        jnp.where(win_shard, c_at_loc, jnp.complex64(0)), "time"
    )
    starts_out = jnp.where(fired_any, starts_out, jnp.ones((S,), jnp.int32))
    corr_out = jnp.where(fired_any, corr_out,
                         jnp.zeros((S,), corr_out.dtype))
    best_t = jnp.where(fired_any, best_t, _BIG)

    need_full_loc = (run_saturated & win_shard) | (
        (~synced_loc) & (n_cand > K)
    )
    need_full = jax.lax.pmax(need_full_loc.astype(jnp.int32), "time") > 0
    return need_full, best_t, starts_out, fired_any, corr_out


# --------------------------------------------------------------- stage B
def _region_stage(local: jax.Array, rstart: jax.Array, region_len: int):
    """Replicate capture[rstart : rstart+region_len] via masked local
    slices + psum (positions outside the capture read as zeros, matching
    the zero-initialized windowcf backing store).

    One clamped in-range slice + a positional mask, so no shard-sized
    padded copy is formed.  The mask only
    touches the region-sized result; shards with no overlap mask to
    zero.  Requires Tloc >= region_len (enforced by the caller's
    region-capacity check; the pad formulation remains as fallback)."""
    S, Tloc = local.shape
    me = jax.lax.axis_index("time")
    base = me * Tloc
    start = rstart - base                 # region start in local coords

    def _pad_path(_):
        loc_pad = jnp.pad(local, ((0, 0), (region_len, region_len)))
        s = jnp.clip(start + region_len, 0, Tloc + region_len)
        return jax.lax.dynamic_slice(
            loc_pad, (jnp.int32(0), s.astype(jnp.int32)), (S, region_len)
        )

    if Tloc < region_len:
        return jax.lax.psum(_pad_path(None), "time")

    def _zeros(_):
        # pcast: mark the constant as device-varying so all switch
        # branches carry the same manual-axes type under shard_map
        return jax.lax.pcast(
            jnp.zeros((S, region_len), local.dtype), "time", to="varying"
        )

    def _fast(_):
        s0 = jnp.clip(start, 0, Tloc - region_len).astype(jnp.int32)
        return jax.lax.dynamic_slice(
            local, (jnp.int32(0), s0), (S, region_len)
        )

    overlaps = (start + region_len > 0) & (start < Tloc)
    contained = (start >= 0) & (start <= Tloc - region_len)
    branch = jnp.where(~overlaps, 0, jnp.where(contained, 1, 2))
    part = jax.lax.switch(branch.astype(jnp.int32),
                          [_zeros, _fast, _pad_path], None)
    return jax.lax.psum(part, "time")


# --------------------------------------------------- S0 xcorr fallback
def _xcorr_stage(local: jax.Array, cfg: ModemConfig, n_time: int,
                 T_total: int):
    """Per-shard normalized S0 matched filter (sync.xcorr_sync, sharded):
    each shard correlates its block (+M right halo) against the S0
    template and the global best peak is elected with collectives.
    Returns (best_score [], best_gidx []) replicated."""
    from rub_mimo_tpu.sync.xcorr_sync import normalized_s0_score

    S, Tloc = local.shape
    M = cfg.M
    me = jax.lax.axis_index("time")

    if n_time > 1:
        right = jax.lax.ppermute(
            local[:, :M], "time", [(j + 1, j) for j in range(n_time - 1)]
        )
    else:
        right = jnp.zeros((S, M), dtype=local.dtype)
    ext = jnp.concatenate([local, right], axis=-1)  # [S, Tloc + M]
    score = normalized_s0_score(ext, cfg, Tloc)

    gidx = me * Tloc + jnp.arange(Tloc, dtype=jnp.int32)
    score = jnp.where(gidx < (T_total - M), score, 0.0)
    loc_best = jnp.max(score)
    loc_idx = gidx[jnp.argmax(score)]
    best = jax.lax.pmax(loc_best, "time")
    win = loc_best == best
    # first-winner tie break: smallest global index among winners
    best_idx = jax.lax.pmin(
        jnp.where(win, loc_idx, jnp.int32(2**30)), "time"
    )
    return best, best_idx


# ------------------------------------------------------- CFO derotation
def _derotate_stage(local: jax.Array, eps: jax.Array, ref: jax.Array,
                    M: int):
    """Per-shard CFO derotation with a GLOBAL phase reference:
    out[g] = x[g] * exp(-2j pi eps (g - ref) / M)."""
    S, Tloc = local.shape
    me = jax.lax.axis_index("time")
    gidx = (me * Tloc + jnp.arange(Tloc, dtype=jnp.int32)).astype(
        jnp.float32
    )
    rot = jnp.exp(-2j * jnp.pi * eps * (gidx - ref) / M)
    return (local * rot[None, :]).astype(jnp.complex64)


def _chunk(n: int, parts: int):
    """(chunk, padded) — smallest equal split of n over parts."""
    chunk = -(-n // parts)
    return chunk, chunk * parts


# --------------------------------------------------------------- stage C
def _payload_stage(
    local: jax.Array,
    pstart: jax.Array,
    G_occ: jax.Array,
    noise_var: jax.Array,
    cfg: ModemConfig,
    n_time: int,
    n_sc: int,
    occ_idx: jax.Array,
    fuse_eq: bool,
):
    """CP-strip + FFT the OFDM symbols whose start sample falls in this
    shard's time block, striped over the 'sc' axis.

    Device (t, s) handles the local symbol slots j with j % n_sc == s, so a
    (n_time x n_sc) mesh divides the payload FFT work n_time*n_sc ways
    (each symbol is owned by exactly one device).  Returns the RAW
    frequency-domain grid [pid_max, S, m_occ], psum-assembled over both
    axes and replicated everywhere.  With fuse_eq (every per-symbol
    detector), equalize + postprocess run HERE on each symbol's owning
    device before the scatter; the Alamouti/tracking tails need
    cross-symbol structure and consume the raw replicated grid instead.
    """
    S, Tloc = local.shape
    sym = cfg.symbol_len
    m_occ = cfg.M_occupied
    nloc = -(-Tloc // sym) + 1
    nloc_sc = -(-nloc // n_sc)
    me = jax.lax.axis_index("time")
    sc_rank = jax.lax.axis_index("sc")
    base = me * Tloc

    if n_time > 1:
        right = jax.lax.ppermute(
            local[:, :sym], "time", [(j + 1, j) for j in range(n_time - 1)]
        )
    else:
        right = jnp.zeros((S, sym), dtype=local.dtype)
    ext = jnp.concatenate([local, right], axis=-1)  # [S, Tloc + sym]

    # first global symbol index owned by this shard: smallest k with
    # pstart + k*sym >= base
    k0 = jnp.maximum(0, -((pstart - base) // sym)).astype(jnp.int32)
    rel0 = pstart + k0 * sym - base  # in [0, sym) when k0 > 0

    js = sc_rank + jnp.arange(nloc_sc, dtype=jnp.int32) * n_sc
    ks = k0 + js
    rels = rel0 + js * sym
    owned = (rels >= 0) & (rels < Tloc) & (ks < cfg.pid_max)

    # this device's windows form a UNIFORM stride = n_sc*sym grid from
    # rel0 + sc_rank*sym (>= 0 by construction of k0): grab the whole
    # span with ONE dynamic_slice and peel symbols with the dispatched
    # strip_cp (a vmapped dynamic_slice per symbol lowers to while-loops
    # materializing shard-sized copies).  Unowned slots read zeros or
    # garbage from the padded tail and are masked out before the psum
    # scatter.
    from rub_mimo_tpu.pipeline.rx import strip_cp

    stride = n_sc * sym
    span_len = (nloc_sc - 1) * stride + sym
    ext_p = jnp.pad(ext, ((0, 0), (0, span_len)))
    off0 = (rel0 + sc_rank * sym).astype(jnp.int32)
    start = jnp.clip(off0, 0, ext_p.shape[-1] - span_len)
    span = jax.lax.dynamic_slice(
        ext_p, (jnp.int32(0), start), (S, span_len)
    )
    if span_len < nloc_sc * stride:
        span = jnp.pad(span, ((0, 0), (0, nloc_sc * stride - span_len)))

    x_t = strip_cp(span, nloc_sc, stride, cfg.cp_len)
    if x_t.shape[-1] != cfg.M:
        x_t = x_t[:, :, : cfg.M]  # n_sc > 1: keep the first M past the CP

    x_t = jnp.moveaxis(x_t, 0, 1)  # [nloc_sc, S, M]
    X = jnp.fft.fft(x_t, axis=-1) * np.float32(1.0 / np.sqrt(m_occ))
    Y = X[:, :, occ_idx]  # [nloc_sc, S, m_occ]

    if fuse_eq:
        # every device owns WHOLE symbols (all subcarriers), so it can
        # equalize + postprocess its own slots locally with replicated
        # CSI and the separate sc-sharded equalize stage's second
        # full-grid psum assembly disappears (~half the measured
        # 1-device sharding overhead came from the two [pid, S, m_occ]
        # grid assemblies).  The per-subcarrier weights are tiny
        # ([m_occ, S, S]); computing them replicated costs less than
        # assembling the raw grid.  Bit-equal: equalize is per-symbol,
        # with identical weights and contraction order.
        from rub_mimo_tpu.detect.dispatch import equalize_dispatch
        from rub_mimo_tpu.detect.postprocess import postprocess_eq
        from rub_mimo_tpu.detect.weights import weights_from

        W, gain = weights_from(cfg, G_occ, noise_var)
        Y = postprocess_eq(
            equalize_dispatch(Y, G_occ, W, gain, cfg), cfg
        ).astype(jnp.complex64)

    # scatter this device's symbols into the global [pid, S, m_occ] grid
    # and psum-assemble over BOTH mesh axes (each symbol has exactly one
    # owner; row pid_max is the trash slot for unowned lanes)
    dest = jnp.where(owned, ks, jnp.int32(cfg.pid_max))
    local_out = jnp.zeros(
        (cfg.pid_max + 1, S, m_occ), dtype=jnp.complex64
    ).at[dest].add(jnp.where(owned[:, None, None], Y, 0))
    return jax.lax.psum(local_out[: cfg.pid_max], ("time", "sc"))


# ------------------------------------------------- stage B': mf + LS (sc)
def _mf_stage(region: jax.Array, cfg: ModemConfig, n_sc: int, joint: bool):
    """Matched-filter offset search with the template axis sharded over
    'sc': the (offset x 41-sequence x rx) fan-out of framing.cc:702-744 is
    embarrassingly parallel over sequences, so each 'sc' device correlates
    its own chunk of S0/S1 templates against the replicated region and the
    chunks are scatter/psum-assembled before the argmax.  Each vals row
    depends only on its own template, so the assembled tensor is bitwise
    identical to matched_filter.search's."""
    S = cfg.num_streams
    sym = cfg.symbol_len
    n_seq = 1 + cfg.num_access_codes * S
    chunk, n_pad = _chunk(n_seq, n_sc)

    tmpl_np = matched_filter.templates(cfg)
    tmpl_pad = np.zeros((n_pad, cfg.M), np.complex64)
    tmpl_pad[:n_seq] = tmpl_np
    base_pad = np.zeros((n_pad,), np.int32)
    base_pad[:n_seq] = np.arange(n_seq, dtype=np.int32) * sym

    rank = jax.lax.axis_index("sc")
    start = rank * chunk
    t_chunk = jax.lax.dynamic_slice(
        jnp.asarray(tmpl_pad), (start, jnp.int32(0)), (chunk, cfg.M)
    )
    b_chunk = jax.lax.dynamic_slice(jnp.asarray(base_pad), (start,), (chunk,))
    vals_chunk = matched_filter.corr_vals(region, cfg, t_chunk, b_chunk)

    full = jnp.zeros((S, n_pad, sym), jnp.float32)
    full = jax.lax.dynamic_update_slice(
        full, vals_chunk, (jnp.int32(0), start, jnp.int32(0))
    )
    vals = jax.lax.psum(full, "sc")[:, :n_seq]
    mf = matched_filter.finalize(vals, cfg, joint=joint)
    return mf.s0_index, mf.ac_index


def _estimate_stage(
    region: jax.Array,
    ac_index: jax.Array,
    cfg: ModemConfig,
    n_sc: int,
    need_nv: bool,
    uniform: bool = False,
):
    """LS channel estimation with the access-code FFT batch sharded over
    'sc': the codes x rx x tx window FFTs (framing.cc:801-824; 80 FFTs at
    the reference operating point) split by code across the 'sc' devices,
    are scatter/psum-gathered, and the cheap ratio/accumulate runs
    replicated — bitwise identical to estimate.ls.estimate_channel.
    Returns (G [M, rx, tx], noise_var []) replicated."""
    S = cfg.num_streams
    M = cfg.M
    codes = cfg.num_access_codes
    chunk, codes_pad = _chunk(codes, n_sc)

    offsets = ls.ac_offsets(ac_index, cfg)  # [codes, rx, tx]
    off_pad = jnp.pad(offsets, ((0, codes_pad - codes), (0, 0), (0, 0)))
    rank = jax.lax.axis_index("sc")
    start = rank * chunk
    off_chunk = jax.lax.dynamic_slice(
        off_pad, (start, jnp.int32(0), jnp.int32(0)), (chunk, S, S)
    )
    # joint timing: each device's code chunk keeps the uniform
    # symbol-pitch grid (base shifted by start*S*sym), so the static-
    # slice extraction applies instead of the sequential per-window
    # dynamic-slice scan.  Only when n_sc divides the code count: a chunk
    # holding PAD rows would extend its structural grid past the region
    # end and the defensive base clamp would shift its REAL windows too.
    use_uniform = uniform and codes_pad == codes
    X_chunk = ls.code_ffts(region, off_chunk, cfg,
                           uniform=use_uniform)  # [chunk, S, S, M]

    Xfull = jnp.zeros((codes_pad, S, S, M), X_chunk.dtype)
    Xfull = jax.lax.dynamic_update_slice(
        Xfull, X_chunk,
        (start, jnp.int32(0), jnp.int32(0), jnp.int32(0)),
    )
    X = jax.lax.psum(Xfull, "sc")[:codes]
    G = ls.channel_from_ffts(X, cfg)
    if need_nv:
        nv = ls.noise_var_from_ffts(X, G, cfg)
    else:
        nv = jnp.float32(cfg.mmse_noise_var)
    return G, nv


def build_sharded_decoder(cfg: ModemConfig, mesh: Mesh, T: int,
                          input_format: str = "complex"):
    """jit-compiled sharded decoder for [streams, T] captures placed with
    parallel.mesh.shard_capture (T must be a multiple of the 'time' size).

    input_format="planes": the decoder takes (re, im) float32 planes
    placed with parallel.mesh.shard_capture_planes instead of one
    complex64 capture."""
    S = cfg.num_streams
    M = cfg.M
    sym = cfg.symbol_len
    m_occ = cfg.M_occupied
    n_time = mesh.shape["time"]
    if T % n_time:
        raise ValueError("T must be padded to a multiple of the time axis")
    if T // n_time < sym:
        raise ValueError("each time shard must cover at least symbol_len")
    n_sc = mesh.shape.get("sc", 1)
    n_seq = 1 + cfg.num_access_codes * S
    region_len = sym * n_seq + M
    p = cfg.subcarrier_allocation()
    occ_idx = jnp.asarray(sctype.occupied_indices(p))
    joint = (not cfg.bit_exact) and cfg.timing_mode == "joint"
    need_nv = cfg.detector == Detector.MMSE and cfg.mmse_auto_noise

    spec_t = P(None, "time")
    # stage A: the coarse+refine fast path applies when the shard size
    # aligns with the coarse grid (the same static preconditions as the
    # offline _synchronize_coarse); its per-shard exactness flag falls
    # back to the full-rate scan via lax.cond on a replicated predicate
    Tloc = T // n_time
    D = schmidl_cox._coarse_stride(cfg)
    coarse_ok = (
        D >= 2
        and (cfg.M // 2) % D == 0
        and Tloc % D == 0
        and Tloc >= 2 * cfg.M + 4 * cfg.cp_len + 4 * D
        # a shard must cover its own left halo: smaller shards would
        # slice short in _coarse_sync_stage and silently misalign all
        # ext/global coordinate math — they take the full-rate scan
        and Tloc >= coarse_left_halo(cfg)
        # the sharded coarse stage implements the all-streams rule only;
        # quorum configs (robust 4x4) take the full-rate scan, which
        # supports it
        and cfg.sync_quorum is None
    )

    def _stage_a(local):
        if not coarse_ok:
            return _sync_stage(local, cfg=cfg, n_time=n_time)
        need_full, best_t, starts, fired, corr = _coarse_sync_stage(
            local, cfg, n_time, T
        )

        def full(_):
            return _sync_stage(local, cfg=cfg, n_time=n_time)

        def fast(_):
            # all-streams rule (coarse_ok excludes quorum): full mask
            return best_t, starts, fired, corr, jnp.ones((S,), jnp.bool_)

        return jax.lax.cond(need_full, full, fast, operand=None)

    # The capture rides through every shard_map as (re, im) f32 planes
    # and is combined INSIDE each stage body, where the lax.complex fuses
    # into the consuming math.
    def _cx(fn):
        def wrapped(re, im, *rest):
            return fn(jax.lax.complex(re, im), *rest)

        return wrapped

    sync_sharded = jax.shard_map(
        _cx(_stage_a),
        mesh=mesh,
        in_specs=(spec_t, spec_t),
        out_specs=(P(), P(None), P(), P(None), P(None)),
    )

    def _derotate_planes(re, im, eps, ref):
        out = _derotate_stage(jax.lax.complex(re, im), eps, ref, M=M)
        return jnp.real(out), jnp.imag(out)

    derotate_sharded = jax.shard_map(
        _derotate_planes,
        mesh=mesh,
        in_specs=(spec_t, spec_t, P(), P()),
        out_specs=(spec_t, spec_t),
    )
    xcorr_sharded = jax.shard_map(
        _cx(functools.partial(_xcorr_stage, cfg=cfg, n_time=n_time,
                              T_total=T)),
        mesh=mesh,
        in_specs=(spec_t, spec_t),
        out_specs=(P(), P()),
    )
    region_sharded = jax.shard_map(
        _cx(functools.partial(_region_stage, region_len=region_len)),
        mesh=mesh,
        in_specs=(spec_t, spec_t, P()),
        out_specs=P(None, None),
    )
    # equalize fuses into the payload stage whenever the detector is
    # per-symbol (everything except the cross-symbol Alamouti/tracking
    # tails): one grid assembly instead of two
    fuse_eq = cfg.mode != CommMode.ALAMOUTI and not cfg.track_channel
    payload_sharded = jax.shard_map(
        _cx(functools.partial(
            _payload_stage, cfg=cfg, n_time=n_time, n_sc=n_sc,
            occ_idx=occ_idx, fuse_eq=fuse_eq,
        )),
        mesh=mesh,
        in_specs=(spec_t, spec_t, P(), P(None, None, None), P()),
        out_specs=P(None, None, None),
    )
    mf_sharded = jax.shard_map(
        functools.partial(_mf_stage, cfg=cfg, n_sc=n_sc, joint=joint),
        mesh=mesh,
        in_specs=P(None, None),
        out_specs=(P(None), P(None, None)),
    )
    estimate_sharded = jax.shard_map(
        functools.partial(
            _estimate_stage, cfg=cfg, n_sc=n_sc, need_nv=need_nv,
            uniform=joint,
        ),
        mesh=mesh,
        in_specs=(P(None, None), P(None, None)),
        out_specs=(P(None, None, None), P()),
    )

    def run(iq_re: jax.Array, iq_im: jax.Array) -> ShardedDecodeResult:
        # ---- stage A ----
        t_star, starts, synced, corr_at, pmask = sync_sharded(iq_re, iq_im)
        t_star = jnp.where(synced, t_star, jnp.int32(0))
        nmask = jnp.maximum(jnp.sum(pmask.astype(jnp.int32)), 1)
        sync_index = (
            jnp.sum(jnp.where(pmask, starts, 0)) // nmask
        ).astype(jnp.int32)
        sync_index = jnp.where(synced, sync_index, jnp.int32(0))
        use_fb = jnp.bool_(False)
        if cfg.sync_fallback:
            fb_q, fb_p = xcorr_sharded(iq_re, iq_im)
            use_fb = (~synced) & (fb_q > cfg.sync_fallback_threshold)
            synced = synced | use_fb
            sync_index = jnp.where(
                use_fb, (fb_p + M - cfg.cp_len).astype(jnp.int32), sync_index
            )
        cfo0 = jnp.angle(jnp.sum(-corr_at)).astype(jnp.float32) / np.pi

        if cfg.correct_cfo:
            # coarse derotation with global phase reference 0 (matches the
            # offline pipeline); the plateau correlation is garbage when
            # sync came from the fallback -> defer to the S0-halves
            # estimator on the region (below)
            cfo0 = jnp.where(use_fb, jnp.float32(0.0), cfo0)
            iq_re, iq_im = derotate_sharded(iq_re, iq_im, cfo0,
                                            jnp.float32(0.0))

        # ---- stage B ----
        rstart = sync_index - sym  # window starts one symbol before sync
        region = region_sharded(iq_re, iq_im, rstart)

        s0_idx, ac_idx = mf_sharded(region)
        cfo_total = cfo0
        if cfg.correct_cfo:
            # fallback-sync coarse (S0 halves) + access-code residual;
            # region derotations use the region-start phase reference and
            # the sharded capture the same global reference, exactly the
            # offline path's window derotation
            from rub_mimo_tpu.estimate import cfo as cfo_mod

            j = jnp.arange(region_len, dtype=jnp.float32)

            def derot_region(r, e):
                return (r * jnp.exp(
                    -2j * jnp.pi * e * j / M
                )[None, :]).astype(jnp.complex64)

            eps_s0 = jnp.where(
                use_fb, cfo_mod.s0_halves_cfo(region, s0_idx, cfg),
                jnp.float32(0.0),
            )
            eps1 = cfo_mod.residual_cfo(
                derot_region(region, eps_s0) if cfg.sync_fallback
                else region,
                ac_idx, cfg,
            )
            region = derot_region(region, eps_s0 + eps1)
            iq_re, iq_im = derotate_sharded(
                iq_re, iq_im, eps_s0 + eps1, rstart.astype(jnp.float32)
            )
            s0_idx, ac_idx = mf_sharded(region)
            cfo_total = cfo0 + eps_s0 + eps1
        G, noise_var = estimate_sharded(region, ac_idx)
        if cfg.smooth_channel:
            from rub_mimo_tpu.estimate import smooth

            G = smooth.smooth_channel_estimate(G, cfg)
        G_occ = G[occ_idx]

        # ---- stage C: payload CP-strip + FFT (+ fused equalize for the
        # per-symbol detectors), striped over time x sc ----
        decode_start = (ac_idx[S - 1, -1] + M).astype(jnp.int32)
        pstart = jnp.maximum(rstart + decode_start, 0)
        Ygrid = payload_sharded(iq_re, iq_im, pstart, G_occ, noise_var)
        from rub_mimo_tpu.detect.postprocess import postprocess_eq

        if fuse_eq:
            out = Ygrid  # already equalized + postprocessed in-stage
        elif cfg.mode == CommMode.ALAMOUTI:
            from rub_mimo_tpu.detect import alamouti as alamouti_mod

            dec1 = alamouti_mod.combine_pairs(Ygrid, G_occ)  # [pid, m_occ]
            eqg = jnp.zeros_like(Ygrid).at[:, 0, :].set(dec1)
            out = postprocess_eq(eqg, cfg)
        else:
            # identical lax.scan to the offline tracker over the identical
            # assembled Y grid -> bit-equal decisions (pipeline.rx:188-194);
            # the scan is batched [m_occ, S, S] solves, negligible next to
            # the sharded FFTs, so running it replicated costs nothing.
            from rub_mimo_tpu.detect import tracking

            eqg, _ = tracking.track_and_equalize(
                Ygrid, G_occ, cfg,
                block_frames=cfg.track_block_frames,
                alpha=cfg.track_alpha,
            )
            out = postprocess_eq(eqg, cfg)
        sig3 = jnp.moveaxis(out, 0, 1)  # [S, pid, m_occ]
        rx_sig = sig3.reshape(S, cfg.pid_max * m_occ)
        rx_data = constellation.demodulate(rx_sig, cfg.modulation)
        return ShardedDecodeResult(
            synced=synced,
            sync_index=sync_index,
            sync_sample=t_star,
            cfo_hat=cfo_total,
            G=G,
            decode_start=decode_start,
            rx_sig=rx_sig,
            rx_data=rx_data,
        )

    if input_format == "planes":
        return jax.jit(run)
    if input_format == "complex":
        def run_complex(iq):
            return run(jnp.real(iq).astype(jnp.float32),
                       jnp.imag(iq).astype(jnp.float32))

        return jax.jit(run_complex)
    raise ValueError(f"unknown input_format {input_format!r}")
