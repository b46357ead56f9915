"""The full RX decode pipeline: one pure, jit-compiled function.

Array-native replacement for the reference's framesync state machine + offline
replay (rx_worker re-reads the capture and runs fs.execute() per sample,
mimo/main.cc:906-922, framing.cc:471-506).  The serial 4-state machine
collapses into a fixed pipeline of batched array ops:

  capture [streams, T]
    -> Schmidl&Cox metric + plateau scan  -> sync_index      (sync/)
    -> replay-window slice (starts one symbol before sync_index, exactly
       the reference's windowcf content at estimation time, framing.cc:284,
       639-651)
    -> matched-filter offset search                          (sync/)
    -> LS channel estimate Ghat                              (estimate/)
    -> ZF / MMSE weights                                     (detect/)
    -> payload slice from corr_indices[last_rx][last_ac] + M
       (framing.cc:857), CP strip + batched FFT + equalize   (detect/)
    -> nearest-neighbour demap                               (ofdm/)

Everything is static-shaped given (cfg, T): jit once per capture length.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from rub_mimo_tpu.config import CommMode, Detector, ModemConfig
from rub_mimo_tpu.estimate import ls
from rub_mimo_tpu.ofdm import constellation, sctype
from rub_mimo_tpu.sync import matched_filter, schmidl_cox
from rub_mimo_tpu.utils.impl_select import best_impl, check_impl


class DecodeResult(NamedTuple):
    synced: jax.Array            # bool
    sync_index: jax.Array        # int32 (framesync::get_sync_index)
    sync_sample: jax.Array       # int32 — sample where sync fired
    plateau_start: jax.Array     # int32[streams]
    plateau_end: jax.Array       # int32[streams]
    cfo_hat: jax.Array           # float32, subcarrier units (total)
    cfo_coarse: jax.Array        # float32 — global-reference component
                                 # (the residual's phase ref is the window
                                 # start; checkpoint.resume needs the split)
    G: jax.Array                 # complex64[M, rx, tx] (framesync::get_G)
    W: jax.Array                 # complex64[M_occupied, out, rx]
    normalize_gain: jax.Array    # float32[M_occupied]
    s0_index: jax.Array          # int32[streams]
    ac_index: jax.Array          # int32[streams, codes*streams]
    decode_start: jax.Array      # int32 — window offset of first payload CP
    rx_sig: jax.Array            # complex64[streams, pid_max * M_occupied]
    rx_data: jax.Array           # int32[streams, pid_max * M_occupied]
    symbol_valid: jax.Array      # bool[pid_max] — symbol fully inside capture
    metric: jax.Array | None     # float32[streams, T] when keep_debug
    mf_traces: jax.Array | None  # float32[streams, n_seq, symbol_len] "
    Y: jax.Array | None = None   # complex64[n_sym, rx, m_occ] raw payload
                                 # grid, kept when detector == ML so
                                 # fec.decode_payload_ml can form joint
                                 # soft LLRs from the lattice search


def _extract_window(iq: jax.Array, sync_index: jax.Array, cfg: ModemConfig):
    """Replay window [streams, window_len] starting at sync_index - symbol_len.

    Matches the windowcf content when estimation triggers: the window holds
    the last access_code_buffer_len + tx_sig_samples pushed samples, whose
    first element is capture[sync_index - symbol_len] (derivation: trigger
    at sync_index + tx_sig + acbl - symbol_len samples processed,
    framing.cc:639-647; window length acbl + tx_sig, framing.cc:387-388).
    Out-of-range regions are zero, like the windowcf's zero-initialized
    backing store.

    NOTE: the decode path no longer materializes this (capture-sized)
    window — estimation reads the small region prefix (_extract_region)
    and the payload is flat-gathered from the capture directly.  Kept for
    checkpoint/debug consumers.
    """
    S = cfg.num_streams
    padded = jnp.pad(iq, ((0, 0), (cfg.symbol_len, cfg.window_len)))
    start = jnp.clip(sync_index, 0, iq.shape[-1])
    return jax.lax.dynamic_slice(
        padded, (jnp.int32(0), start.astype(jnp.int32)), (S, cfg.window_len)
    )


def _extract_region(iq: jax.Array, sync_index: jax.Array, cfg: ModemConfig,
                    impl: str = "xla"):
    """The ESTIMATION prefix of the replay window: one symbol of lead-in
    plus the S0 + access-code span plus an M-sample search margin — all
    that the matched filter, CFO estimators, LS estimate, and noise-var
    derivation read.  [streams, region_len] with region offsets identical
    to window offsets (the region IS the window's prefix), so ac_index /
    s0_index interoperate unchanged.  ~(n_seq+1) symbols instead of the
    full window's n_seq+4+pid_max — the copy and every downstream FFT
    shrink by ~25x at the reference operating point.

    Implemented through extract_payload (identical windowcf read-zeros
    semantics), so no capture-sized padded copy is materialized."""
    region_len = cfg.symbol_len * (1 + cfg.num_access_codes
                                   * cfg.num_streams) + cfg.M
    start = jnp.clip(sync_index, 0, iq.shape[-1]) - cfg.symbol_len
    return extract_payload(iq, start, region_len, impl=impl)


def extract_payload(
    iq: jax.Array, cstart: jax.Array, plen: int, impl: str = "auto"
) -> jax.Array:
    """The payload grab: ``iq[:, cstart : cstart + plen]`` with windowcf
    read-zeros semantics outside the capture (framing.cc:284, 639-651).

    A named function so ``bench.py --check`` can time every impl
    compiled on the device against the same inputs the decode uses.

    impl: "auto" (consult the measured table), "xla_pad" (pad both ends
    by plen once, then ONE plain dynamic_slice — branch-free, exact
    windowcf semantics for every cstart), "xla" (lax.cond fast slice /
    slow clamp+roll+mask — the safe fallback), "xla_slow" (the slow
    formulation unconditionally: for vmapped decodes, where vmap turns
    the cond into a select that runs both branches).
    """
    S, T = iq.shape
    check_impl("window", impl)
    if impl == "auto":
        impl = best_impl("window", jax.default_backend())
    if impl == "xla_pad":
        # windowcf read-zeros semantics with NO data-dependent control
        # flow: iq embedded in a zero sea of plen each side, so the
        # window at any cstart in [-plen, T] is a plain in-range slice,
        # and every cstart outside that range lands (via the clip) on an
        # all-zero span — exactly the reference's zero-initialized ring.
        padded = jnp.pad(iq, ((0, 0), (plen, plen)))
        start = (jnp.clip(cstart, -plen, T) + plen).astype(jnp.int32)
        return jax.lax.dynamic_slice(
            padded, (jnp.int32(0), start), (S, plen)
        )
    # XLA formulation.  FAST branch (the overwhelmingly common case —
    # the window sits fully inside the capture): one plain
    # dynamic_slice, two HBM passes, nothing else.  SLOW branch (the
    # window starts before 0 or runs past T): slice at a start clamped
    # so the window always fits, roll the clamp shortfall back out,
    # zero-mask out-of-capture positions.  lax.cond keeps the roll +
    # mask off the hot path instead of paying them on every decode.
    if T >= plen:
        def _fast(_):
            s0 = jnp.clip(cstart, 0, T - plen).astype(jnp.int32)
            return jax.lax.dynamic_slice(
                iq, (jnp.int32(0), s0), (S, plen)
            )

        def _slow(_):
            # clip BOTH ends (dynamic_slice clamps internally; an
            # unclipped negative s0 would desync the roll from the
            # actual slice start) and mask both out-of-capture sides
            s0 = jnp.clip(cstart, 0, T - plen).astype(jnp.int32)
            shortfall = (cstart - s0).astype(jnp.int32)
            payload = jax.lax.dynamic_slice(
                iq, (jnp.int32(0), s0), (S, plen)
            )
            payload = jnp.roll(payload, -shortfall, axis=-1)
            k = jnp.arange(plen, dtype=jnp.int32)[None, :]
            p = cstart + k
            return jnp.where((p >= 0) & (p < T), payload, 0.0)

        if impl == "xla_slow":
            return _slow(None)
        fits = (cstart >= 0) & (cstart + plen <= T)
        return jax.lax.cond(fits, _fast, _slow, operand=None)
    # capture shorter than the payload span: pad right once.  The roll
    # must honour NEGATIVE starts too (roll right), with the wrap junk
    # masked by the p >= 0 side of the range check.
    payload = jnp.pad(iq, ((0, 0), (0, plen - T)))
    payload = jnp.roll(payload, -jnp.clip(cstart, -plen, plen), axis=-1)
    k = jnp.arange(plen, dtype=jnp.int32)[None, :]
    p = cstart + k
    return jnp.where((p >= 0) & (p < T), payload, 0.0)


def strip_cp(
    payload: jax.Array,
    n_sym: int,
    symbol_len: int,
    cp_len: int,
    impl: str = "auto",
) -> jax.Array:
    """Per-symbol CP strip of the flat payload:
    ``payload.reshape(S, n_sym, symbol_len)[:, :, cp_len:]``
    (framing.cc:558).

    Named (like extract_payload) so ``bench.py --check`` can time every
    impl compiled on the device.  impl: "auto" (consult the measured
    table), "xla" (reshape + slice — the safe fallback, vmaps cleanly),
    "xla128" (per re/im plane, group symbols into superblocks whose f32
    length is a multiple of 128, reshape those, then peel each in-block
    symbol with a static offset slice)."""
    check_impl("cpstrip", impl)
    if impl == "auto":
        impl = best_impl("cpstrip", jax.default_backend())
    S = payload.shape[0]
    M = symbol_len - cp_len
    if impl == "xla128":
        import math

        # operate per real plane (no complex<->f32 views)
        G = 128 // math.gcd(symbol_len, 128)  # symbols per 128-lane-
        nsb = -(-n_sym // G)                  # aligned supergroup (16)
        need = nsb * G * symbol_len

        def plane(q):  # [S, plen] f32 -> [S, n_sym, M]
            if q.shape[1] < need:
                q = jnp.pad(q, ((0, 0), (0, need - q.shape[1])))
            elif q.shape[1] > need:
                q = q[:, :need]
            q3 = q.reshape(S, nsb, G * symbol_len)  # minor % 128 == 0
            xt = jnp.stack(
                [q3[:, :, g * symbol_len + cp_len : (g + 1) * symbol_len]
                 for g in range(G)],
                axis=2,
            )                                        # [S, nsb, G, M]
            return xt.reshape(S, nsb * G, M)[:, :n_sym]

        if jnp.issubdtype(payload.dtype, jnp.complexfloating):
            return jax.lax.complex(
                plane(jnp.real(payload)), plane(jnp.imag(payload))
            )
        return plane(payload)
    p = payload[:, : n_sym * symbol_len].reshape(S, n_sym, symbol_len)
    return p[:, :, cp_len:]


def decode(
    iq: jax.Array,
    cfg: ModemConfig,
    *,
    keep_debug: bool = False,
    mf_method: str = "xcorr",
    sync_impl: str = "auto",
    window_impl: str = "auto",
    cpstrip_impl: str = "auto",
) -> DecodeResult:
    """Decode a whole capture. iq: [num_streams, T] complex64.

    sync_impl: forwarded to sync.schmidl_cox.synchronize (batched,
    vmapped decodes pass "coarse_full").

    window_impl: "auto" consults the committed on-chip measurement
    table (utils.impl_select, regenerated by ``bench.py --check``) and
    picks the fastest impl that passed the equality check on this
    backend — falling back to "xla" (the clamp+roll+mask formulation,
    vmappable; batched decodes force it) when unmeasured."""
    S = cfg.num_streams
    M = cfg.M
    m_occ = cfg.M_occupied
    p = cfg.subcarrier_allocation()
    _occ_np = np.asarray(sctype.occupied_indices(p))
    occ_idx = jnp.asarray(_occ_np)
    T = iq.shape[-1]

    # Each stage runs under a jax.named_scope: the scope names are what
    # a profiler trace's device ops are grouped by (benchmarks/
    # stage_times.py), so they are kept stable.
    # ---- sync ----
    with jax.named_scope("sync"):
        sync = schmidl_cox.synchronize(
            iq, cfg, keep_metric=keep_debug, impl=sync_impl
        )
    synced = sync.synced
    sync_index = sync.sync_index
    use_fb = jnp.bool_(False)
    if cfg.sync_fallback:
        from rub_mimo_tpu.sync import xcorr_sync

        fb = xcorr_sync.s0_xcorr_sync(iq, cfg)
        use_fb = (~synced) & (fb.quality > cfg.sync_fallback_threshold)
        synced = synced | use_fb
        sync_index = jnp.where(use_fb, fb.sync_index, sync_index)
    coarse_cfo = sync.cfo_hat
    if cfg.correct_cfo:
        # the plateau correlation is garbage when sync came from the
        # fallback — defer the fallback case's coarse estimate to the
        # S0-halves estimator on the window (below)
        coarse_cfo = jnp.where(use_fb, jnp.float32(0.0), sync.cfo_hat)
        iq = schmidl_cox.correct_cfo(iq, coarse_cfo, M)

    # ---- replay region (estimation prefix of the reference's windowcf;
    # the matched filter / CFO / LS / noise-var all live here).
    # xla_slow under a batch axis (vmap turns the fast/slow cond into a
    # both-branches select); the cond'd formulation otherwise ----
    joint = (not cfg.bit_exact) and cfg.timing_mode == "joint"
    with jax.named_scope("matched_filter"):
        region = _extract_region(
            iq, sync_index, cfg,
            impl="xla_slow" if window_impl == "xla_slow" else "xla",
        )
        # ---- matched-filter offset search ----
        mf = matched_filter.search(
            region, cfg, method=mf_method, joint=joint,
            keep_traces=keep_debug,
        )

    cfo_total = coarse_cfo
    if cfg.correct_cfo:
        from rub_mimo_tpu.estimate import cfo as cfo_mod

        # fallback-sync case: coarse CFO from the S0 halves at the
        # matched filter's S0 location (the plateau corr never fired)
        eps_s0 = jnp.where(
            use_fb, cfo_mod.s0_halves_cfo(region, mf.s0_index, cfg),
            jnp.float32(0.0),
        )
        # residual CFO from the access-code peak phase progression
        eps = cfo_mod.residual_cfo(
            schmidl_cox.correct_cfo(region, eps_s0, M)
            if cfg.sync_fallback else region,
            mf.ac_index, cfg,
        )
        region = schmidl_cox.correct_cfo(region, eps_s0 + eps, M)
        mf = matched_filter.search(
            region, cfg, method=mf_method, joint=joint,
            keep_traces=keep_debug,
        )
        cfo_total = coarse_cfo + eps_s0 + eps

    # ---- LS channel estimate ----
    # joint timing broadcasts one global argmax, so the 80 code windows
    # form a uniform symbol_len-pitch grid -> static-slice extraction
    # instead of a per-window dynamic-slice scan
    with jax.named_scope("ls_weights"):
        G = ls.estimate_channel(region, mf.ac_index, cfg, uniform=joint)
    if cfg.smooth_channel:
        from rub_mimo_tpu.estimate import smooth

        G = smooth.smooth_channel_estimate(G, cfg)
    _all_occ = _occ_np.size == M and np.array_equal(_occ_np, np.arange(M))
    G_occ = G if _all_occ else G[occ_idx]  # [m_occ, rx, tx]

    # ---- detector weights (shared across all pipelines) ----
    from rub_mimo_tpu.detect import weights as weights_mod

    with jax.named_scope("ls_weights"):
        W, gain = weights_mod.weights_for(cfg, G, G_occ, region,
                                          mf.ac_index)

    # ---- payload slice & batched OFDM demodulation ----
    # decode starts at the last access code's peak + M on the last rx stream
    # (the reference hardcodes rx index 1 == num_streams-1, framing.cc:857).
    # The payload is ONE contiguous slice straight from the capture —
    # formulation choices and their measured costs live in
    # extract_payload above.
    decode_start = (mf.ac_index[S - 1, -1] + M).astype(jnp.int32)
    n_sym = cfg.pid_max
    plen = n_sym * cfg.symbol_len
    # capture-coordinate start; >= 0 always (decode_start >= M and the
    # window origin is sync_index - symbol_len with sync_index >= 0)
    cstart = jnp.clip(sync_index, 0, T) + decode_start - cfg.symbol_len
    with jax.named_scope("payload_grab"):
        payload = extract_payload(iq, cstart, plen, impl=window_impl)

    # CP strip + symbol split (framing.cc:558) — impl-dispatched
    with jax.named_scope("cp_strip"):
        x_t = strip_cp(payload, n_sym, cfg.symbol_len, cfg.cp_len,
                       impl=cpstrip_impl)
    if cfg.correct_cfo:
        # the residual rotation was applied to the region copy only; the
        # payload needs the same ramp, whose phase reference is the
        # window origin (sync_index - symbol_len): window-relative index
        # of payload element (k, j) is decode_start + k*symbol_len +
        # cp_len + j
        wrel = (
            decode_start.astype(jnp.float32)
            + (jnp.arange(n_sym, dtype=jnp.float32)[:, None]
               * np.float32(cfg.symbol_len))
            + np.float32(cfg.cp_len)
            + jnp.arange(M, dtype=jnp.float32)[None, :]
        )
        rot = jnp.exp(
            -2j * jnp.pi * (eps_s0 + eps) * wrel / np.float32(M)
        )
        x_t = x_t * rot[None, :, :]
    with jax.named_scope("fft"):
        X = jnp.fft.fft(x_t, axis=-1) * np.float32(1.0 / np.sqrt(m_occ))
    # all-carriers allocations (the reference default) make the
    # occupied-subcarrier gather an identity — skip it
    Y = X if _all_occ else X[:, :, occ_idx]  # [S(rx), n_sym, m_occ]
    Y = jnp.moveaxis(Y, 1, 0)  # [n_sym, S, m_occ]

    if cfg.mode == CommMode.ALAMOUTI:
        from rub_mimo_tpu.detect import alamouti as alamouti_mod

        dec1 = alamouti_mod.combine_pairs(Y, G_occ)  # [n_sym, m_occ]
        eq = jnp.zeros_like(Y)
        eq = eq.at[:, 0, :].set(dec1)
    elif cfg.track_channel:
        from rub_mimo_tpu.detect import tracking

        eq, _ = tracking.track_and_equalize(
            Y, G_occ, cfg,
            block_frames=cfg.track_block_frames, alpha=cfg.track_alpha,
        )
    else:
        from rub_mimo_tpu.detect.dispatch import equalize_dispatch

        with jax.named_scope("equalize_demap"):
            eq = equalize_dispatch(Y, G_occ, W, gain, cfg)

    from rub_mimo_tpu.detect.postprocess import postprocess_eq

    eq = postprocess_eq(eq, cfg)

    # symbol validity: the whole symbol must fall inside the real capture
    # (the reference would simply not have decoded past the buffer)
    win_valid = (T + cfg.symbol_len) - sync_index
    ends = decode_start + (jnp.arange(n_sym, dtype=jnp.int32) + 1) * cfg.symbol_len
    symbol_valid = (ends <= win_valid) & synced

    with jax.named_scope("equalize_demap"):
        rx_sig = jnp.moveaxis(eq, 0, 1).reshape(S, n_sym * m_occ)
        rx_data = constellation.demodulate(rx_sig, cfg.modulation)

    return DecodeResult(
        synced=synced,
        sync_index=sync_index,
        sync_sample=sync.sync_sample,
        plateau_start=sync.plateau_start,
        plateau_end=sync.plateau_end,
        cfo_hat=cfo_total,
        cfo_coarse=coarse_cfo if cfg.correct_cfo else jnp.float32(0.0),
        G=G,
        W=W,
        normalize_gain=gain,
        s0_index=mf.s0_index,
        ac_index=mf.ac_index,
        decode_start=decode_start,
        rx_sig=rx_sig,
        rx_data=rx_data,
        symbol_valid=symbol_valid,
        metric=sync.metric,
        mf_traces=mf.traces,
        Y=Y if cfg.detector == Detector.ML else None,
    )


def make_decoder(cfg: ModemConfig, *, keep_debug: bool = False,
                 mf_method: str = "xcorr", input_format: str = "complex"):
    """jit-compiled decode closure for a fixed config.

    input_format="planes": the closure takes (re, im) float32 planes
    instead of one complex64 capture (the format the native ingest ring
    and the streaming path produce)."""
    import functools

    def _run(iq):
        return decode(iq, cfg, keep_debug=keep_debug, mf_method=mf_method)

    if input_format == "planes":
        @functools.partial(jax.jit, static_argnames=())
        def _decode(re, im):
            return _run(jax.lax.complex(re, im))
    elif input_format == "complex":
        @functools.partial(jax.jit, static_argnames=())
        def _decode(iq):
            return _run(iq)
    else:
        raise ValueError(f"unknown input_format {input_format!r}")
    return _decode


def decode_all(
    iq: jax.Array,
    cfg: ModemConfig,
    *,
    max_bursts: int = 4,
    mf_method: str = "xcorr",
):
    """Decode MULTIPLE frame bursts from one long capture (continuous
    operation — the reference handles exactly one burst per process run).

    After each successful decode the consumed region (the replay window
    plus margin) is zeroed and the same jitted decoder re-runs, acquiring
    the next burst; stops at max_bursts or the first failed sync.  Bursts
    must be at least one replay window apart (they are, by construction —
    the window spans a full burst).  Returns a list of DecodeResults.
    """
    from rub_mimo_tpu.utils.transfer import to_host

    dec = make_decoder(cfg, mf_method=mf_method)
    erase_len = cfg.window_len + cfg.symbol_len

    @jax.jit
    def erase(x, start):
        start = jnp.clip(start, 0, x.shape[-1])
        zeros = jnp.zeros((cfg.num_streams, erase_len), x.dtype)
        padded = jnp.pad(x, ((0, 0), (0, erase_len)))
        padded = jax.lax.dynamic_update_slice(
            padded, zeros, (jnp.int32(0), start.astype(jnp.int32))
        )
        return padded[:, : x.shape[-1]]

    results = []
    for _ in range(max_bursts):
        r = dec(iq)
        if not bool(to_host(r.synced)):
            break
        results.append(r)
        iq = erase(iq, r.sync_index - cfg.symbol_len)
    return results


def make_serving_decoder(cfg: ModemConfig, *, mf_method: str = "xcorr",
                         input_format: str = "complex"):
    """THROUGHPUT-serving decoder: decode a stack of captures in ONE
    device program via ``lax.scan`` over the batch axis.

    Unlike make_batch_decoder's vmap (which turns every lax.cond into a
    both-branches select, forcing the slow formulations), scan compiles
    the single-capture body ONCE with its fast cond paths intact and
    executes the captures back-to-back on device, so one dispatch serves
    the whole batch.  This is the serving construct for one device;
    parallel.serving shards batches ACROSS devices.

    Returns a closure over [batch, S, T] complex (input_format
    "complex") or ((re, im) [batch, S, T] f32 planes, "planes");
    result fields are stacked along a leading batch axis."""
    import functools

    def _one(iq):
        r = decode(iq, cfg, mf_method=mf_method)
        return r._replace(metric=None, mf_traces=None)

    if input_format == "planes":
        @functools.partial(jax.jit, static_argnames=())
        def _serve(re_stack, im_stack):
            def body(c, x):
                return c, _one(jax.lax.complex(x[0], x[1]))

            _, rs = jax.lax.scan(body, 0, (re_stack, im_stack))
            return rs
    elif input_format == "complex":
        @functools.partial(jax.jit, static_argnames=())
        def _serve(stack):
            def body(c, x):
                return c, _one(x)

            _, rs = jax.lax.scan(body, 0, stack)
            return rs
    else:
        raise ValueError(f"unknown input_format {input_format!r}")
    return _serve


def make_batch_decoder(cfg: ModemConfig, *, mf_method: str = "xcorr"):
    """Decode MANY captures in one device program: vmap over a
    [batch, streams, T] stack.  The serving path — each capture runs the
    full sync/estimate/detect pipeline with its own dynamic sync point,
    and the batch amortizes every kernel launch (the reference processes
    one experiment per process, serially)."""
    import functools

    @functools.partial(jax.jit, static_argnames=())
    def _decode_batch(iq_batch):
        # coarse_full / xla_slow: the non-cond formulations — vmap turns
        # lax.cond into a both-branches select, so the single-capture
        # fast paths would be pure overhead under a batch axis
        return jax.vmap(
            lambda iq: decode(iq, cfg, keep_debug=False,
                              mf_method=mf_method, sync_impl="coarse_full",
                              window_impl="xla_slow", cpstrip_impl="xla")
        )(iq_batch)

    return _decode_batch
