"""On-device implementation self-check: equality + timing for every
backend-dispatched implementation, measured IN CONTEXT.

Run via ``bench.py --check``.  For each dispatch point (the payload
window grab, the S&C sync impl, the matched-filter method, the CP strip)
every candidate implementation is run COMPILED on the device **inside
the full decode** at the reference operating point — the full-decode
time is exactly the quantity the ``"auto"`` dispatches should minimize.
Results go to the committed table ``rub_mimo_tpu/data/impl_timings.json``
consumed by utils.impl_select: an impl that fails equality is recorded
``equal: false`` and can never win an auto dispatch; an impl that is
slow loses on measurement.

Impls whose previous run is recorded as a compile/runtime ``error`` are
skipped by default; pass ``retry_failed=True`` (``bench.py
--check-retry``) after fixing one.
"""

from __future__ import annotations

import functools
import json
import time

import numpy as np


def _sustained_ms(fn, args, iters: int) -> float:
    import jax

    jax.block_until_ready(fn(*args))  # compile + drain
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1e3


@functools.lru_cache(maxsize=1)
def _comparator():
    """Jitted on-device equality: only the boolean crosses to the
    host."""
    import functools as _ft

    import jax
    import jax.numpy as jnp

    @_ft.partial(jax.jit, static_argnames=("exact",))
    def equal(a_leaves, b_leaves, exact):
        ok = jnp.bool_(True)
        for a, b in zip(a_leaves, b_leaves):
            ct = jnp.result_type(a.dtype, b.dtype)
            a, b = a.astype(ct), b.astype(ct)
            same = jnp.all(a == b)
            if not exact and np.dtype(ct).kind in "fc":
                d = jnp.abs(a - b)
                tol = 1e-5 + 1e-4 * jnp.abs(b)
                same = same | jnp.all(d <= tol)
            ok = ok & same
        return ok

    return equal


def _equal(a_tree, b_tree, *, exact: bool) -> bool:
    import jax

    a_leaves = list(jax.tree_util.tree_leaves(a_tree))
    b_leaves = list(jax.tree_util.tree_leaves(b_tree))
    if len(a_leaves) != len(b_leaves):
        return False
    if any(a.shape != b.shape for a, b in zip(a_leaves, b_leaves)):
        return False
    return bool(_comparator()(a_leaves, b_leaves, exact=exact))


def _direct_tractable(cfg, budget_bytes: int = 2 << 30) -> bool:
    """The matched filter's method="direct" (reference-shaped gather +
    einsum, kept as the validation oracle for "xcorr") materializes a
    [S, n_seq, symbol_len, M] complex intermediate — ~3 TB at the
    reference operating point.  It is a small-dims validation method by
    construction; only measure it where the intermediate fits a sane
    budget."""
    n_seq = 1 + cfg.num_access_codes * cfg.num_streams
    need = cfg.num_streams * n_seq * cfg.symbol_len * cfg.M * 8
    return need <= budget_bytes


def run_check(frames: int = 1000, iters: int = 12, verbose: bool = False,
              write: bool = True, retry_failed: bool = False) -> dict:
    """Measure + equality-check every dispatched impl, each inside the
    full jit-compiled decode on the attached backend; merge results into
    the committed table and return them."""
    import jax
    import jax.numpy as jnp

    from rub_mimo_tpu.config import ModemConfig
    from rub_mimo_tpu.io import simulator
    from rub_mimo_tpu.pipeline import rx
    from rub_mimo_tpu.utils import impl_select

    backend = jax.default_backend()
    cfg = ModemConfig(pid_max=frames, bit_exact=False)
    spec = simulator.ChannelSpec(snr_db=30.0, delay=5000, seed=42)
    capture, _, _ = simulator.simulate_capture(cfg, spec)
    capture = jax.device_put(jnp.asarray(capture))
    S, T = capture.shape

    try:
        with open(impl_select.table_path()) as f:
            prev = json.load(f).get(backend, {})
    except (OSError, ValueError):
        prev = {}

    def log(msg):
        if verbose:
            import sys

            print(msg, file=sys.stderr, flush=True)

    fb = impl_select.FALLBACKS

    def mk_decode(window_impl=None, sync_impl=None, mf_method=None,
                  cpstrip_impl=None):
        w = window_impl or fb["window"]
        s = sync_impl or fb["sync"]
        m = mf_method or fb["matched_filter"]
        c = cpstrip_impl or fb["cpstrip"]
        return jax.jit(
            lambda x: rx.decode(x, cfg, window_impl=w, sync_impl=s,
                                mf_method=m, cpstrip_impl=c)
        )

    points = {
        "window": (
            ["xla", "xla_pad"],
            lambda impl: mk_decode(window_impl=impl),
        ),
        "sync": (
            ["coarse", "coarse128", "xla"],
            lambda impl: mk_decode(sync_impl=impl),
        ),
        "matched_filter": (
            ["xcorr"] + (["direct"] if _direct_tractable(cfg) else []),
            lambda impl: mk_decode(mf_method=impl),
        ),
        "cpstrip": (
            ["xla", "xla128"],
            lambda impl: mk_decode(cpstrip_impl=impl),
        ),
    }

    results: dict = {}
    for point, (impls, mk) in points.items():
        entry: dict = {}
        ref = None
        for impl in impls:
            old = prev.get(point, {}).get(impl, {})
            if old.get("error") and not retry_failed:
                # carry a recorded failure forward until retry_failed
                entry[impl] = dict(old, skipped="carried forward; rerun "
                                   "with --check-retry after a fix")
                log(f"{point}/{impl}: skipped (previous error carried)")
                continue
            fn = mk(impl)
            try:
                r = fn(capture)
                # integer decisions only: floats (rx_sig, G) can differ
                # in ulps between mathematically equal formulations
                cmp_tree = (r.synced, r.sync_index, r.sync_sample,
                            r.ac_index, r.symbol_valid, r.rx_data)
                if impl == fb[point]:
                    ref = cmp_tree
                eq = ref is not None and _equal(cmp_tree, ref, exact=True)
                ms = _sustained_ms(fn, (capture,), iters)
                entry[impl] = {"decode_ms": round(ms, 4), "equal": bool(eq)}
            except Exception as e:  # a broken impl is recorded, not fatal
                entry[impl] = {"decode_ms": None, "equal": False,
                               "error": f"{type(e).__name__}: {e}"[:200]}
            log(f"{point}/{impl}: {entry[impl]}")
        results[point] = entry

    if write:
        path = impl_select.table_path()
        try:
            with open(path) as f:
                table = json.load(f)
        except (OSError, ValueError):
            table = {}
        table[backend] = results
        table.setdefault("_meta", {})[backend] = {
            "method": "sustained_wall of the FULL decode with the impl "
                      "substituted (block_until_ready barrier); relative "
                      "ordering within a point drives auto selection",
            "frames": frames,
            "iters": iters,
            "capture_shape": [int(S), int(T)],
        }
        with open(path, "w") as f:
            json.dump(table, f, indent=2, sort_keys=True)
            f.write("\n")
        impl_select.reload_table()
        impl_select.best_impl.cache_clear()
    return {backend: results}
