"""Per-stage device time of the full-size decode, from a profiler trace.

Decodes the reference operating point (``ModemConfig(bit_exact=False)``:
M=2048, CP=152, 2x2, 20 access codes, 1000 frames, 32-ary) a few times
under ``jax.profiler`` and sums the device time of every XLA op by the
decode stage whose ``jax.named_scope`` it carries (pipeline.rx.decode:
sync, matched_filter, ls_weights, payload_grab, cp_strip, fft,
equalize_demap; ``other`` for ops outside a stage scope).  Kernels that
run inside a CUDA graph carry no scope in the trace; they are matched to
their HLO instruction (kernel ``loop_x_fusion_12`` is instruction
``loop_x_fusion.12``) and take that instruction's ``op_name``.  Also reports
the sustained decode time (20 queued runs, one block_until_ready), the
per-run module time and the device's idle share over the traced window.

  python benchmarks/stage_times.py [--iters 10] [--out FILE.json]
                                   [--trace-dir DIR]

Prints one JSON object naming the platform and device it ran on.  Fails
when the trace holds no device ops (a CPU run has no device plane).
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STAGES = ("sync", "matched_filter", "ls_weights", "payload_grab",
          "cp_strip", "fft", "equalize_demap")


def stage_of(texts) -> str:
    """The decode stage named in an op's name/metadata strings."""
    for t in texts:
        for st in STAGES:
            if (f"/{st}/" in t or t.endswith(f"/{st}")
                    or t.startswith(f"{st}/")):
                return st
    return "other"


def hlo_op_names(hlo_text: str) -> dict:
    """Kernel-style instruction name -> op_name metadata, from compiled
    HLO text."""
    out = {}
    for m in re.finditer(r'^\s*(?:ROOT )?%?([\w.\-]+) = [^\n]*?'
                         r'op_name="([^"]*)"', hlo_text, re.M):
        out[re.sub(r"[.\-]", "_", m.group(1))] = m.group(2)
    return out


def _union_ns(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(path: str, iters: int, op_names=None) -> dict:
    """Per-stage device ms per decode, module ms per run, the busiest
    kernels, and the idle share of the device over the traced span.
    op_names: kernel name -> HLO op_name (hlo_op_names)."""
    import jax

    op_names = op_names or {}
    pd = jax.profiler.ProfileData.from_file(path)
    stage_ns = {st: 0 for st in STAGES + ("other",)}
    kernel_ns = collections.Counter()
    kernel_stage = {}
    modules, ops, sample = [], [], []
    for plane in pd.planes:
        if not (plane.name or "").startswith("/device:"):
            continue
        lines = list(plane.lines)
        names = [ln.name or "" for ln in lines]
        op_lines = [ln for ln in lines if (ln.name or "") == "XLA Ops"]
        if not op_lines:  # no op line: take the stream lines
            op_lines = [ln for ln in lines
                        if (ln.name or "").startswith("Stream")]
        for ln in lines:
            if (ln.name or "") == "XLA Modules":
                modules += [(e.start_ns, e.start_ns + e.duration_ns)
                            for e in ln.events]
        for ln in op_lines:
            for e in ln.events:
                texts = ([e.name or "", op_names.get(e.name or "", "")]
                         + [str(v) for _, v in e.stats])
                st = stage_of(texts)
                stage_ns[st] += e.duration_ns
                kernel_ns[e.name] += e.duration_ns
                kernel_stage[e.name] = st
                ops.append((e.start_ns, e.start_ns + e.duration_ns))
                if len(sample) < 40:
                    sample.append({"line": ln.name, "name": e.name,
                                   "ns": e.duration_ns, "stage": st,
                                   "stats": {k: str(v)[:160]
                                             for k, v in e.stats}})
        plane_lines = names
    if not ops:
        raise RuntimeError(f"no device ops in {path}")
    span = (min(s for s, _ in modules), max(e for _, e in modules)) \
        if modules else (min(s for s, _ in ops), max(e for _, e in ops))
    busy = _union_ns([(max(s, span[0]), min(e, span[1])) for s, e in ops
                      if e > span[0] and s < span[1]])
    return {
        "stage_ms_per_decode": {k: v / iters / 1e6
                                for k, v in stage_ns.items()},
        "op_ms_per_decode": sum(stage_ns.values()) / iters / 1e6,
        "module_ms": sorted((e - s) / 1e6 for s, e in modules),
        "idle_share": 1.0 - busy / max(span[1] - span[0], 1),
        "top_kernels": [(k, v / iters / 1e6, kernel_stage[k])
                        for k, v in kernel_ns.most_common(25)],
        "device_lines": plane_lines,
        "sample_ops": sample,
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--out", default=None)
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args()

    import jax
    import numpy as np

    from rub_mimo_tpu.config import ModemConfig
    from rub_mimo_tpu.io import simulator
    from rub_mimo_tpu.pipeline import rx
    from rub_mimo_tpu.utils import compile_cache

    compile_cache.enable()
    dev = jax.devices()[0]
    cfg = ModemConfig(pid_max=args.frames, bit_exact=False)
    cap, tx, _ = simulator.simulate_capture(
        cfg, simulator.ChannelSpec(snr_db=30.0, delay=5000, seed=42))
    x = jax.device_put(cap, dev)
    dec = rx.make_decoder(cfg)
    op_names = hlo_op_names(dec.lower(x).compile().as_text())
    t0 = time.perf_counter()
    r = dec(x)
    jax.block_until_ready(r)
    compile_s = time.perf_counter() - t0
    n = cfg.pid_max * cfg.M_occupied
    errs = int((np.asarray(r.rx_data)[:, :n] != np.asarray(tx)[:, :n]).sum())

    runs = 20
    t0 = time.perf_counter()
    for _ in range(runs):
        out = dec(x)
    jax.block_until_ready(out)
    sustained_ms = (time.perf_counter() - t0) / runs * 1e3

    trace_dir = args.trace_dir or tempfile.mkdtemp(prefix="stage_trace_")
    jax.profiler.start_trace(trace_dir)
    for _ in range(args.iters):
        out = dec(x)
    jax.block_until_ready(out)
    jax.profiler.stop_trace()
    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True))
    red = reduce_trace(files[-1], args.iters, op_names)

    res = {"platform": dev.platform, "device_kind": dev.device_kind,
           "device_count": len(jax.devices()), "frames": cfg.pid_max,
           "capture": list(cap.shape), "compile_first_run_s": compile_s,
           "sustained_ms": sustained_ms, "sustained_runs": runs,
           "symbol_errors": errs, "traced_iters": args.iters, **red}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
    res.pop("sample_ops")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
