"""Benchmark: end-to-end 2x2 MIMO-OFDM capture decode throughput.

Measures the full RX pipeline (Schmidl&Cox sync + matched filter + LS
channel estimation + ZF detection + demod) at the reference's operating
point: M=2048 subcarriers, CP=152, 2 streams, 20 access codes, 1000
payload frames, 32-ary modem (mimo/config.h:65-66,92,104-108) — a
~4.6M-IQ-sample capture, decoded as one jit-compiled program.

Methodology:
  - the headline value is SUSTAINED wall time: N decodes queued
    back-to-back, one block_until_ready at the end, divided by N.  The
    per-iteration wall times (block_until_ready after each decode) are
    reported beside it.  Per-stage device time from a profiler trace is
    benchmarks/stage_times.py's job.
  - every line names the platform, device kind and device count it ran
    on; a number from the CPU is never a device number.
  - every run scores the decode against the ground-truth tx symbols and
    reports SER in the JSON line; a run whose scoring fails exits
    non-zero — a perf number from a wrong decode is worthless.

Baseline: the reference runs this radio at 1.0 Msps per channel
(mimo/config.h:56), i.e. 2.0e6 IQ samples/s aggregate is the real-time bar
its (serial, per-sample, offline) decoder must meet to keep up with the
air interface.  vs_baseline = achieved samples/s / 2.0e6.

Prints one JSON line:
  {"metric", "value", "unit", "vs_baseline", "method", "sustained_ms", "wall_median_ms", "wall_best_ms", "ser_percent",
   "platform", "device_kind", "device_count"}
"""

import argparse
import json
import statistics
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=1,
                    help="decode N captures per device program (the scan "
                         "serving decoder, rx.make_serving_decoder)")
    ap.add_argument("--iters", type=int, default=15,
                    help="timed repetitions; median is reported (best-of is "
                         "recorded separately)")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--check", action="store_true",
                    help="instead of the throughput bench: run every "
                         "backend-dispatched impl (window grab, sync impl, "
                         "matched-filter method) inside the full decode "
                         "compiled on the device, assert "
                         "equality, and write per-impl timings to "
                         "rub_mimo_tpu/data/impl_timings.json — the table "
                         "the 'auto' dispatches consult")
    ap.add_argument("--check-retry", action="store_true",
                    help="with --check: re-attempt impls whose previous "
                         "run is recorded as a compile/runtime error "
                         "(skipped by default)")
    args = ap.parse_args()

    import jax

    from rub_mimo_tpu.utils import compile_cache

    compile_cache.enable()

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    if args.check:
        from rub_mimo_tpu.utils import impl_check

        results = impl_check.run_check(frames=args.frames,
                                       iters=args.iters,
                                       verbose=args.verbose,
                                       retry_failed=args.check_retry)
        print(json.dumps(results), flush=True)
        return

    import jax.numpy as jnp
    import numpy as np

    from rub_mimo_tpu.config import ModemConfig
    from rub_mimo_tpu.io import simulator
    from rub_mimo_tpu.pipeline import report, rx

    cfg = ModemConfig(pid_max=args.frames, bit_exact=False)
    spec = simulator.ChannelSpec(snr_db=30.0, delay=5000, seed=42)
    if args.verbose:
        print(f"devices: {jax.devices()}", file=sys.stderr)
        print("generating capture...", file=sys.stderr)
    capture, tx_data, _ = simulator.simulate_capture(cfg, spec)
    capture = jax.device_put(jnp.asarray(capture))
    S, T = capture.shape

    # the capture is fed as f32 planes (what every ingest path
    # produces); the split is done once, untimed
    re1, im1 = jax.jit(lambda c: (jnp.real(c).astype(jnp.float32),
                                  jnp.imag(c).astype(jnp.float32)))(capture)
    if args.batch > 1:
        # scan-based serving decoder: N captures per device program
        bdec = rx.make_serving_decoder(cfg, input_format="planes")
        capture_in = (
            jnp.broadcast_to(re1, (args.batch, S, T)) + 0.0,
            jnp.broadcast_to(im1, (args.batch, S, T)) + 0.0,
        )
        dec = lambda x: bdec(*x)  # noqa: E731
    else:
        dec0 = rx.make_decoder(cfg, input_format="planes")
        capture_in = (re1, im1)
        dec = lambda p: dec0(*p)  # noqa: E731
    if args.verbose:
        print(f"capture: {S} x {T} IQ samples x{args.batch}; compiling...",
              file=sys.stderr)
    t0 = time.perf_counter()
    result = dec(capture_in)
    jax.block_until_ready(result.rx_data)
    compile_s = time.perf_counter() - t0

    # ---- timed iterations, one barrier each ----
    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        result = dec(capture_in)
        jax.block_until_ready(result.rx_data)
        times.append(time.perf_counter() - t0)

    # ---- sustained throughput: queue N dispatches, block once ----
    sustain_n = max(args.iters, 30)
    t0 = time.perf_counter()
    for _ in range(sustain_n):
        last = dec(capture_in)
    jax.block_until_ready(last.rx_data)
    sustained_ms = (time.perf_counter() - t0) / sustain_n * 1e3

    wall_median = statistics.median(times)
    wall_best = min(times)
    sps = S * T * args.batch / (sustained_ms / 1e3)

    # ---- correctness: every bench run scores the decode ----
    rxd = np.asarray(result.rx_data)
    if args.batch > 1:
        rxd = rxd[0]
    n = cfg.pid_max * cfg.M_occupied
    errs = int((rxd[:, :n] != np.asarray(tx_data)[:, :n]).sum())
    ser_percent = 100.0 * errs / (cfg.num_streams * n)

    baseline_sps = 2.0e6  # 2 channels x 1.0 Msps (mimo/config.h:56)
    line = {
        "metric": "mimo2x2_decode_throughput",
        "value": round(sps, 1),
        "unit": "IQ samples/s/chip",
        "vs_baseline": round(sps / baseline_sps, 3),
        "method": "sustained_wall",
        "sustained_ms": round(sustained_ms, 4),
        "wall_median_ms": round(wall_median * 1e3, 3),
        "wall_best_ms": round(wall_best * 1e3, 3),
        "ser_percent": ser_percent,
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "device_count": len(jax.devices()),
    }
    print(json.dumps(line), flush=True)

    if args.verbose:
        print(f"compile+first run: {compile_s:.2f}s", file=sys.stderr)
        print(f"times: {[f'{t*1000:.1f}ms' for t in times]}", file=sys.stderr)
        if args.batch == 1:
            report.score(result, tx_data, cfg, decode_seconds=wall_median,
                         num_samples=T).print()
    if ser_percent != 0.0:
        print(f"decode scored SER {ser_percent}% (expected 0)",
              file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
