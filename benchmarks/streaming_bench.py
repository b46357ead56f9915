"""Online (streaming) decode throughput: chunks arriving one at a time.

Unlike bench.py (one whole-capture program), this measures the chunked
StreamingDecoder — per-chunk host->device transfer + jitted step + state
carry — i.e. the sustained rate a live ingest front end (io.native
SocketReader / StreamReader) could feed.  Reports samples/s over the
full capture and the mean per-chunk latency.

  python benchmarks/streaming_bench.py            # device, full size
  python benchmarks/streaming_bench.py --tiny --cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--chunk", type=int, default=1 << 19)
    ap.add_argument("--block", type=int, default=0, metavar="K",
                    help="feed K chunks per push_block call (batched "
                         "seek: one host round-trip per block instead "
                         "of per chunk); 0 = chunk-at-a-time push")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    from rub_mimo_tpu.utils import compile_cache

    compile_cache.enable()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from rub_mimo_tpu.config import ModemConfig, tiny_config
    from rub_mimo_tpu.io import simulator
    from rub_mimo_tpu.pipeline import streaming

    if args.tiny:
        cfg = tiny_config(bit_exact=False, pid_max=min(args.frames, 64))
        chunk = min(args.chunk, 1 << 12)
    else:
        cfg = ModemConfig(pid_max=args.frames, bit_exact=False)
        chunk = args.chunk
    import jax.numpy as jnp

    spec = simulator.ChannelSpec(snr_db=30.0, delay=5000, seed=42)
    cap, tx_data, _ = simulator.simulate_capture(cfg, spec)
    S, T = cap.shape

    # chunks are sliced ON DEVICE: the capture already lives on the
    # device, so the stream never crosses the host boundary
    n_chunks = -(-T // chunk)
    padded = jax.jit(
        lambda x: jnp.pad(x, ((0, 0), (0, n_chunks * chunk - T)))
    )(cap)
    slicer = jax.jit(
        lambda x, i: jax.lax.dynamic_slice(
            x, (jnp.int32(0), i), (S, chunk))
    )
    K = max(0, args.block)
    bslicer = jax.jit(
        lambda x, i: jax.lax.dynamic_slice(
            x, (jnp.int32(0), i), (S, K * chunk))
    ) if K > 1 else None

    def run_once(per_phase=None):
        dec = streaming.StreamingDecoder(cfg, chunk_size=chunk)
        i = 0
        while i < n_chunks:
            ph = dec.phase
            t0 = time.perf_counter()
            if K > 1 and ph == "seek" and i + K <= n_chunks:
                dec.push_block(bslicer(padded, jnp.int32(i * chunk)))
                n_fed = K
            else:
                dec.push(slicer(padded, jnp.int32(i * chunk)))
                n_fed = 1
            if per_phase is not None:
                per_phase.setdefault(ph, []).append(
                    (time.perf_counter() - t0) / n_fed
                )
            i += n_fed
        dec.finalize()
        return dec

    dec = run_once()   # warm-up: compiles every phase step
    assert dec.synced

    per_phase: dict = {}
    t0 = time.perf_counter()
    dec = run_once(per_phase)
    dt = time.perf_counter() - t0
    assert dec.synced

    _, rx_data = dec.result()
    n = cfg.pid_max * cfg.M_occupied
    errs = int((rx_data[:, :n] != tx_data[:, :n]).sum())
    # per-phase medians quantify the host-sync cost: SEEK pushes block on
    # a fired-scalar fetch each chunk (the phase decision is host-side);
    # PAYLOAD pushes enqueue/dispatch without waiting.
    phase_ms = {
        ph: round(1e3 * sorted(ts)[len(ts) // 2], 3)
        for ph, ts in per_phase.items()
    }
    # per-phase sustained rates: phase rate = chunk / median-per-chunk
    # wall (seek pushes K chunks per host sync with --block)
    phase_sps = {
        ph: round(chunk / sorted(ts)[len(ts) // 2], 1)
        for ph, ts in per_phase.items()
    }
    print(json.dumps({
        "metric": "streaming_decode_throughput",
        "value": round(S * T / dt, 1),
        "unit": "IQ samples/s/chip",
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "chunk": chunk,
        "chunks": n_chunks,
        "block": K,
        "ms_per_chunk": round(dt / n_chunks * 1e3, 3),
        "ms_per_chunk_by_phase": phase_ms,
        "samples_per_s_by_phase": phase_sps,
        "symbol_errors": errs,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
