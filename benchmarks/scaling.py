"""Scaling-efficiency benchmark: sharded decode throughput vs mesh size.

Measures the time-sharded decode (parallel.decode_sharded) at 1, 2, ... N
devices and reports samples/s + efficiency vs the single-device run.  On
several GPUs this produces the real number; without them it can still
exercise the collective program on the virtual CPU mesh (--cpu N).

Usage:
  python benchmarks/scaling.py                # real devices
  python benchmarks/scaling.py --cpu 8        # virtual 8-CPU mesh
  python benchmarks/scaling.py --frames 1000  # full-size capture
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
    ap.add_argument("--cpu", type=int, default=0,
                    help="force N virtual CPU devices")
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--overhead", action="store_true",
                    help="single-device sharding-overhead mode: run the "
                         "shard_map sharded decoder on a 1-device mesh "
                         "vs the plain pipeline.rx decode, sustained "
                         "timing — the one scaling-relevant number a "
                         "single device can produce (partitioning + "
                         "collective-insertion cost)")
    args = ap.parse_args()

    if args.cpu:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.cpu}"
        ).strip()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from rub_mimo_tpu.utils import compile_cache

    compile_cache.enable()
    from rub_mimo_tpu.config import ModemConfig
    from rub_mimo_tpu.io import simulator
    from rub_mimo_tpu.parallel import decode_sharded, mesh as mesh_mod

    n_dev = len(jax.devices())
    cfg = ModemConfig(pid_max=args.frames, bit_exact=False)
    spec = simulator.ChannelSpec(snr_db=30.0, delay=5000, seed=42)
    cap, _, _ = simulator.simulate_capture(cfg, spec)
    cap = jnp.asarray(cap)
    S, T = cap.shape

    if args.overhead:
        import numpy as np

        from rub_mimo_tpu.pipeline import rx

        def sustained(fn, arg, n=30):
            jax.block_until_ready(fn(arg).rx_data)
            t0 = time.perf_counter()
            for _ in range(n):
                out = fn(arg)
            jax.block_until_ready(out.rx_data)
            return (time.perf_counter() - t0) / n * 1e3

        # both programs fed f32 planes (the ingest-native format): the
        # comparison isolates partitioning/collective cost, not input
        # staging differences
        plain0 = rx.make_decoder(cfg, input_format="planes")
        planes = jax.jit(lambda c: (jnp.real(c).astype(jnp.float32),
                                    jnp.imag(c).astype(jnp.float32)))(cap)
        plain_ms = sustained(lambda p: plain0(*p), planes)

        mesh = mesh_mod.make_mesh(1, 1)
        iqp = mesh_mod.shard_capture_planes(cap, mesh)
        sharded0 = decode_sharded.build_sharded_decoder(
            cfg, mesh, iqp[0].shape[-1], input_format="planes")
        shard_ms = sustained(lambda p: sharded0(*p), iqp)

        # evidence check: the two programs' decisions must agree
        n_cmp = cfg.pid_max * cfg.M_occupied
        d_plain = np.asarray(plain0(*planes).rx_data)[:, :n_cmp]
        d_shard = np.asarray(sharded0(*iqp).rx_data)[:, :n_cmp]
        mismatches = int((d_plain != d_shard).sum())

        print(json.dumps({
            "metric": "sharding_overhead_1dev",
            "plain_sustained_ms": round(plain_ms, 4),
            "sharded_sustained_ms": round(shard_ms, 4),
            "overhead_ms": round(shard_ms - plain_ms, 4),
            "overhead_percent": round(
                100 * (shard_ms - plain_ms) / plain_ms, 2),
            "decision_mismatches": mismatches,
            "frames": cfg.pid_max,
            "capture": [int(S), int(T)],
            "platform": jax.devices()[0].platform,
            "device_kind": jax.devices()[0].device_kind,
            "note": "shard_map(1x1 mesh) decode vs plain jit decode on "
                    "the same device: the cost of partitioning + halo/"
                    "election collective insertion at degenerate size",
        }))
        return 0

    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_dev]
    results = {}
    base_sps = None
    for n in sizes:
        mesh = mesh_mod.make_mesh(n, 1)
        iq = mesh_mod.shard_capture(cap, mesh)
        dec = decode_sharded.build_sharded_decoder(cfg, mesh, iq.shape[-1])
        out = dec(iq)
        jax.block_until_ready(out.rx_data)
        best = float("inf")
        for _ in range(args.iters):
            t0 = time.perf_counter()
            out = dec(iq)
            jax.block_until_ready(out.rx_data)
            best = min(best, time.perf_counter() - t0)
        sps = S * T / best
        if base_sps is None:
            base_sps = sps
        eff = sps / (base_sps * n)
        results[n] = {"seconds": best, "samples_per_second": sps,
                      "efficiency_vs_linear": eff}
        if not args.json:
            print(f"  n={n:<3d} {best * 1e3:9.3f} ms   {sps:.3e} samples/s"
                  f"   eff {eff * 100:6.1f}%")
    if args.json:
        print(json.dumps({"devices": n_dev, "capture": [S, T],
                          "platform": jax.devices()[0].platform,
                          "device_kind": jax.devices()[0].device_kind,
                          "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
