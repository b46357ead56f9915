"""Device capability benchmark: timed, SER-gated decode of the
non-flagship configurations — bit-exact mode at the FULL reference
operating point, the 4x4 wideband preset, and the FEC / ML / SFO
capability rows — on JAX's default device.

bench.py times the flagship robust-mode 2x2; the capability matrix
(benchmarks/capability_matrix.py) checks correctness at small dims.
This bridges the two: full-size decodes of the reference-quirk
(bit_exact=True: identity-biased Ghat, per-code timing argmax,
framing.cc:302-319) and 4x4 configurations, each measured as sustained
wall time (queued dispatches, one block_until_ready) and gated on its
symbol error rate.

  python benchmarks/capability_bench.py [--frames N] [--iters K] [--cpu]

Prints one JSON line per configuration, each naming its platform.
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
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--only", type=str, default=None,
                    help="run a single named config")
    args = ap.parse_args()

    import jax

    from rub_mimo_tpu.utils import compile_cache

    compile_cache.enable()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np

    from rub_mimo_tpu.io import simulator
    from rub_mimo_tpu.models import presets
    from rub_mimo_tpu.pipeline import rx
    dev = jax.devices()[0]
    where = {"platform": dev.platform, "device_kind": dev.device_kind,
             "device_count": len(jax.devices())}

    configs = ["mimo_2x2_reference", "mimo_4x4_wideband"]
    extra = ["fec_2x2_conv_k7", "ml_2x2_arb32", "sfo_2x2_100ppm"]
    if args.only:
        configs = [args.only] if args.only not in extra else []
        extra = [args.only] if args.only in extra else []
    rc = 0

    # ---- full-size FEC / ML / SFO capability rows: the three
    # headline capability claims, each timed + error-gated at
    # the reference operating point ----
    from rub_mimo_tpu.config import Detector, ModemConfig

    for name in extra:
        if name == "fec_2x2_conv_k7":
            # rate-1/2 K=7 convolutional payload over the full 2x2 run;
            # gate on CODED BER after Viterbi
            from rub_mimo_tpu.ofdm import fec

            cfg = ModemConfig(pid_max=args.frames, bit_exact=False)
            spec = simulator.ChannelSpec(snr_db=30.0, delay=5000, seed=42)
            msg, txd = fec.encode_payload(cfg, seed=1)
            capture, tx_data, _ = simulator.simulate_capture(
                cfg, spec, tx_data=txd, payload_seed=1)
            capture = jax.device_put(jnp.asarray(capture))
            S, T = capture.shape
            dec = rx.make_decoder(cfg)
            vit = jax.jit(lambda sig: fec.decode_payload(sig, cfg))

            def step():
                r = dec(capture)
                return vit(r.rx_sig)

            t0 = time.perf_counter()
            bits = step()
            jax.block_until_ready(bits)
            compile_s = time.perf_counter() - t0
            n_iter = max(args.iters, 10)
            t0 = time.perf_counter()
            for _ in range(n_iter):
                bits = step()
            jax.block_until_ready(bits)
            sustained_ms = (time.perf_counter() - t0) / n_iter * 1e3
            dec_bits = np.asarray(bits)
            cber = float((dec_bits != np.asarray(msg)).mean())
            line = {
                "metric": "capability_fec_2x2_conv_k7",
                "value": round(S * T / (sustained_ms / 1e3), 1),
                "unit": "IQ samples/s/chip (sustained, decode+viterbi)",
                "sustained_ms": round(sustained_ms, 4),
                "compile_s": round(compile_s, 1),
                "samples": int(T),
                "info_bits": int(np.asarray(msg).size),
                "coded_ber": cber,
            }
            print(json.dumps({**line, **where}), flush=True)
            if cber > 0.0:
                rc = 1
        elif name == "ml_2x2_arb32":
            # joint max-likelihood lattice detector, 32-ary 2x2 (1024
            # hypotheses per subcarrier), full run
            cfg = ModemConfig(pid_max=args.frames, bit_exact=False,
                              detector=Detector.ML)
            spec = simulator.ChannelSpec(snr_db=30.0, delay=5000, seed=42)
            capture, tx_data, _ = simulator.simulate_capture(cfg, spec)
            capture = jax.device_put(jnp.asarray(capture))
            S, T = capture.shape
            dec = rx.make_decoder(cfg)
            t0 = time.perf_counter()
            result = dec(capture)
            jax.block_until_ready(result.rx_data)
            compile_s = time.perf_counter() - t0
            n_iter = max(args.iters, 10)
            t0 = time.perf_counter()
            for _ in range(n_iter):
                last = dec(capture)
            jax.block_until_ready(last.rx_data)
            sustained_ms = (time.perf_counter() - t0) / n_iter * 1e3
            n = cfg.pid_max * cfg.M_occupied
            rxd = np.asarray(result.rx_data)
            errs = int((rxd[:, :n] != np.asarray(tx_data)[:, :n]).sum())
            ser = 100.0 * errs / (cfg.num_streams * n)
            line = {
                "metric": "capability_ml_2x2_arb32",
                "value": round(S * T / (sustained_ms / 1e3), 1),
                "unit": "IQ samples/s/chip (sustained)",
                "sustained_ms": round(sustained_ms, 4),
                "compile_s": round(compile_s, 1),
                "samples": int(T),
                "symbols": cfg.num_streams * n,
                "ser_percent": round(ser, 4),
            }
            print(json.dumps({**line, **where}), flush=True)
            if ser > 0.5:
                rc = 1
        elif name == "sfo_2x2_100ppm":
            # 100 ppm sampling-frequency offset over the full capture:
            # two-pass estimate+resample+decode (estimate.sfo); wall-
            # clock timed (the flow host-syncs between passes)
            import dataclasses as _dc

            from rub_mimo_tpu.estimate import sfo as sfo_mod

            cfg = ModemConfig(pid_max=args.frames, bit_exact=False)
            spec = simulator.ChannelSpec(snr_db=30.0, delay=5000, seed=42,
                                         sfo_ppm=100.0)
            capture, tx_data, _ = simulator.simulate_capture(cfg, spec)
            capture = jax.device_put(jnp.asarray(capture))
            S, T = capture.shape
            t0 = time.perf_counter()
            result, delta, _ = sfo_mod.decode_with_sfo(capture, cfg)
            jax.block_until_ready(result.rx_data)
            compile_s = time.perf_counter() - t0
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                result, delta, _ = sfo_mod.decode_with_sfo(capture, cfg)
                jax.block_until_ready(result.rx_data)
                walls.append(time.perf_counter() - t0)
            wall_ms = sorted(walls)[len(walls) // 2] * 1e3
            n = cfg.pid_max * cfg.M_occupied
            rxd = np.asarray(result.rx_data)
            errs = int((rxd[:, :n] != np.asarray(tx_data)[:, :n]).sum())
            ser = 100.0 * errs / (cfg.num_streams * n)
            line = {
                "metric": "capability_sfo_2x2_100ppm",
                "value": round(S * T / (wall_ms / 1e3), 1),
                "unit": "IQ samples/s/chip (wall, 2-pass est+resample)",
                "wall_ms": round(wall_ms, 3),
                "compile_s": round(compile_s, 1),
                "samples": int(T),
                "sfo_ppm_true": 100.0,
                "sfo_ppm_hat": round(float(np.asarray(delta)) * 1e6, 3),
                "ser_percent": round(ser, 4),
            }
            print(json.dumps({**line, **where}), flush=True)
            if ser > 0.5:
                rc = 1

    for name in configs:
        cfg, spec = presets.get(name, pid_max=args.frames)
        capture, tx_data, _ = simulator.simulate_capture(cfg, spec)
        capture = jax.device_put(jnp.asarray(capture))
        S, T = capture.shape
        dec = rx.make_decoder(cfg)

        t0 = time.perf_counter()
        result = dec(capture)
        jax.block_until_ready(result.rx_data)
        compile_s = time.perf_counter() - t0

        n_iter = max(args.iters, 10)
        t0 = time.perf_counter()
        for _ in range(n_iter):
            last = dec(capture)
        jax.block_until_ready(last.rx_data)
        sustained_ms = (time.perf_counter() - t0) / n_iter * 1e3

        n = cfg.pid_max * cfg.M_occupied
        rxd = np.asarray(result.rx_data)
        errs = int((rxd[:, :n] != np.asarray(tx_data)[:, :n]).sum())
        ser = 100.0 * errs / (cfg.num_streams * n)
        sps = S * T / (sustained_ms / 1e3)
        line = {
            "metric": f"capability_{name}",
            "value": round(sps, 1),
            "unit": "IQ samples/s/chip (sustained)",
            "sustained_ms": round(sustained_ms, 4),
            "compile_s": round(compile_s, 1),
            "streams": S,
            "samples": int(T),
            "symbols": cfg.num_streams * n,
            "ser_percent": round(ser, 4),
            "bit_exact": cfg.bit_exact,
            "synced": bool(np.asarray(result.synced)),
        }
        print(json.dumps({**line, **where}), flush=True)
        if ser > 0.5 or not line["synced"]:
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
