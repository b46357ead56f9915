"""Smoke test of the decode pipeline on one GPU, at the reference operating
point (``ModemConfig()`` defaults: M=2048, CP=152, 2x2, 20 access codes,
1000 payload frames, 32-ary; a 2 x 2,297,248-sample complex64 capture).

  python chip_smoke.py            # one GPU: phases 0-7
  python chip_smoke.py --chips 4  # four GPUs: the sharded paths only

Phases of the default run:

  0. device check: JAX's first device must be a GPU; prints the card's
     name and power limit (nvidia-smi).
  1. the main path through the CLI (``cli run``, bit-exact defaults):
     synced and SER 0.
  2. robust decode (bit_exact=False) on the GPU vs the same jitted decode
     on the host CPU: decisions exactly equal, G / rx_sig close, SER 0.
  3. the scan serving decoder on a batch of 4 captures: decisions equal
     the single-capture GPU decodes, and those equal the host-CPU decode
     of each capture.
  4. the streaming decoder on the phase-2 capture: decisions equal the
     offline decode's.
  5. the recorded golden capture through ``cli decode``: decisions and
     channel estimate equal the checked-in expectations.
  6. numbers: first and warm (disk cache) compile seconds, warm decode
     time, peak device memory.
  7. the ``gpu``-marked tests, in this process.

Every phase raises on failure; the script then exits non-zero and prints
no result.  The last stdout line is the JSON result object.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "chiprun_out", "chip_smoke")

# G / rx_sig tolerance, GPU vs CPU: max |delta| <= 1e-4 * RMS of the CPU
# value.  Both run the same float32 program (every decision-feeding dot
# at Precision.HIGHEST); what differs is the FFT library (cuFFT vs the
# CPU FFT) and so the summation order, which moves float32 results by a
# few ulps per butterfly stage (~1e-6 relative after 11 radix-2 stages).
REL_TOL = 1e-4
DELAY = 5000  # samples of silence before the burst


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """nvidia-smi's name + power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def close(got, ref, what: str) -> float:
    import numpy as np

    got = np.asarray(got)
    ref = np.asarray(ref)
    check(got.shape == ref.shape, f"{what}: shape {got.shape} != {ref.shape}")
    rms = float(np.sqrt(np.mean(np.abs(ref.astype(np.complex128)) ** 2)))
    err = float(np.max(np.abs(got.astype(np.complex128)
                              - ref.astype(np.complex128))))
    check(err <= REL_TOL * rms,
          f"{what}: max|delta| {err:.3e} > {REL_TOL} * rms {rms:.3e}")
    return err / rms


def ser_percent(rx_data, tx_data, cfg) -> float:
    import numpy as np

    n = cfg.pid_max * cfg.M_occupied
    errs = int((np.asarray(rx_data)[:, :n]
                != np.asarray(tx_data)[:, :n]).sum())
    return 100.0 * errs / (cfg.num_streams * n)


def decisions(r):
    """The fields that must match exactly between two decodes."""
    import numpy as np

    return {k: np.asarray(getattr(r, k))
            for k in ("rx_data", "sync_index", "decode_start")}


def gpu_vs_cpu(dec, cap, gpu, cpu, what: str):
    """Decode one capture on the GPU and on the host CPU with the same
    jitted decoder; the decisions (and the access code) must be equal."""
    import jax
    import numpy as np

    r_gpu = jax.block_until_ready(dec(jax.device_put(cap, gpu)))
    r_cpu = jax.block_until_ready(dec(jax.device_put(cap, cpu)))
    check(bool(r_gpu.synced) and bool(r_cpu.synced), f"{what}: not synced")
    same_decisions(decisions(r_gpu), decisions(r_cpu), what)
    check(np.array_equal(np.asarray(r_gpu.ac_index),
                         np.asarray(r_cpu.ac_index)),
          f"{what}: ac_index differs")
    return r_gpu, r_cpu


def same_decisions(a: dict, b: dict, what: str) -> None:
    import numpy as np

    for k in a:
        check(np.array_equal(a[k], b[k]), f"{what}: {k} differs")


def run_cli(argv) -> dict:
    """apps.cli.main in this process; returns its last JSON report."""
    from rub_mimo_tpu.apps import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    check(rc in (0, None), f"cli {argv[0]} returned {rc}")
    text = buf.getvalue()
    start = text.rfind("\n{")
    return json.loads(text[start + 1 if start >= 0 else text.index("{"):])


def simulate(cfg, seed: int, delay: int):
    import numpy as np

    from rub_mimo_tpu.io import simulator

    spec = simulator.ChannelSpec(snr_db=30.0, delay=delay, seed=seed)
    cap, tx, _ = simulator.simulate_capture(cfg, spec, payload_seed=seed)
    return np.asarray(cap), np.asarray(tx)


def phase_cli_run() -> None:
    rep = run_cli(["run", "--json", "--snr", "30", "--bit-exact"])
    check(rep["synced"], "cli run: not synced")
    check(max(rep["symbol_error_rate"]) == 0.0,
          f"cli run: SER {rep['symbol_error_rate']}")
    log(f"phase 1 cli run (bit-exact): synced, SER "
        f"{rep['symbol_error_rate']}")


def phase_gpu_vs_cpu(cfg, cap, tx, gpu, cpu):
    import jax

    from rub_mimo_tpu.pipeline import rx

    dec = rx.make_decoder(cfg)
    t0 = time.perf_counter()
    jax.block_until_ready(dec(jax.device_put(cap, gpu)))
    cold_s = time.perf_counter() - t0
    r_gpu, r_cpu = gpu_vs_cpu(dec, cap, gpu, cpu, "gpu vs cpu")
    g_rel = close(r_gpu.G, r_cpu.G, "G")
    s_rel = close(r_gpu.rx_sig, r_cpu.rx_sig, "rx_sig")
    ser = ser_percent(r_gpu.rx_data, tx, cfg)
    check(ser == 0.0, f"gpu decode SER {ser}")
    log(f"phase 2 gpu vs cpu: rx_data/sync_index/ac_index/decode_start "
        f"equal; max|dG|/rms {g_rel:.3e}, max|d rx_sig|/rms {s_rel:.3e} "
        f"(limit {REL_TOL}); SER 0")
    return dec, r_gpu, cold_s


def phase_serving(cfg, dec, cap, tx, r0, gpu, cpu, delay: int) -> None:
    import jax
    import numpy as np

    from rub_mimo_tpu.pipeline import rx

    caps, txs = [cap], [tx]
    for seed in (7, 11, 19):  # same delay: one capture length
        c, t = simulate(cfg, seed, delay)
        caps.append(c)
        txs.append(t)
    serve = rx.make_serving_decoder(cfg)
    rs = serve(jax.device_put(np.stack(caps), gpu))
    sers = []
    for i, (c, t) in enumerate(zip(caps, txs)):
        single = r0 if i == 0 else gpu_vs_cpu(
            dec, c, gpu, cpu, f"capture {i} gpu vs cpu")[0]
        got = {k: v[i] for k, v in decisions(rs).items()}
        same_decisions(got, decisions(single), f"serving capture {i}")
        sers.append(ser_percent(got["rx_data"], t, cfg))
    check(sers[0] == 0.0, "serving capture 0: SER not 0")
    # seeds 7, 11, 19 draw other random channels at 30 dB; a channel
    # that leaves symbol errors leaves the same ones on the host CPU
    log(f"phase 3 serving (scan, batch 4): decisions equal the single "
        f"GPU decodes, which equal the host-CPU decodes (seeds 42, 7, 11, "
        f"19); SER % per capture {sers}")


def phase_streaming(cfg, cap, r0) -> None:
    import numpy as np

    from rub_mimo_tpu.pipeline import streaming

    sdec = streaming.decode_stream(cap, cfg, chunk_size=1 << 20)
    sdec.finalize()
    check(sdec.synced, "streaming: not synced")
    check(sdec.sync_index == int(r0.sync_index), "streaming: sync_index")
    _, rx_data = sdec.result()
    check(np.array_equal(rx_data, np.asarray(r0.rx_data)),
          "streaming: rx_data differs from the offline decode")
    log("phase 4 streaming (chunk 2^20): sync_index and rx_data equal "
        "the offline decode")


def phase_golden() -> None:
    import numpy as np

    from rub_mimo_tpu.io import capture as capio

    golden = os.path.join(REPO, "tests", "golden")
    cfg = capio.CaptureManifest.load(
        os.path.join(golden, "manifest.json")).config
    os.makedirs(OUT, exist_ok=True)
    cfg_path = os.path.join(OUT, "golden_config.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    log_dir = os.path.join(OUT, "golden_decode")
    rep = run_cli(["decode", golden, "--tx-data", golden, "--config",
                   cfg_path, "--json", "--log-dir", log_dir])
    check(rep["synced"] and max(rep["symbol_error_rate"]) == 0.0,
          f"golden: synced {rep['synced']} SER {rep['symbol_error_rate']}")
    rx_data = np.stack([
        capio.read_data(os.path.join(log_dir, f"rx_data{s + 1}.dat"))
        for s in range(cfg.num_streams)]).astype(np.int32)
    check(np.array_equal(
        rx_data, np.load(os.path.join(golden, "expected_rx_data.npy"))),
        "golden: rx_data differs from expected_rx_data.npy")
    # the channel estimate, from the same decoder the CLI runs
    import jax.numpy as jnp

    from rub_mimo_tpu.pipeline import rx

    cap = capio.read_capture(golden, cfg.num_streams)
    G = np.asarray(rx.make_decoder(cfg)(jnp.asarray(cap)).G)
    np.testing.assert_allclose(
        G, np.load(os.path.join(golden, "expected_G.npy")),
        rtol=1e-4, atol=1e-6)
    log("phase 5 golden capture (cli decode): rx_data equal, G within "
        "rtol 1e-4 / atol 1e-6, SER 0")


def phase_numbers(cfg, cap, gpu, cold_s, card) -> dict:
    import jax

    from rub_mimo_tpu.pipeline import rx

    x = jax.device_put(cap, gpu)
    # in-memory caches only: the next compile reads the disk cache
    jax.clear_caches()
    dec = rx.make_decoder(cfg)
    t0 = time.perf_counter()
    jax.block_until_ready(dec(x))
    warm_s = time.perf_counter() - t0
    n = 20
    t0 = time.perf_counter()
    for _ in range(n):
        out = dec(x)
    jax.block_until_ready(out)
    decode_ms = (time.perf_counter() - t0) / n * 1e3
    peak = gpu.memory_stats().get("peak_bytes_in_use")
    nums = {"compile_cold_s": cold_s, "compile_warm_s": warm_s,
            "decode_ms": decode_ms, "runs": n, "peak_bytes_in_use": peak,
            "card": card}
    log(f"phase 6 numbers ({card}): first compile+run {cold_s:.3f} s, "
        f"warm (disk cache) compile+first run {warm_s:.3f} s, warm decode "
        f"{decode_ms:.4f} ms (mean of {n}, block_until_ready), "
        f"peak_bytes_in_use {peak}")
    return nums


def phase_gpu_tests() -> None:
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:xdist",
                      "-p", "no:cacheprovider", "-p", "no:randomly",
                      "--rootdir", REPO,
                      os.path.join(REPO, "tests", "test_gpu.py")])
    check(rc == 0, f"gpu-marked tests failed (pytest exit {rc})")
    log("phase 7 gpu-marked tests: passed")


def phase_four_chips(cfg, cap, tx, devs) -> None:
    import jax
    import numpy as np

    from rub_mimo_tpu.parallel import decode_sharded, mesh as mesh_mod
    from rub_mimo_tpu.parallel import serving
    from rub_mimo_tpu.pipeline import rx

    check(len(devs) >= 4, f"--chips 4 needs 4 GPUs, found {len(devs)}")
    ref = rx.make_decoder(cfg)(jax.device_put(cap, devs[0]))
    check(ser_percent(ref.rx_data, tx, cfg) == 0.0, "single-card SER")
    for n_time, n_sc in ((4, 1), (2, 2)):
        mesh = mesh_mod.make_mesh(n_time, n_sc, devices=devs[:4])
        iq = mesh_mod.shard_capture(cap, mesh)
        placed = {s.device for s in iq.addressable_shards}
        check(len(placed) == 4, f"capture shards on {len(placed)} devices")
        dec = decode_sharded.build_sharded_decoder(cfg, mesh, iq.shape[-1])
        got = dec(iq)
        check(bool(got.synced), f"{n_time}x{n_sc}: not synced")
        for k in ("rx_data", "sync_index", "decode_start"):
            check(np.array_equal(np.asarray(getattr(got, k)),
                                 np.asarray(getattr(ref, k))),
                  f"sharded {n_time}x{n_sc}: {k} differs")
        rel = close(got.rx_sig, ref.rx_sig,
                    f"sharded {n_time}x{n_sc} rx_sig")
        log(f"--chips 4: sharded decode on a {n_time}x{n_sc} ('time','sc') "
            f"mesh over {len(placed)} devices: decisions equal the "
            f"single-card decode; max|d rx_sig|/rms {rel:.3e}")
    mesh1 = mesh_mod.make_mesh(4, 1, devices=devs[:4])
    batch = serving.shard_batch(np.stack([cap] * 4), mesh1)
    placed = {s.device for s in batch.addressable_shards}
    check(len(placed) == 4, f"batch shards on {len(placed)} devices")
    rs = serving.make_sharded_batch_decoder(cfg, mesh1)(batch)
    out_devs = {s.device for s in rs.rx_data.addressable_shards}
    check(len(out_devs) == 4, f"batch output on {len(out_devs)} devices")
    rx_data, sync_index = np.asarray(rs.rx_data), np.asarray(rs.sync_index)
    for i in range(4):
        check(np.array_equal(rx_data[i], np.asarray(ref.rx_data)),
              f"sharded batch capture {i}: rx_data differs")
        check(int(sync_index[i]) == int(ref.sync_index),
              f"sharded batch capture {i}: sync_index differs")
    log("--chips 4: sharded batch decoder (batch 4 over 4 devices): "
        "decisions equal the single-card decode")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the multi-GPU sharded paths")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform}",
              file=sys.stderr)
        return 1
    card = card_line()
    log(card)
    log(f"phase 0 device: {devs[0].platform} {devs[0].device_kind} x "
        f"{len(devs)}; jax {jax.__version__}")

    from rub_mimo_tpu.config import ModemConfig
    from rub_mimo_tpu.utils import compile_cache

    cache = compile_cache.enable()
    entries = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    log(f"compile cache: {cache} ({entries} entries at start; the first "
        f"compile below is cold only when there were none)")
    t_start = time.perf_counter()
    cfg = ModemConfig(bit_exact=False)
    cap, tx = simulate(cfg, seed=42, delay=DELAY)
    log(f"capture {cap.shape} {cap.dtype} ({cap.nbytes / 1e6:.1f} MB)")

    if args.chips == 4:
        phase_four_chips(cfg, cap, tx, devs)
    else:
        gpu, cpu = devs[0], jax.devices("cpu")[0]
        phase_cli_run()
        dec, r0, cold_s = phase_gpu_vs_cpu(cfg, cap, tx, gpu, cpu)
        phase_serving(cfg, dec, cap, tx, r0, gpu, cpu, DELAY)
        phase_streaming(cfg, cap, r0)
        phase_golden()
        nums = phase_numbers(cfg, cap, gpu, cold_s, card)
        phase_gpu_tests()
        os.makedirs(OUT, exist_ok=True)
        with open(os.path.join(OUT, "numbers.json"), "w") as f:
            json.dump(nums, f, indent=2)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    # count: the cards this run used (1, or the 4 of the mesh)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": args.chips}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
