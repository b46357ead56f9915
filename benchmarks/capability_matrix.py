"""Device capability matrix: run each advertised capability end-to-end
through the CLI and record one JSON row per capability.

The CPU test suite proves correctness of every mode; this script proves
each mode also COMPILES AND RUNS on JAX's default device — small dims
where compile cost demands, the reference's config.h variants and
PARITY rows 16/20/24-26 as the row set.

Each row is one CLI subprocess, run one at a time, and this parent never
imports JAX onto the device: one JAX process holds the card at a time.

Usage:  python benchmarks/capability_matrix.py [--out FILE] [--cpu]
Writes one JSON object per line; summary table printed at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# Each row: (name, parity/config citation, CLI args).  Dims are kept
# small enough that the whole matrix runs in minutes but large enough to
# exercise the real code paths.
SMALL = ["--num_subcarriers", "256", "--cp_len", "32",
         "--num_access_codes", "6", "--frames", "32"]
ROWS = [
    ("2x2_zf_full_size", "reference default build (config.h:65-66,92)",
     ["--frames", "200"]),
    ("bit_exact_mode", "PARITY #8/#12 (identity-biased Ghat, per-code timing)",
     SMALL + ["--bit-exact"]),
    ("4x4_mimo", "N>2 generalization (reference hardcodes 2x2, framing.cc:1346)",
     SMALL + ["--num_streams", "4", "--modulation", "qam16"]),
    ("guard_band_pilots", "PARITY #16 (compiled-out allocator, framing.cc:956-997)",
     SMALL + ["--mode", "rx_zf", "--config", "__GUARD__"]),
    ("fec_conv_k7", "new capability: conv K=7 + soft Viterbi",
     SMALL + ["--fec", "conv_k7", "--snr", "14", "--modulation", "qpsk",
              "--sync-fallback"]),
    ("ml_detector", "new capability: joint ML lattice detection",
     SMALL + ["--detector", "ml", "--modulation", "qpsk", "--snr", "12",
              "--sync-fallback"]),
    ("mmse_detector", "detector=MMSE (reference: ZF only)",
     SMALL + ["--detector", "mmse"]),
    ("sfo_correction", "PARITY #24-26 class: +100ppm SFO estimated+corrected",
     SMALL + ["--sfo-ppm", "100", "--sfo-correct", "--frames", "64",
              "--modulation", "qpsk"]),
    ("cfo_correction", "reference FIXME framing.cc:486: CFO corrected",
     SMALL + ["--cfo", "0.21", "--correct-cfo"]),
    ("siso_mode", "SISO path (config.h:89-91, framing.cc:508-533)",
     SMALL + ["--mode", "siso"]),
    ("alamouti_stbc", "mode enum types.h:21-26 (implemented, ref stub)",
     SMALL + ["--mode", "alamouti", "--modulation", "qpsk"]),
    ("tx_beamforming", "empty namespace framing.h:216 -> working closed loop",
     SMALL + ["--precoded", "--mode", "rx_zf"]),
]


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def guard_config(tmpdir: str) -> str:
    """Write a config JSON enabling the pilot/guard-band allocator."""
    from rub_mimo_tpu.config import ModemConfig

    cfg = ModemConfig(num_subcarriers=256, cp_len=32, num_access_codes=6,
                      pid_max=32, use_all_carriers=False)
    path = os.path.join(tmpdir, "guard.json")
    with open(path, "w") as f:
        f.write(cfg.to_json())
    return path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--timeout", type=int, default=900)
    args = ap.parse_args()

    import tempfile

    tmpdir = tempfile.mkdtemp(prefix="capmat_")
    rows = []
    for name, cite, cli in ROWS:
        cli = [guard_config(tmpdir) if a == "__GUARD__" else a for a in cli]
        cmd = [sys.executable, "-m", "rub_mimo_tpu.apps.cli", "run",
               "--json", *cli]
        if args.cpu:
            cmd.append("--cpu")
        t0 = time.time()
        try:
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=args.timeout, cwd=REPO)
            wall = time.time() - t0
            # the CLI prints one or more indented multi-line JSON
            # reports (--precoded prints baseline + precoded): take the
            # LAST parseable object
            line = None
            b = p.stdout.rfind("}")
            starts = [i for i, c in enumerate(p.stdout[: b + 1])
                      if c == "{"]
            for a in starts:
                try:
                    line = json.loads(p.stdout[a: b + 1])
                    break
                except ValueError:
                    continue
            if line is None:
                row = {"capability": name, "ok": False, "wall_s": round(wall, 1),
                       "error": (p.stderr or p.stdout)[-300:]}
            else:
                sers = line.get("symbol_error_rate") or []
                row = {
                    "capability": name,
                    "cite": cite,
                    "ok": bool(line.get("synced", False))
                    and all(s < 1.0 for s in sers),
                    "synced": line.get("synced"),
                    "ser_percent": [round(s, 4) for s in sers],
                    "wall_s": round(wall, 1),
                }
                for k in ("coded_ber", "bit_error_rate", "evm_percent"):
                    if line.get(k) is not None:
                        row[k] = line[k]
        except subprocess.TimeoutExpired:
            row = {"capability": name, "ok": False,
                   "error": f"timeout {args.timeout}s"}
        except Exception as e:
            row = {"capability": name, "ok": False, "error": str(e)[:300]}
        rows.append(row)
        print(json.dumps(row), flush=True)

    out = {"backend": "cpu" if args.cpu
           else os.environ.get("JAX_PLATFORMS") or "default", "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
    ok = sum(1 for r in rows if r.get("ok"))
    print(f"# {ok}/{len(rows)} capabilities ok", file=sys.stderr)
    return 0 if ok == len(rows) else 1


if __name__ == "__main__":
    sys.exit(main())
