"""True multi-process (multi-"host") sharded decode demo.

Launches N processes, each exposing K virtual CPU devices, joined with
jax.distributed into one 2K-device runtime; the time-sharded decode then
spans BOTH processes — the same program shape as a multi-host mesh
(SURVEY §4's multi-host test recipe).

Run directly:   python benchmarks/multihost_demo.py
(or import run_worker from a test harness.)
"""

from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PORT = 29817
N_PROC = 2
DEV_PER_PROC = 2


def run_worker(process_id: int, num_processes: int = N_PROC,
               dev_per_proc: int = DEV_PER_PROC, port: int = PORT) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", dev_per_proc)
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=num_processes,
        process_id=process_id,
    )
    import numpy as np

    from rub_mimo_tpu.config import tiny_config
    from rub_mimo_tpu.io import simulator
    from rub_mimo_tpu.parallel import decode_sharded, mesh as mesh_mod
    from rub_mimo_tpu.pipeline import rx

    n_total = num_processes * dev_per_proc
    assert len(jax.devices()) == n_total, jax.devices()

    cfg = tiny_config(bit_exact=False)
    spec = simulator.ChannelSpec(snr_db=35.0, delay=501, seed=11)
    cap, tx_data, _ = simulator.simulate_capture(cfg, spec)

    mesh = mesh_mod.make_mesh(n_total, 1)
    iq = mesh_mod.shard_capture(cap, mesh)
    dec = decode_sharded.build_sharded_decoder(cfg, mesh, iq.shape[-1])
    got = dec(iq)
    jax.block_until_ready(got.rx_data)

    # compare against the local single-device decode (fully addressable)
    ref = rx.decode(cap, cfg)
    ok_sync = int(np.asarray(got.sync_index.addressable_data(0))) == int(
        np.asarray(ref.sync_index)
    )
    rx_got = np.asarray(got.rx_data.addressable_data(0))
    rx_ref = np.asarray(ref.rx_data)
    ok_data = bool((rx_got == rx_ref).all())
    print(
        f"[proc {process_id}] devices={n_total} sync_ok={ok_sync} "
        f"data_ok={ok_data}",
        flush=True,
    )
    return 0 if (ok_sync and ok_data) else 1


def main() -> int:
    if os.environ.get("MH_WORKER"):
        return run_worker(int(os.environ["MH_WORKER_ID"]))
    procs = []
    for i in range(N_PROC):
        env = dict(os.environ)
        env["MH_WORKER"] = "1"
        env["MH_WORKER_ID"] = str(i)
        env.pop("JAX_PLATFORMS", None)
        procs.append(
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__)], env=env
            )
        )
    rc = 0
    for p in procs:
        rc |= p.wait(timeout=600)
    print("multihost demo:", "OK" if rc == 0 else "FAILED")
    return rc


if __name__ == "__main__":
    sys.exit(main())
