"""Long-capture stress benchmark: a frame buried 8M samples deep in a
2 x 16M-sample (256 MB) capture — the 'long context' scaling story.
Prints the best-of-3 decode time, the sync index and the symbol errors
per stream, with the device they ran on.

  python benchmarks/longcap.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rub_mimo_tpu.config import ModemConfig
    from rub_mimo_tpu.io import simulator
    from rub_mimo_tpu.pipeline import rx
    from rub_mimo_tpu.utils import compile_cache

    compile_cache.enable()
    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind}")

    # 2 x 16M-sample capture with the frame buried deep (delay 8M)
    cfg = ModemConfig(pid_max=1000, bit_exact=False)
    spec = simulator.ChannelSpec(snr_db=30.0, delay=8_000_000,
                                 trailing=16_000_000 - 8_000_000
                                 - (41 * 2200 + 1000 * 2200) - 4096,
                                 seed=42)
    t0 = time.time()
    cap, txd, _ = simulator.simulate_capture(cfg, spec)
    cap = jax.device_put(jnp.asarray(cap))
    jax.block_until_ready(cap)
    print(f"capture {cap.shape} gen {time.time()-t0:.1f}s "
          f"({cap.shape[0]*cap.shape[1]*8/1e6:.0f} MB)")
    dec = rx.make_decoder(cfg)
    t0 = time.time()
    r = dec(cap)
    jax.block_until_ready(r.rx_data)
    print(f"compile+run {time.time()-t0:.1f}s")
    best = 1e9
    for _ in range(3):
        t0 = time.time()
        r = dec(cap)
        jax.block_until_ready(r.rx_data)
        best = min(best, time.time() - t0)
    S, T = cap.shape
    print(f"long decode: {best*1e3:.2f} ms -> {S*T/best:.3e} IQ samples/s")
    print(f"sync_index {int(r.sync_index)} (expect ~8.0M+)")
    n = cfg.pid_max * cfg.M_occupied
    errs = (np.asarray(r.rx_data)[:, :n] != np.asarray(txd)[:, :n]).sum(axis=1)
    print(f"errors/stream: {errs.tolist()} of {n}")


if __name__ == "__main__":
    main()
