"""Device mesh setup for the sharded decode pipeline.

The reference has no distributed layer at all (its "comm stack" is one
pthread mutex + two condvars, mimo/main.cc:84-90).  This design shards the
modem over a 2-axis mesh:

  'time' — time-blocks of the capture (the SP/CP analog; SURVEY §2.6): the
           S&C metric and payload symbol decode are data-parallel in time
           with overlap-save halos at shard boundaries.
  'sc'   — subcarriers (the "model dim"): per-subcarrier MIMO solves and
           equalization batch-shard over the 2048-carrier axis.

The mesh follows the algorithm: the devices of one host are all joined
to each other at the same rate, so any layout of the two axes works.
Multi-process: call init_distributed() before building the mesh.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(
    coordinator_address: str, num_processes: int, process_id: int
) -> None:
    """Multi-process bring-up: jax.distributed.initialize with the
    coordinator address (``host:port``), process count and this
    process's id.  Call once per process before building the mesh;
    jax.devices() then spans all processes."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(
    num_time: Optional[int] = None,
    num_sc: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ('time', 'sc') mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    if num_time is None:
        num_time = len(devices) // num_sc
    need = num_time * num_sc
    if need > len(devices):
        raise ValueError(
            f"mesh {num_time}x{num_sc} needs {need} devices, have {len(devices)}"
        )
    devices = devices[:need]
    return jax.make_mesh((num_time, num_sc), ("time", "sc"),
                         devices=np.asarray(devices))


def shard_capture(iq: jax.Array, mesh: Mesh) -> jax.Array:
    """Place a [streams, T] capture with the time axis sharded.

    Pads T up to a multiple of n_time * 128 (zeros — trailing silence is
    harmless to the decode) so every shard is equal-sized AND every
    shard length is a multiple of any coarse-sync stride (powers of two
    up to 128, sync/schmidl_cox._coarse_stride), keeping the sharded
    stage-A fast path eligible on every mesh size.
    """
    import jax.numpy as jnp

    n_time = mesh.shape["time"]
    T = iq.shape[-1]
    pad = (-T) % (n_time * 128)
    if pad:
        iq = jnp.pad(iq, ((0, 0), (0, pad)))
    return jax.device_put(iq, NamedSharding(mesh, P(None, "time")))


def shard_capture_planes(iq: jax.Array, mesh: Mesh):
    """shard_capture, delivering (re, im) float32 planes (what every
    ingest path produces) for build_sharded_decoder(input_format=
    "planes")."""
    import jax.numpy as jnp

    n_time = mesh.shape["time"]
    T = iq.shape[-1]
    pad = (-T) % (n_time * 128)
    sh = NamedSharding(mesh, P(None, "time"))

    @jax.jit
    def split(c):
        if pad:
            c = jnp.pad(c, ((0, 0), (0, pad)))
        return (jnp.real(c).astype(jnp.float32),
                jnp.imag(c).astype(jnp.float32))

    re, im = split(iq)
    return jax.device_put(re, sh), jax.device_put(im, sh)
