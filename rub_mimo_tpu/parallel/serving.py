"""Multi-chip batched serving: shard a BATCH of captures over the mesh.

parallel.decode_sharded accelerates ONE capture by sharding its time
axis; this module is the orthogonal serving axis — many independent
captures decoded concurrently, one (or more) per chip, the throughput
configuration for production replay farms.  Pure data parallelism: the
per-capture decode is the ordinary pipeline.rx program, the batch axis is
laid over the mesh with jax.sharding, and XLA inserts zero collectives
(captures are independent), so scaling is embarrassingly linear.

Every capture runs the full dynamic pipeline (own sync point, own CSI) —
this is NOT a fixed-offset fast path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rub_mimo_tpu.config import ModemConfig


def make_sharded_batch_decoder(cfg: ModemConfig, mesh: Mesh,
                               axis: str = "time"):
    """jit a [batch, streams, T] -> batched DecodeResult program with the
    batch axis sharded over `axis` of the mesh.  batch must be a multiple
    of the axis size (pad with copies or zeros upstream)."""
    from rub_mimo_tpu.pipeline import rx as rx_mod

    sharding = NamedSharding(mesh, P(axis, None, None))

    @functools.partial(jax.jit, in_shardings=(sharding,))
    def _decode_batch(iq_batch):
        # window_impl="xla_slow" alongside sync_impl="coarse_full":
        # vmapping the lax.cond fast paths turns them into
        # both-branches selects — the
        # non-cond formulations are the right ones under a batch axis
        # (same reason make_batch_decoder forces both, pipeline/rx.py)
        return jax.vmap(
            lambda iq: rx_mod.decode(iq, cfg, sync_impl="coarse_full",
                                     window_impl="xla_slow",
                                     cpstrip_impl="xla")
        )(iq_batch)

    return _decode_batch


def shard_batch(iq_batch, mesh: Mesh, axis: str = "time"):
    """Place a [batch, streams, T] stack with the batch axis sharded."""
    n = mesh.shape[axis]
    if iq_batch.shape[0] % n:
        raise ValueError(
            f"batch {iq_batch.shape[0]} must be a multiple of the "
            f"'{axis}' axis size {n}"
        )
    return jax.device_put(
        jnp.asarray(iq_batch), NamedSharding(mesh, P(axis, None, None))
    )
