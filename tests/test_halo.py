"""The sharded decoder's halo exchange (a ppermute between neighbouring
'time' shards) against a numpy shift, and the sharded decode against the
plain one, on the virtual CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P

from rub_mimo_tpu.config import tiny_config
from rub_mimo_tpu.io import simulator
from rub_mimo_tpu.parallel import decode_sharded, mesh as mesh_mod
from rub_mimo_tpu.pipeline import rx


@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (8, 1), (4, 2)])
def test_halo_from_left_matches_roll(shape):
    """Shard j receives the last H samples of shard j-1; shard 0 gets
    zeros — the blockwise np.roll of the capture, first block zeroed."""
    n_time, n_sc = shape
    mesh = mesh_mod.make_mesh(n_time, n_sc)
    S, L, H = 2, 160, 129
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((S, n_time * L))
         + 1j * rng.standard_normal((S, n_time * L))).astype(np.complex64)

    spec = P(None, "time")
    got = jax.jit(jax.shard_map(
        lambda local: decode_sharded.halo_from_left(local, H, n_time),
        mesh=mesh, in_specs=spec, out_specs=spec,
    ))(jnp.asarray(x))

    blocks = x.reshape(S, n_time, L)
    tails = np.roll(blocks[:, :, -H:], 1, axis=1)
    tails[:, 0] = 0
    np.testing.assert_array_equal(np.asarray(got),
                                  tails.reshape(S, n_time * H))


@pytest.mark.parametrize("n_time,n_sc", [(2, 1), (4, 2)])
def test_sharded_decode_matches_plain(n_time, n_sc):
    """Sync election and demodulated symbols of the sharded decode are
    bit-equal to the single-device decode."""
    cfg = tiny_config(bit_exact=False)
    spec = simulator.ChannelSpec(snr_db=35.0, delay=501, seed=11)
    cap, tx_data, _ = simulator.simulate_capture(cfg, spec)
    ref = rx.decode(cap, cfg)
    assert bool(ref.synced)

    m = mesh_mod.make_mesh(n_time, n_sc)
    iq = mesh_mod.shard_capture(cap, m)
    got = decode_sharded.build_sharded_decoder(cfg, m, iq.shape[-1])(iq)
    assert int(got.sync_index) == int(ref.sync_index)
    assert int(got.decode_start) == int(ref.decode_start)
    np.testing.assert_array_equal(np.asarray(got.rx_data),
                                  np.asarray(ref.rx_data))
