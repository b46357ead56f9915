"""The sharded coarse+refine sync stage (decode_sharded._coarse_sync_stage)
must match the offline decode for bursts anywhere in the capture —
including plateaus straddling shard boundaries (the halo / j=-1 boundary
pair paths) — and fall back to the full scan without changing results."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rub_mimo_tpu.config import ModemConfig
from rub_mimo_tpu.io import simulator
from rub_mimo_tpu.parallel import decode_sharded, mesh as mesh_mod
from rub_mimo_tpu.pipeline import rx
from rub_mimo_tpu.sync import schmidl_cox


CFG = ModemConfig(pid_max=6, bit_exact=False)
M = CFG.M


def _run_both(cap, n_time):
    ref = rx.decode(jnp.asarray(cap), CFG)
    mesh = mesh_mod.make_mesh(n_time, 1)
    iq = mesh_mod.shard_capture(jnp.asarray(cap), mesh)
    dec = decode_sharded.build_sharded_decoder(CFG, mesh, iq.shape[-1])
    out = dec(iq)
    return ref, out


@pytest.mark.slow
@pytest.mark.parametrize("delay_frac", [0.05, 0.45, 0.62])
def test_burst_positions_across_shards(delay_frac):
    """Full geometry, burst placed in different shards of a 4-way mesh
    (0.45/0.62 land near the shard-1/2 boundary region)."""
    # capture length ~ preamble + 6 frames ~ 104k samples
    probe_spec = simulator.ChannelSpec(snr_db=30.0, delay=0, seed=3)
    base, _, _ = simulator.simulate_capture(CFG, probe_spec)
    T = base.shape[-1]
    delay = int(T * delay_frac)
    spec = simulator.ChannelSpec(snr_db=30.0, delay=delay, seed=3)
    cap, tx, _ = simulator.simulate_capture(CFG, spec)
    ref, out = _run_both(cap, 4)
    assert bool(ref.synced) and bool(out.synced)
    assert int(out.sync_index) == int(ref.sync_index)
    assert int(out.sync_sample) == int(ref.sync_sample)
    np.testing.assert_array_equal(np.asarray(out.rx_data),
                                  np.asarray(ref.rx_data))


@pytest.mark.slow
def test_burst_straddles_shard_boundary():
    """Pin the PLATEAU onto a shard boundary of a 2-way mesh: the fire
    and/or its run-start window cross shards (halo + boundary pair)."""
    probe_spec = simulator.ChannelSpec(snr_db=30.0, delay=0, seed=5)
    base, _, _ = simulator.simulate_capture(CFG, probe_spec)
    T0 = base.shape[-1]
    npad = -(-T0 // (2 * 128)) * (2 * 128)
    Tloc = npad // 2
    hit = False
    for off in (-CFG.cp_len // 2, -M // 2, -M):
        delay = Tloc + off - (M + CFG.cp_len)
        if delay < 0:
            continue
        spec = simulator.ChannelSpec(snr_db=30.0, delay=delay, seed=5)
        cap, tx, _ = simulator.simulate_capture(CFG, spec)
        ref, out = _run_both(cap, 2)
        if not bool(ref.synced):
            continue
        hit = True
        assert int(out.sync_index) == int(ref.sync_index), f"off {off}"
        np.testing.assert_array_equal(np.asarray(out.rx_data),
                                      np.asarray(ref.rx_data))
    assert hit


def test_shard_smaller_than_halo_takes_full_scan():
    """Regression: shards sized between the old
    coarse_ok threshold and the coarse stage's own left halo silently
    truncated `local[:, -halo:]` and misaligned every ext/global
    coordinate.  Such shard sizes must take the full-rate scan and match
    offline exactly."""
    from rub_mimo_tpu.config import tiny_config
    from jax.sharding import NamedSharding, PartitionSpec as P

    cfg = tiny_config(pid_max=4, bit_exact=False)
    halo = decode_sharded.coarse_left_halo(cfg)          # 240 at tiny dims
    old_gate = (2 * cfg.M + 4 * cfg.cp_len
                + 4 * schmidl_cox._coarse_stride(cfg))   # 224
    D = schmidl_cox._coarse_stride(cfg)
    # a shard size in the bug window [old_gate, halo), D-aligned
    Tloc = ((old_gate + D - 1) // D + 1) * D
    assert old_gate <= Tloc < halo, (Tloc, old_gate, halo)
    n_time = 8
    T = n_time * Tloc

    spec = simulator.ChannelSpec(snr_db=30.0, delay=300, seed=11)
    sim, tx, _ = simulator.simulate_capture(cfg, spec)
    cap = np.zeros((cfg.num_streams, T), np.complex64)
    n = min(sim.shape[-1], T)
    cap[:, :n] = np.asarray(sim)[:, :n]

    ref = rx.decode(jnp.asarray(cap), cfg)
    mesh = mesh_mod.make_mesh(n_time, 1)
    iq = jax.device_put(
        jnp.asarray(cap), NamedSharding(mesh, P(None, "time"))
    )
    dec = decode_sharded.build_sharded_decoder(cfg, mesh, T)
    out = dec(iq)
    assert bool(ref.synced)
    assert bool(out.synced)
    assert int(out.sync_index) == int(ref.sync_index)
    assert int(out.sync_sample) == int(ref.sync_sample)
    np.testing.assert_array_equal(np.asarray(out.rx_data),
                                  np.asarray(ref.rx_data))


def test_fire_past_shard_boundary_matches_offline():
    """Regression: a shard's last local pair
    owns fires in [shard_end, shard_end + cp]; without a right halo the
    refine window clamped and duplicated the last in-shard metric
    sample, fabricating/misplacing boundary fires.  Sweep the burst so
    fires land on both sides of a 2-way boundary and require exact
    agreement with offline."""
    from rub_mimo_tpu.config import tiny_config
    from jax.sharding import NamedSharding, PartitionSpec as P

    cfg = tiny_config(pid_max=4, bit_exact=False)
    T = 4096
    Tloc = T // 2
    assert Tloc >= decode_sharded.coarse_left_halo(cfg)
    mesh = mesh_mod.make_mesh(2, 1)
    dec = decode_sharded.build_sharded_decoder(cfg, mesh, T)

    def run(delay, seed):
        spec = simulator.ChannelSpec(snr_db=30.0, delay=delay, seed=seed)
        sim, tx, _ = simulator.simulate_capture(cfg, spec)
        cap = np.zeros((cfg.num_streams, T), np.complex64)
        n = min(sim.shape[-1], T)
        cap[:, :n] = np.asarray(sim)[:, :n]
        ref = rx.decode(jnp.asarray(cap), cfg)
        iq = jax.device_put(
            jnp.asarray(cap), NamedSharding(mesh, P(None, "time"))
        )
        return ref, dec(iq)

    # probe: locate the fire for a reference delay, then sweep the
    # burst so fires land in [boundary - 2D, boundary + cp]
    D = schmidl_cox._coarse_stride(cfg)
    ref0, _ = run(400, seed=13)
    assert bool(ref0.synced)
    t0 = int(ref0.sync_sample)
    crossed = 0
    checked = 0
    for target in range(Tloc - 2 * D, Tloc + cfg.cp_len, 5):
        delay = 400 + target - t0
        if delay < 0:
            continue
        ref, out = run(delay, seed=13)
        if not bool(ref.synced):
            continue
        checked += 1
        if int(ref.sync_sample) >= Tloc:
            crossed += 1
        assert bool(out.synced), f"target {target}"
        assert int(out.sync_sample) == int(ref.sync_sample), (
            f"target {target}: sharded {int(out.sync_sample)} "
            f"vs offline {int(ref.sync_sample)}"
        )
        assert int(out.sync_index) == int(ref.sync_index), f"target {target}"
        np.testing.assert_array_equal(np.asarray(out.rx_data),
                                      np.asarray(ref.rx_data))
    assert checked >= 5
    # the sweep must actually exercise past-boundary fires
    assert crossed >= 1


@pytest.mark.slow
def test_candidate_overflow_falls_back():
    """> K candidate blips before the real burst: the sharded coarse
    stage must raise need_full and the full-scan fallback must still
    match offline."""
    rng = np.random.default_rng(7)
    S = CFG.num_streams
    spec = simulator.ChannelSpec(snr_db=30.0, delay=60000, seed=7)
    cap, tx, _ = simulator.simulate_capture(CFG, spec)
    cap = np.array(cap)
    blip = (np.tile(rng.normal(size=(S, M // 2))
                    + 1j * rng.normal(size=(S, M // 2)), (1, 5)))
    span = M + 40
    for i in range(6):
        at = 3000 + i * 5500
        cap[:, at:at + span] += blip[:, :span].astype(np.complex64)
    ref, out = _run_both(cap, 4)
    assert bool(out.synced) == bool(ref.synced)
    if bool(ref.synced):
        assert int(out.sync_index) == int(ref.sync_index)
        np.testing.assert_array_equal(np.asarray(out.rx_data),
                                      np.asarray(ref.rx_data))
