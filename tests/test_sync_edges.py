"""Adversarial edge tests for the coarse sync path.

The coarse+refine scan (sync/schmidl_cox._synchronize_coarse) and its
prefix early-exit wrapper carry several lax.cond fallbacks that normal
captures never exercise:

  - a fire landing inside the prefix margin band (re-derived by the
    full-capture scan),
  - more candidate pairs than the K=4 refine budget, all refining to
    no-fire, with the true burst later (need_full fallback),
  - a burst so late its coarse pair falls off the grid (tail guard),
  - plateau metric hovering at the threshold.

Each test builds a FULL-GEOMETRY (M=2048, CP=152) capture crafting the
edge and asserts the coarse result equals the chunked full scan
(impl="xla") field for field.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from rub_mimo_tpu.config import ModemConfig
from rub_mimo_tpu.sync import schmidl_cox


CFG = ModemConfig(pid_max=4, bit_exact=False)  # M=2048, cp=152
M = CFG.M
CP = CFG.cp_len
D = schmidl_cox._coarse_stride(CFG)  # 64 at this geometry


def _noise(rng, S, T, scale=0.05):
    return (scale * (rng.normal(size=(S, T)) + 1j * rng.normal(size=(S, T)))
            ).astype(np.complex64)


def _periodic(rng, S, span, amp=1.0):
    """M/2-periodic random burst: S&C metric ~1 once the window fills."""
    base = (rng.normal(size=(S, M // 2)) + 1j * rng.normal(size=(S, M // 2)))
    reps = -(-span // (M // 2))
    return (amp * np.tile(base, (1, reps))[:, :span]).astype(np.complex64)


def _assert_equal(x, atol_cfo=1e-5):
    a = schmidl_cox.synchronize(jnp.asarray(x), CFG, impl="coarse")
    b = schmidl_cox.synchronize(jnp.asarray(x), CFG, impl="xla")
    assert bool(a.synced) == bool(b.synced)
    if bool(b.synced):
        assert int(a.sync_sample) == int(b.sync_sample)
        assert int(a.sync_index) == int(b.sync_index)
        np.testing.assert_array_equal(np.asarray(a.plateau_start),
                                      np.asarray(b.plateau_start))
        np.testing.assert_allclose(float(a.cfo_hat), float(b.cfo_hat),
                                   atol=atol_cfo)
    return a


def _place(x, burst, at):
    x[:, at:at + burst.shape[-1]] += burst
    return x


@pytest.mark.slow
def test_fire_inside_prefix_margin():
    """Fire lands in [Tpre - margin, Tpre): the prefix result must be
    discarded and re-derived by the full-capture coarse scan."""
    rng = np.random.default_rng(0)
    S = CFG.num_streams
    margin = 2 * M + 2 * CP
    Tpre = max(1 << 18, 8 * margin)
    T = Tpre + 6 * margin
    x = _noise(rng, S, T)
    # plateau onset ~M after burst start; aim the FIRE at Tpre - margin/2
    at = Tpre - margin // 2 - (M + CP)
    _place(x, _periodic(rng, S, 3 * M), at)
    r = _assert_equal(x)
    assert bool(r.synced)
    assert abs(int(r.sync_sample) - (Tpre - margin // 2)) < M


@pytest.mark.slow
def test_burst_in_tail_guard():
    """Burst so late that its coarse pair falls past the aligned grid:
    only the tail-guard exact scan can find it."""
    rng = np.random.default_rng(1)
    S = CFG.num_streams
    T = 1 << 16
    x = _noise(rng, S, T)
    # plateau must complete (cp+2 run) inside [T - 2D - cp, T)
    span = M + CP + 2 * D + 40
    at = T - span - 4
    _place(x, _periodic(rng, S, span), at)
    a = schmidl_cox._synchronize_coarse(jnp.asarray(x), CFG, 1 << 15)
    b = schmidl_cox.synchronize(jnp.asarray(x), CFG, impl="xla")
    assert bool(a.synced) == bool(b.synced)
    if bool(b.synced):
        assert int(a.sync_sample) == int(b.sync_sample)
        assert int(b.sync_sample) >= T - 2 * D - CP


@pytest.mark.slow
def test_many_false_candidates_then_burst():
    """> K=4 candidate pairs that all refine to no-fire, real burst
    after them: the need_full fallback must run the full scan."""
    rng = np.random.default_rng(2)
    S = CFG.num_streams
    T = 1 << 17
    # each blip must give an above-run long enough to GUARANTEE two
    # consecutive D-aligned coarse points (>= 2D+1 = 129) but shorter
    # than the cp+2 = 154 fire requirement.  The run onset leads the
    # filled correlator window (partial periodicity already exceeds the
    # threshold in low noise), so calibrate the span empirically.
    blip_full = _periodic(rng, S, M + 256)
    blip_span = None
    for s in range(M + 16, M + 96, 4):
        probe = _noise(np.random.default_rng(99), S, 3 * M + s)
        probe[:, M:M + s] += blip_full[:, :s]
        m = np.asarray(schmidl_cox.sc_metric(
            jnp.asarray(probe), M, block=1 << 15)[0])
        above = np.all(m > CFG.plateau_threshold, axis=0)
        run = 0
        best = 0
        for v in above:
            run = run + 1 if v else 0
            best = max(best, run)
        if 130 <= best <= 150:
            blip_span = s
            break
    assert blip_span is not None, "no span gives a pair-but-no-fire run"
    x = _noise(rng, S, T)
    for i in range(6):
        _place(x, blip_full[:, :blip_span], 4000 + i * 6000)
    real_at = 60000
    _place(x, _periodic(rng, S, 3 * M), real_at)

    # sanity: the blips alone must NOT fire (either impl)
    blips_only = np.array(x[:, :real_at - M])
    rb = schmidl_cox.synchronize(jnp.asarray(blips_only), CFG, impl="xla")
    assert not bool(rb.synced)
    # ...but they must produce >= K candidate pairs at the coarse points
    metric, _ = schmidl_cox.sc_metric(jnp.asarray(blips_only), M,
                                      block=1 << 15)
    mnp = np.asarray(metric)
    tis = np.arange(D - 1, mnp.shape[-1], D)
    above = np.all(mnp[:, tis] > CFG.plateau_threshold, axis=0)
    pairs = int(np.sum(above[:-1] & above[1:]))
    assert pairs > 4, f"craft failed: only {pairs} candidate pairs"

    r = _assert_equal(x)
    assert bool(r.synced)
    assert abs(int(r.sync_sample) - (real_at + M + CP)) < M


@pytest.mark.slow
def test_threshold_hover():
    """Plateau metric hovering near the 0.95 threshold: > vs >= and
    float-boundary behaviour must match the full scan.  Sweep the burst
    amplitude through the acquisition edge."""
    rng = np.random.default_rng(3)
    S = CFG.num_streams
    T = 1 << 16
    synced_count = 0
    # metric plateau ~ (Ps/(Ps+Pn))^2 with Pn = 2*0.1^2: amp 0.62 puts
    # it right AT the 0.95 threshold; the sweep crosses the edge
    for amp in (0.40, 0.55, 0.62, 0.70, 1.0):
        x = _noise(rng, S, T, scale=0.1)
        _place(x, _periodic(rng, S, 3 * M, amp=amp), 9000)
        r = _assert_equal(x)
        synced_count += int(bool(r.synced))
    # the sweep must actually cross the edge (some sync, some not)
    assert 0 < synced_count < 5


@pytest.mark.slow
def test_no_burst_no_sync():
    rng = np.random.default_rng(4)
    x = _noise(rng, CFG.num_streams, 1 << 16)
    r = _assert_equal(x)
    assert not bool(r.synced)
