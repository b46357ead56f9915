"""BER/SER vs SNR sanity: the end-to-end chain must track AWGN theory.

Config 1's acceptance criterion (BASELINE: "check BER ~ theory"): run the
1x1 SISO loopback across SNRs and verify (a) monotonic improvement,
(b) the QPSK symbol error rate lands within a small factor of the AWGN
theory value at moderate SNR, (c) high SNR is error-free.
"""

import math

import numpy as np
import pytest

from rub_mimo_tpu.config import CommMode, ModemConfig, Modulation
from rub_mimo_tpu.io import simulator
from rub_mimo_tpu.pipeline import report, rx


def _qfunc(x):
    return 0.5 * math.erfc(x / math.sqrt(2.0))


def _run_siso(snr_db, pid_max=64, seed=5):
    cfg = ModemConfig(
        num_subcarriers=64,
        cp_len=16,
        num_streams=1,
        num_access_codes=4,
        pid_max=pid_max,
        modulation=Modulation.QPSK,
        mode=CommMode.SISO,
        siso_tx=0,
        siso_rx=0,
        bit_exact=False,
        # the reference's 0.95 threshold only syncs above ~16 dB SNR
        # (metric peak = (SNR/(1+SNR))^2); it is a runtime option here
        plateau_threshold=0.5,
    )
    spec = simulator.ChannelSpec(
        snr_db=snr_db, delay=333, seed=seed, identity=True
    )
    cap, tx_data, _ = simulator.simulate_capture(cfg, spec)
    result = rx.decode(cap, cfg)
    rep = report.score(result, tx_data, cfg)
    assert rep.synced, f"no sync at {snr_db} dB"
    return rep.symbol_error_rate[0] / 100.0


@pytest.mark.slow
def test_ser_monotonic_and_tracks_theory():
    snrs = [8.0, 11.0, 14.0]
    sers = [_run_siso(s) for s in snrs]
    # monotone improvement with SNR
    assert sers[0] > sers[1] > sers[2] >= 0.0
    # QPSK over AWGN: SER = 2Q(sqrt(Es/N0)) - Q(...)^2.  The simulator sets
    # N0 against mean TX power; CP overhead and estimation noise shift the
    # operating point slightly, so allow a generous factor.
    for snr, ser in zip(snrs[:2], sers[:2]):
        esn0 = 10.0 ** (snr / 10.0)
        q = _qfunc(math.sqrt(esn0))
        theory = 2 * q - q * q
        assert theory / 6 < ser < theory * 6, (
            f"SNR {snr}: SER {ser:.4g} vs theory {theory:.4g}"
        )


def test_high_snr_error_free():
    assert _run_siso(30.0) == 0.0


# ---------------------------------------------------------------------
# Golden curves: the pinned quantitative accuracy of the DSP chain.
# tests/ber_points.py defines the grid;
# scripts/gen_ber_golden.py regenerates the JSON after intentional
# accuracy changes.
# ---------------------------------------------------------------------

import json
from pathlib import Path

from tests.ber_points import GRID, measure_point

_GOLDEN_PATH = Path(__file__).parent / "golden" / "ber_curves.json"


def _golden():
    assert _GOLDEN_PATH.exists(), (
        "missing golden BER curves — run scripts/gen_ber_golden.py"
    )
    return json.loads(_GOLDEN_PATH.read_text())


@pytest.mark.slow
@pytest.mark.parametrize("key", sorted(GRID))
def test_ber_curve_matches_golden(key):
    golden = _golden()[key]
    for snr in GRID[key]["snrs"]:
        want = golden[str(snr)]
        got = measure_point(key, snr)
        tol = max(0.35 * want, 0.004)
        assert abs(got - want) <= tol, (
            f"{key} @ {snr} dB: SER {got:.5f} vs golden {want:.5f} "
            f"(tol {tol:.5f})"
        )
