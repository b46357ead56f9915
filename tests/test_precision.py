"""Every floating-point dot that feeds a decision runs at
Precision.HIGHEST, so a GPU never takes a reduced-precision (TF32 / bf16)
pass over it.  Checked on the traced jaxprs, sub-jaxprs included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.extend import core as jcore

from rub_mimo_tpu.config import Detector, tiny_config
from rub_mimo_tpu.io import simulator
from rub_mimo_tpu.ofdm import fec, framegen
from rub_mimo_tpu.pipeline import rx

_HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)


def _sub_jaxprs(eqn):
    for v in eqn.params.values():
        for x in (v if isinstance(v, (tuple, list)) else (v,)):
            if isinstance(x, jcore.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jcore.Jaxpr):
                yield x


def _float_dots(jaxpr):
    for e in jaxpr.eqns:
        if e.primitive.name == "dot_general" and jnp.issubdtype(
                e.invars[0].aval.dtype, jnp.inexact):
            yield e
        for j in _sub_jaxprs(e):
            yield from _float_dots(j)


def _assert_highest(closed):
    dots = list(_float_dots(closed.jaxpr))
    assert dots, "expected at least one floating-point dot_general"
    bad = [str(e)[:200] for e in dots if e.params["precision"] != _HIGHEST]
    assert not bad, bad


@pytest.fixture(scope="module")
def capture():
    cfg = tiny_config(bit_exact=False)
    cap, _, _ = simulator.simulate_capture(
        cfg, simulator.ChannelSpec(snr_db=30.0, delay=300, seed=1))
    return cap


@pytest.mark.parametrize(
    "detector", [Detector.ZF, Detector.MMSE, Detector.ML, Detector.SIC])
def test_decode_dots_are_highest(capture, detector):
    """rx.decode on every sync path a device may take (coarse, its
    indicator-matmul variant, the full scan)."""
    cfg = tiny_config(bit_exact=False, detector=detector)
    for impl in ("coarse", "coarse128", "xla"):
        _assert_highest(jax.make_jaxpr(
            lambda x: rx.decode(x, cfg, sync_impl=impl))(capture))


def test_soft_viterbi_dots_are_highest():
    cfg = tiny_config(bit_exact=False)
    sig = jnp.zeros((cfg.num_streams, cfg.pid_max * cfg.M_occupied),
                    jnp.complex64)
    _assert_highest(jax.make_jaxpr(
        lambda s: fec.decode_payload(s, cfg))(sig))


def test_tx_dots_are_highest():
    """The simulated channel and the precoded framing, so GPU and CPU
    generate the same capture."""
    cfg = tiny_config(bit_exact=False)
    tx_data = framegen.generate_payload_symbols(cfg, seed=0)
    P = jnp.asarray(np.tile(np.eye(2, dtype=np.complex64),
                            (cfg.M_occupied, 1, 1)))
    _assert_highest(jax.make_jaxpr(
        lambda d: framegen.transmit_frame(cfg, d, precoder=P))(tx_data))
    tx = framegen.transmit_frame(cfg, jnp.asarray(tx_data))
    for spec in (simulator.ChannelSpec(seed=1),
                 simulator.ChannelSpec(seed=1, drift_rate=1e-5),
                 simulator.ChannelSpec(seed=1, flat=False, num_taps=3)):
        h = simulator.draw_channel(spec, 2, 2)
        _assert_highest(jax.make_jaxpr(
            lambda t: simulator.apply_channel(t, jnp.asarray(h), spec, cfg)
        )(tx))
