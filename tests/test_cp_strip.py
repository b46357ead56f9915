"""pipeline.rx.strip_cp: every CP-strip implementation must be
bit-identical to the plain numpy reshape+slice (it is a pure copy).
The compiled-on-device equality + timing gate that lets an impl win the
"auto" dispatch is ``bench.py --check`` (utils.impl_check)."""

import jax.numpy as jnp
import numpy as np
import pytest

from rub_mimo_tpu.pipeline.rx import strip_cp


def _ref(payload, n_sym, sym, cp):
    S = payload.shape[0]
    return np.asarray(payload)[:, : n_sym * sym].reshape(
        S, n_sym, sym
    )[:, :, cp:]


@pytest.mark.parametrize("impl", ["xla", "xla128"])
@pytest.mark.parametrize(
    "S,n_sym,sym,cp",
    [
        (2, 16, 2200, 152),   # reference shape ratios, 8 | 16
        (2, 13, 2200, 152),   # n_sym not a multiple of 8
        (1, 5, 300, 44),      # odd little shapes
        (4, 8, 512, 128),
    ],
)
def test_matches_reshape_complex(S, n_sym, sym, cp, impl):
    rng = np.random.default_rng(0)
    pay = (rng.standard_normal((S, n_sym * sym))
           + 1j * rng.standard_normal((S, n_sym * sym))).astype(np.complex64)
    got = strip_cp(jnp.asarray(pay), n_sym, sym, cp, impl=impl)
    np.testing.assert_array_equal(np.asarray(got), _ref(pay, n_sym, sym, cp))


@pytest.mark.parametrize("impl", ["xla", "xla128"])
def test_matches_reshape_float_and_long_payload(impl):
    rng = np.random.default_rng(1)
    n_sym, sym, cp = 7, 450, 50
    # payload longer than n_sym*sym: the excess must be ignored
    pay = rng.standard_normal((2, n_sym * sym + 301)).astype(np.float32)
    got = strip_cp(jnp.asarray(pay), n_sym, sym, cp, impl=impl)
    np.testing.assert_array_equal(np.asarray(got), _ref(pay, n_sym, sym, cp))


def test_strip_cp_dispatch_equivalence():
    """pipeline.rx.strip_cp: every impl name returns the same array."""
    rng = np.random.default_rng(2)
    n_sym, sym, cp = 9, 352, 64
    pay = (rng.standard_normal((2, n_sym * sym))
           + 1j * rng.standard_normal((2, n_sym * sym))).astype(np.complex64)
    ref = strip_cp(jnp.asarray(pay), n_sym, sym, cp, impl="xla")
    np.testing.assert_array_equal(np.asarray(ref), _ref(pay, n_sym, sym, cp))
    for impl in ("auto", "xla128"):
        got = strip_cp(jnp.asarray(pay), n_sym, sym, cp, impl=impl)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref),
                                      err_msg=impl)


@pytest.mark.parametrize(
    "S,n_sym,sym,cp",
    [
        (2, 16, 2200, 152),  # reference ratios: G=8, n_sym % G == 0
        (2, 13, 2200, 152),  # n_sym not a multiple of the supergroup
        (2, 10, 2048, 512),  # pitch already a tile multiple: G=1
        (1, 5, 300, 44),     # odd little shapes
    ],
)
def test_xla128_matches(S, n_sym, sym, cp):
    rng = np.random.default_rng(5)
    pay = (rng.standard_normal((S, n_sym * sym))
           + 1j * rng.standard_normal((S, n_sym * sym))).astype(np.complex64)
    got = strip_cp(jnp.asarray(pay), n_sym, sym, cp, impl="xla128")
    np.testing.assert_array_equal(np.asarray(got), _ref(pay, n_sym, sym, cp))
