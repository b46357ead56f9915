"""Every extract_payload impl must implement the same function: the
reference windowcf's read-zeros slice semantics (framing.cc:284, 639-651)
for ANY start — negative, interior, overrunning, or fully outside.  The
compiled-on-device equality + timing gate is ``bench.py --check``; this is
the semantic gate on the virtual-device CPU mesh."""

import jax.numpy as jnp
import numpy as np
import pytest

from rub_mimo_tpu.pipeline.rx import extract_payload


def _ref(iq, cstart, plen):
    S, T = iq.shape
    out = np.zeros((S, plen), iq.dtype)
    for j in range(plen):
        p = cstart + j
        if 0 <= p < T:
            out[:, j] = np.asarray(iq)[:, p]
    return out


@pytest.mark.parametrize("impl", ["xla", "xla_pad", "xla_slow"])
@pytest.mark.parametrize(
    "cstart",
    [0, 5, 1000, 3000 - 500, 3000 - 1, -1, -499, -500, -5000, 3000, 9000],
)
def test_windowcf_semantics(impl, cstart):
    rng = np.random.default_rng(3)
    T, plen = 3000, 500
    iq = (rng.standard_normal((2, T))
          + 1j * rng.standard_normal((2, T))).astype(np.complex64)
    got = extract_payload(
        jnp.asarray(iq), jnp.int32(cstart), plen, impl=impl
    )
    np.testing.assert_array_equal(np.asarray(got), _ref(iq, cstart, plen))


@pytest.mark.parametrize("impl", ["xla", "xla_pad", "xla_slow"])
def test_capture_shorter_than_payload(impl):
    rng = np.random.default_rng(4)
    T, plen = 300, 500
    iq = (rng.standard_normal((2, T))
          + 1j * rng.standard_normal((2, T))).astype(np.complex64)
    for cstart in (-100, 0, 100, 299, 400):
        got = extract_payload(
            jnp.asarray(iq), jnp.int32(cstart), plen, impl=impl
        )
        np.testing.assert_array_equal(
            np.asarray(got), _ref(iq, cstart, plen), err_msg=f"{cstart=}"
        )
