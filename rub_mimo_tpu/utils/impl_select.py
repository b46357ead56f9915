"""Measurement-driven implementation dispatch.

An "auto" dispatch must never route the decode through an implementation
that was not measured and equality-checked compiled on the device:

  - ``bench.py --check`` runs every backend-dispatched implementation
    COMPILED on the device, asserts output equality, and records
    per-impl decode milliseconds to a committed JSON table
    (``rub_mimo_tpu/data/impl_timings.json``).
  - The ``"auto"`` dispatches (pipeline.rx window grab and CP strip,
    sync.schmidl_cox sync impl) consult the table via :func:`best_impl`
    and pick the fastest impl that PASSED the equality check on this
    backend.  No measurement for this backend -> the safe fallback (the
    plain XLA formulation).

The table is data, not code: regenerating it (one ``bench.py --check``
run on the device) is the only way a non-fallback impl can win an auto
dispatch.  :data:`IMPLS` lists every name each dispatch point accepts;
:func:`check_impl` rejects anything else, so a name that no longer
exists fails loudly instead of falling through to another path.
"""

from __future__ import annotations

import functools
import json
import os

_TABLE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "data",
    "impl_timings.json",
)

# Safe fallbacks per dispatch point: the impl used when the committed
# table has no passing measurement for the current backend.  Always the
# plain XLA formulation — correct everywhere, never a kernel that has
# only been seen in interpret mode.
FALLBACKS = {
    "window": "xla",
    "sync": "coarse",
    "matched_filter": "xcorr",
    "cpstrip": "xla",
}

# Every implementation name each dispatch point accepts ("auto" aside).
IMPLS = {
    "window": ("xla", "xla_pad", "xla_slow"),
    "sync": ("coarse", "coarse128", "coarse_full", "coarse_full128", "xla"),
    "matched_filter": ("xcorr", "direct"),
    "cpstrip": ("xla", "xla128"),
}


def check_impl(point: str, impl: str) -> None:
    """Raise ValueError unless ``impl`` is "auto" or a known name for
    this dispatch point."""
    if impl != "auto" and impl not in IMPLS[point]:
        raise ValueError(
            f"unknown {point} impl {impl!r}; expected 'auto' or one of "
            f"{IMPLS[point]}"
        )


@functools.lru_cache(maxsize=1)
def _load_table() -> dict:
    try:
        with open(_TABLE_PATH) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def reload_table() -> None:
    """Drop the cached table (after ``bench.py --check`` rewrites it)."""
    _load_table.cache_clear()


@functools.lru_cache(maxsize=64)
def best_impl(point: str, backend: str) -> str:
    """Fastest measured-and-equal impl for a dispatch point, or the safe
    fallback when this backend has no passing measurements."""
    fallback = FALLBACKS[point]
    entry = _load_table().get(backend, {}).get(point, {})
    best, best_ms = fallback, None
    for impl, rec in entry.items():
        if impl not in IMPLS[point]:
            continue
        if not isinstance(rec, dict) or not rec.get("equal", False):
            continue
        ms = rec.get("decode_ms", rec.get("device_ms"))
        if ms is None:
            continue
        if best_ms is None or ms < best_ms:
            best, best_ms = impl, ms
    return best


def table_path() -> str:
    return _TABLE_PATH
