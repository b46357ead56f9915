"""Device-to-host fetches.

``to_host`` and ``fetch_tree`` are the names the pipeline, the apps and
the benchmarks use to bring results to the host: one array, or a whole
pytree (e.g. a DecodeResult) in one ``jax.device_get``.
"""

from __future__ import annotations

from typing import Any

import numpy as np


def to_host(x: Any) -> np.ndarray:
    """Fetch one (device) array as numpy."""
    return np.asarray(x)


def fetch_tree(tree: Any) -> Any:
    """Fetch every array leaf of a pytree to numpy in one transfer;
    ``None`` leaves and other Python values pass through."""
    import jax

    return jax.device_get(tree)
