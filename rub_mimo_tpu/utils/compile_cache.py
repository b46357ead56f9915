"""Where the persistent XLA compilation cache lives.

One rule for every entry point (CLI, benchmarks, the chip smoke test and
the test suite): if ``JAX_COMPILATION_CACHE_DIR`` is set, that directory
is the cache and no other is set; otherwise the cache is the fixed
directory ``<checkout>/.jax_cache`` (git-ignored).  The path is part of
the cache's key, so it never moves between runs.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(_CHECKOUT, ".jax_cache")


def cache_dir() -> str:
    """The cache directory the rule above selects."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable() -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir` and
    cache every program that took at least a second to compile.  Returns
    the directory."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
