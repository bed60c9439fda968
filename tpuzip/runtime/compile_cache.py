"""Where JAX keeps its persistent compilation cache for this checkout.

`JAX_COMPILATION_CACHE_DIR` wins when it is set; otherwise the cache lives
at one fixed path in the checkout (`<repo>/.jax_cache`), so that one
process's compilations are found again by the next.  The entry points
(chip_smoke.py, bench.py, __graft_entry__.py) call `enable()` before their
first compilation.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                         ".."))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def cache_dir(environ=None) -> str:
    environ = os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable() -> str:
    """Point JAX's persistent cache at `cache_dir()`; returns the path."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
