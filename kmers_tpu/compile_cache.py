"""Where JAX keeps this repository's persistent compilation cache.

Every entry point (the CLI, chip_smoke.py, the bench scripts, the test
suite) calls ``configure()`` before its first compile, so all of them share
one cache.  The cache is found again only under the same path, so the path
is fixed: never a temporary name, a process id or a time.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def configure() -> str:
    """Set up the persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and this
    changes nothing.  Otherwise the cache goes to ``<checkout>/.jax_cache``
    (listed in .gitignore), and every compiled program is kept, however
    short its compile."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return DEFAULT_DIR
