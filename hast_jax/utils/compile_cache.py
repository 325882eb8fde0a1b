"""Where XLA's persistent compilation cache lives.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when it is set nothing
is configured here.  Otherwise the cache goes to a fixed directory
inside the checkout (``<checkout>/.jax_cache``, listed in
``.gitignore``), so that every process of this repo finds what an
earlier one compiled.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent cache; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
