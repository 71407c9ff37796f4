"""Persistent XLA compilation cache placement for the entry points.

Called by the CLI, the bench scripts and chip_smoke.py before their first
compile — never at package import, so a library user's own JAX settings
stay untouched.
"""

from __future__ import annotations

import os

# A fixed directory at the checkout root (listed in .gitignore): the cache
# path is part of what JAX keys on, so it must not move between runs.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__
    )))),
    ".jax_cache",
)


def setup() -> str:
    """Return the compilation-cache directory in use.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets nothing; otherwise the cache goes to ``DEFAULT_DIR``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
