"""Persistent XLA compilation cache location.

JAX keys its persistent cache on the cache directory among other things,
so a directory that moves between runs never hits.  One rule for every
entry point (``chip_smoke.py``, ``bench.py``, ``scripts/``):

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; nothing else
  is configured in code.
* otherwise: the fixed ``<repo>/.jax_cache`` (listed in ``.gitignore``).
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def compile_cache_dir() -> str:
    """The directory the persistent compilation cache lives in."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``compile_cache_dir()``
    and return that directory."""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
