"""Persistent XLA compilation cache.

The reference's only "compile" cost is gensim's one-time Cython build;
ours is XLA program compilation, and a cold DeepWalk/Struc2Vec run
spends much of its time in compiles that are bit-identical across
processes. JAX ships a disk-backed executable cache for exactly this;
enabling it is the framework's job, not each script's, so the package
turns it on at import (opt out with GETPU_NO_COMPILE_CACHE=1).

Where the cache lives:

- `JAX_COMPILATION_CACHE_DIR`, when set (JAX reads it into
  `jax_compilation_cache_dir` itself) — or any directory the process
  configured before import. Nothing else is set then.
- Otherwise one fixed directory inside the checkout, `.jax_cache/` at
  the repository root (git-ignored). The path is part of the cache's
  key, so it must not move between runs.

Scope: every platform list except an explicitly CPU-only one. XLA:CPU
serializes AOT results stamped with the build host's CPU features;
reloading them under a different feature set logs feature-mismatch
errors and risks SIGILL, and CPU compiles are local and fast, so
`JAX_PLATFORMS=cpu` (the test configuration) leaves the cache off. An
unset platform list means JAX picks the accelerator, and the cache is
on. The decision reads `jax.config.jax_platforms` without initializing
a backend.
"""

from __future__ import annotations

import os

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    ".jax_cache",
)


def _cpu_only(platforms: str | None) -> bool:
    """True only for an explicit platform list naming nothing but CPU."""
    names = [p.strip().lower() for p in (platforms or "").split(",")
             if p.strip()]
    return bool(names) and all(p == "cpu" for p in names)


def enable_persistent_cache(path: str | None = None) -> str | None:
    """Point JAX's compilation cache at a disk directory. Idempotent.

    Returns the cache directory in effect, or None when disabled
    (GETPU_NO_COMPILE_CACHE=1, or a CPU-only platform configuration).
    """
    if os.environ.get("GETPU_NO_COMPILE_CACHE"):
        return None
    import jax

    current = jax.config.jax_compilation_cache_dir
    if current:  # JAX_COMPILATION_CACHE_DIR, or configured by the user
        return current
    if _cpu_only(jax.config.jax_platforms):
        return None
    path = path or CHECKOUT_CACHE_DIR
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        # read-only checkout: the cache is a pure optimization — never
        # let it break `import graphembedding`
        return None
    jax.config.update("jax_compilation_cache_dir", path)
    return path
