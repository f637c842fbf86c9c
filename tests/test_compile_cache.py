"""Persistent-compilation-cache hook (utils/compile_cache.py).

The framework enables JAX's disk-backed executable cache at import so
cold accelerator runs don't re-pay XLA compiles. It lands in
$JAX_COMPILATION_CACHE_DIR when that is set, and otherwise in one fixed
git-ignored directory inside the checkout. On CPU-only platform configs
(like this test process) it must stay OFF: XLA:CPU cache entries are
stamped with host CPU features and reloading them under a different
feature set risks SIGILL. These tests pin that contract; the
cross-process cache-hit behavior itself is JAX's.
"""

import os
import subprocess
import sys

import jax
import pytest

from graphembedding.utils import compile_cache
from graphembedding.utils.compile_cache import (
    CHECKOUT_CACHE_DIR,
    _cpu_only,
    enable_persistent_cache,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cpu_only_platform_detection():
    assert _cpu_only("cpu")
    assert _cpu_only("CPU, cpu")
    assert not _cpu_only(None)  # unset: JAX picks the accelerator
    assert not _cpu_only("")
    assert not _cpu_only("cuda,cpu")
    assert not _cpu_only("gpu")


def test_disabled_on_cpu_only_process():
    # conftest forces jax_platforms=cpu, so the import-time call (and
    # this one) must be a no-op here
    assert _cpu_only(jax.config.jax_platforms)
    assert enable_persistent_cache() is None
    assert not jax.config.jax_compilation_cache_dir


@pytest.fixture
def accelerator_platforms(monkeypatch):
    """Pretend the platform list is unset, restoring the cache dir."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(compile_cache, "_cpu_only", lambda p: False)
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_default_dir_is_inside_checkout_and_ignored(accelerator_platforms):
    assert CHECKOUT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
    jax.config.update("jax_compilation_cache_dir", None)
    assert enable_persistent_cache() == CHECKOUT_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == CHECKOUT_CACHE_DIR


def test_respects_existing_config(accelerator_platforms, tmp_path):
    preset = str(tmp_path / "preset-cache")
    jax.config.update("jax_compilation_cache_dir", preset)
    # user configuration wins; nothing is overridden or created
    assert enable_persistent_cache(str(tmp_path / "other")) == preset
    assert jax.config.jax_compilation_cache_dir == preset
    assert not os.path.exists(tmp_path / "other")


def _import_cache_dir(env_update, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR",
                        "GETPU_NO_COMPILE_CACHE")}
    env.update(env_update)
    code = ("import jax, graphembedding\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_env_dir_honoured_at_import(tmp_path):
    d = str(tmp_path / "env-cache")
    assert _import_cache_dir({"JAX_COMPILATION_CACHE_DIR": d},
                             tmp_path) == d


def test_enabled_at_import_with_platforms_unset(tmp_path):
    # no platform list: JAX would pick the accelerator, so the import
    # turns the cache on in the checkout (no backend is initialized)
    assert _import_cache_dir({}, tmp_path) == CHECKOUT_CACHE_DIR


def test_opt_out_env(monkeypatch, accelerator_platforms):
    monkeypatch.setenv("GETPU_NO_COMPILE_CACHE", "1")
    jax.config.update("jax_compilation_cache_dir", None)
    assert enable_persistent_cache() is None
