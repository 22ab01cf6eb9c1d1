"""Persistent-cache placement: the env var, the checkout default, and the
per-host CPU subdirectory.

XLA:CPU AOT artifacts embed the build host's machine features; loading
them on a different host logs cpu_aot_loader errors (and can SIGILL), so
CPU entries are keyed by a host CPU fingerprint.
"""

import os
import tempfile

import jax
import pytest

from fetal_mri_segmentation_tpu.utils import compilation_cache as cc
from fetal_mri_segmentation_tpu.utils.compilation_cache import (
    _host_fingerprint, compilation_cache_dir, enable_compilation_cache)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_fingerprint_deterministic_hex():
    fp = _host_fingerprint()
    assert len(fp) == 12
    assert all(c in "0123456789abcdef" for c in fp)
    assert _host_fingerprint() == fp


def test_cache_dir_is_fingerprint_subdir(monkeypatch):
    """Without the env var the CPU backend caches in
    <checkout>/.jax_cache/cpu-<fingerprint>, and jax is pointed there."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    p = enable_compilation_cache()
    assert p == os.path.join(REPO, ".jax_cache", "cpu-" + _host_fingerprint())
    assert os.path.isdir(p)
    assert jax.config.jax_compilation_cache_dir == p
    assert enable_compilation_cache() == p  # idempotent


def test_env_var_wins_and_nothing_is_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert enable_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


@pytest.mark.parametrize("backend", ["gpu", "cpu", "other"])
def test_default_dir_fixed_in_checkout(backend):
    """A fixed path inside the checkout — never under a temp or
    process-specific directory, since the path is part of the cache key."""
    p = compilation_cache_dir(backend)
    assert p.startswith(os.path.join(REPO, ".jax_cache"))
    assert not p.startswith(tempfile.gettempdir())
    assert str(os.getpid()) not in p
    assert p == compilation_cache_dir(backend)
    if backend != "cpu":
        assert p == cc.CHECKOUT_CACHE_DIR
