"""Persistent XLA compilation cache for the entry points.

The reference pays Keras graph build on every invocation; our equivalent
cost is XLA compilation of the train step and the whole-volume inference
programs. jax's persistent cache lets a later process load them instead.

Where the cache lives:

- ``JAX_COMPILATION_CACHE_DIR`` set: jax reads it itself and this module
  sets nothing.
- otherwise: the fixed directory ``<checkout>/.jax_cache`` (git-ignored).
  The directory is part of the cache's key, so it must not move between
  runs. On the CPU backend the entries go one level down, in a
  subdirectory named by the host's CPU features (see `_host_fingerprint`).
"""

from __future__ import annotations

import hashlib
import os
import platform

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def _host_fingerprint() -> str:
    """Short hash of the host CPU's feature set.

    XLA:CPU AOT artifacts are compiled for the build host's exact machine
    features; loading them on a host with different features logs
    cpu_aot_loader errors and can SIGILL. The cache key doesn't include
    CPU features, so CPU entries are segregated per host fingerprint.
    GPU executables are keyed by the device and are unaffected.
    """
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    feats = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
            else:
                feats = platform.machine()
    except OSError:
        feats = platform.machine()
    return hashlib.sha1(feats.encode()).hexdigest()[:12]


def compilation_cache_dir(backend: str) -> str:
    """The cache directory this module uses for ``backend`` when
    ``JAX_COMPILATION_CACHE_DIR`` is not set."""
    if backend == "cpu":
        return os.path.join(CHECKOUT_CACHE_DIR, "cpu-" + _host_fingerprint())
    return CHECKOUT_CACHE_DIR


def enable_compilation_cache() -> str:
    """Idempotently point jax at a persistent on-disk compilation cache;
    returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = compilation_cache_dir(jax.default_backend())
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
