"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

Multi-device behavior (data-parallel psum over a Mesh) is tested without
real hardware via XLA's host-platform device-count flag — the standard JAX
trick (SURVEY.md section 4). Standalone runs can equivalently use:
JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8

Tests that need a GPU carry the ``gpu`` marker and skip here (the
``gpu_device`` fixture decides at run time, never at import); run them on
a GPU host with ``python -m pytest -m gpu tests/`` and no JAX_PLATFORMS.
"""

import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()
_GPU_RUN = os.environ.get("JAX_PLATFORMS", "") in ("cuda", "gpu")
if not _GPU_RUN:
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax

if not _GPU_RUN:
    jax.config.update("jax_platforms", "cpu")

# persistent compilation cache: the suite re-jits the same tiny programs
# every session — caching them across runs cuts wall time.
from fetal_mri_segmentation_tpu.utils.compilation_cache import (  # noqa: E402
    enable_compilation_cache)

enable_compilation_cache()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where there is none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda on a GPU "
                    "host)")
    return gpus[0]
