"""GPU-only checks: the bf16 and TF32 programs against the float32
reference on a real card, with chip_smoke.py's limits. They skip where
no GPU is visible (the CPU suite); `python chip_smoke.py` runs the same
comparisons at full width.

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from fetal_mri_segmentation_tpu.config import Config  # noqa: E402
from fetal_mri_segmentation_tpu.models import build_model  # noqa: E402
from fetal_mri_segmentation_tpu.models.reference import (  # noqa: E402
    reference_forward)

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("dtype,atol", [
    ("bfloat16", chip_smoke.BF16_PROB_ATOL),
    ("float32", chip_smoke.F32_PROB_ATOL),
])
@pytest.mark.parametrize("family", ["unet", "isensee"])
def test_model_matches_reference_on_gpu(gpu_device, family, dtype, atol):
    cfg = Config(model_name=family, compute_dtype=dtype,
                 patch_shape=(32, 32, 32), n_base_filters=8,
                 depth=4 if family == "unet" else 5)
    model = build_model(cfg)
    x = jax.device_put(jnp.asarray(np.random.default_rng(0).normal(
        size=(2, 32, 32, 32, 1)), jnp.float32), gpu_device)
    v = model.init(jax.random.PRNGKey(0), x)
    got = np.asarray(jax.jit(model.apply)(v, x))
    want = np.asarray(reference_forward(cfg, v, x))
    assert np.abs(got - want).max() <= atol
    assert chip_smoke.dice(got > 0.5, want > 0.5) >= \
        chip_smoke.LABEL_DICE_MIN
