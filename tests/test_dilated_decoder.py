"""Input-dilated decoder formulation (models/layers.py::
up_concat_conv3x3_dilated) vs the parity-decomposed reference
(up_concat_conv3x3). Both compute conv3x3x3(concat(up_nearest2(x), skip))
exactly — the dilated form absorbs the upsample into a 4^3 kernel over the
x2-lhs-dilated input; it is the formulation ConvBlock dispatches to for
training and batched inference (measured faster there, docs/PERF.md
round-3 addendum)."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from fetal_mri_segmentation_tpu.models.layers import (
    up_concat_conv3x3, up_concat_conv3x3_dilated)


from tests.synthetic import decoder_level_case as _case


def test_matches_parity_form():
    x, s, k, b = _case()
    ref = up_concat_conv3x3(x, s, k, b)
    got = up_concat_conv3x3_dilated(x, s, k, b)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)


def test_matches_materialized_upsample():
    """Against the naive materialized up+concat+conv (the ground truth both
    fused forms re-derive)."""
    x, s, k, b = _case(seed=1)
    up = jnp.repeat(jnp.repeat(jnp.repeat(x, 2, 1), 2, 2), 2, 3)
    cat = jnp.concatenate([up, s], axis=-1)
    ref = jax.lax.conv_general_dilated(
        cat, k, (1, 1, 1), "SAME",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC")) + b
    got = up_concat_conv3x3_dilated(x, s, k, b)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               atol=1e-4, rtol=1e-4)


def test_anisotropic_shapes():
    rng = np.random.default_rng(2)
    B, dd, hh, ww, CU, CS, CO = 1, 3, 4, 5, 8, 8, 8
    x = jnp.asarray(rng.normal(size=(B, dd, hh, ww, CU)), jnp.float32)
    s = jnp.asarray(rng.normal(size=(B, 2 * dd, 2 * hh, 2 * ww, CS)),
                    jnp.float32)
    k = jnp.asarray(rng.normal(size=(3, 3, 3, CU + CS, CO)) * 0.1,
                    jnp.float32)
    b = jnp.zeros((CO,), jnp.float32)
    ref = up_concat_conv3x3(x, s, k, b)
    got = up_concat_conv3x3_dilated(x, s, k, b)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5)


def test_no_skip_branch():
    """Isensee's up-sampling module path: skip=None, kernel covers only the
    upsampled channels."""
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(1, 4, 4, 4, 8)), jnp.float32)
    k = jnp.asarray(rng.normal(size=(3, 3, 3, 8, 8)) * 0.1, jnp.float32)
    b = jnp.asarray(rng.normal(size=(8,)), jnp.float32)
    ref = up_concat_conv3x3(x, None, k, b)
    got = up_concat_conv3x3_dilated(x, None, k, b)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5)


def test_gradients_match():
    x, s, k, b = _case(B=1, seed=4)

    def loss(impl):
        return lambda x, s, k: jnp.sum(impl(x, s, k, b) ** 2)

    gd = jax.grad(loss(up_concat_conv3x3_dilated), argnums=(0, 1, 2))(x, s, k)
    gp = jax.grad(loss(up_concat_conv3x3), argnums=(0, 1, 2))(x, s, k)
    for a, r in zip(gd, gp):
        np.testing.assert_allclose(np.asarray(a), np.asarray(r),
                                   atol=2e-4, rtol=2e-4)


def test_convblock_dispatch_train_eval_agree(monkeypatch):
    """ConvBlock routes train -> dilated, eval/B=1 -> parity; both must give
    the same output for the same params (exact-math twins). The backend
    gate is forced open so the dilated branch is actually exercised on the
    CPU test mesh (without this, both sides take the parity form where the gate is closed
    and the comparison is vacuous)."""
    from fetal_mri_segmentation_tpu.models import UNet3D
    from fetal_mri_segmentation_tpu.models import layers

    monkeypatch.setattr(layers, "_dilated_backend_ok", lambda: True)
    model = UNet3D(n_labels=1, depth=3, n_base_filters=8, dtype=jnp.float32)
    x = jnp.asarray(np.random.default_rng(5).normal(
        size=(1, 16, 16, 16, 1)), jnp.float32)
    params = model.init(jax.random.PRNGKey(0), x)
    # deterministic=True both times; train flag only flips the decoder impl
    y_eval = model.apply(params, x)
    y_train = model.apply(params, x, train=True)
    np.testing.assert_allclose(np.asarray(y_train), np.asarray(y_eval),
                               atol=2e-4)


def test_convblock_batched_dispatch(monkeypatch):
    """B>1 eval routes to dilated (gate forced open); must equal
    per-sample B=1 (parity) rows."""
    from fetal_mri_segmentation_tpu.models import UNet3D
    from fetal_mri_segmentation_tpu.models import layers

    monkeypatch.setattr(layers, "_dilated_backend_ok", lambda: True)
    model = UNet3D(n_labels=1, depth=3, n_base_filters=8, dtype=jnp.float32)
    x = jnp.asarray(np.random.default_rng(6).normal(
        size=(3, 16, 16, 16, 1)), jnp.float32)
    params = model.init(jax.random.PRNGKey(0), x[:1])
    y_b = model.apply(params, x)  # dilated (B>1)
    y_1 = jnp.concatenate([model.apply(params, x[i:i + 1])  # parity (B=1)
                           for i in range(3)], axis=0)
    np.testing.assert_allclose(np.asarray(y_b), np.asarray(y_1), atol=2e-4)
