"""Model family + factory.

Public convention: all framework-level arrays are channels-first
``(B, C, D, H, W)`` like the reference (Keras channels_first); the models
compute in NDHWC internally (channels-last, the layout cuDNN and XLA's
GPU convolutions take without a relayout). `apply_channels_first`
does the (XLA-fused) transposes at the jit boundary.
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp

from fetal_mri_segmentation_tpu.models.unet3d import UNet3D  # noqa: F401
from fetal_mri_segmentation_tpu.models.isensee2017 import Isensee2017  # noqa: F401
from fetal_mri_segmentation_tpu.models import layers  # noqa: F401


def build_model(config, bn_axis_name=None) -> Any:
    """Instantiate the configured model (reference: train.py model selection —
    unet3d/model/unet.py::unet_model_3d vs isensee2017.py::isensee2017_model).

    ``bn_axis_name``: mesh axis for sync-BatchNorm under data parallelism
    (param tree is unchanged; only the moment reduction widens)."""
    dtype = jnp.dtype(config.compute_dtype)
    if config.model_name == "unet":
        return UNet3D(
            n_labels=config.n_labels,
            depth=config.depth,
            n_base_filters=config.n_base_filters,
            deconvolution=config.deconvolution,
            batch_normalization=config.batch_normalization,
            instance_normalization=config.instance_normalization,
            activation_name=config.activation_name,
            dtype=dtype,
            bn_axis_name=bn_axis_name,
            fold_level0=getattr(config, "fold_level0", "auto"),
            fold_formulation=getattr(config, "fold_formulation", "dense"),
        )
    if config.model_name == "isensee":
        return Isensee2017(
            n_labels=config.n_labels,
            depth=config.depth,
            n_base_filters=config.n_base_filters,
            dropout_rate=config.dropout_rate,
            n_segmentation_levels=config.n_segmentation_levels,
            activation_name=config.activation_name,
            dtype=dtype,
            fold_level0=getattr(config, "fold_level0", "auto"),
            fold_formulation=getattr(config, "fold_formulation", "dense"),
        )
    raise ValueError(f"unknown model_name {config.model_name!r}")


def ncdhw_to_ndhwc(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.transpose(x, (0, 2, 3, 4, 1))


def ndhwc_to_ncdhw(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.transpose(x, (0, 4, 1, 2, 3))


def apply_channels_first(model, variables, x_ncdhw, **kwargs):
    """Apply a model to channels-first input, returning channels-first output."""
    y = model.apply(variables, ncdhw_to_ndhwc(x_ncdhw), **kwargs)
    return ndhwc_to_ncdhw(y)
