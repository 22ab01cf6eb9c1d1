"""Plain float32 reference forward for the model family.

A straight reading of the reference graphs (unet3d/model/unet.py::
unet_model_3d, isensee2017.py::isensee2017_model) over the same parameter
tree the models use, written with nothing but ``jax.numpy`` and
``lax.conv_general_dilated``: no folding, no fused upsample+conv, no
alternative decoder forms, float32 throughout, every convolution at
``precision="highest"`` (a GPU otherwise runs float32 convolutions in
TF32). It exists to check the models and predictors against — on the CPU
in the tests, and on the GPU in ``chip_smoke.py`` — and is never on a hot
path.

Inputs and outputs are NDHWC like ``model.apply``. Inference semantics only
(BatchNorm uses its running moments; no dropout).
"""

from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np

_DN = ("NDHWC", "DHWIO", "NDHWC")
_HI = jax.lax.Precision.HIGHEST


def _conv(p: Dict[str, Any], x, stride: int = 1):
    y = jax.lax.conv_general_dilated(
        x, jnp.asarray(p["kernel"], jnp.float32), (stride,) * 3, "SAME",
        dimension_numbers=_DN, precision=_HI)
    return y + jnp.asarray(p["bias"], jnp.float32)


def _deconv(p: Dict[str, Any], x):
    y = jax.lax.conv_transpose(x, jnp.asarray(p["kernel"], jnp.float32),
                               (2, 2, 2), "VALID", dimension_numbers=_DN,
                               precision=_HI)
    return y + jnp.asarray(p["bias"], jnp.float32)


def _instance_norm(p, x, eps: float = 1e-3):
    mean = jnp.mean(x, axis=(1, 2, 3), keepdims=True)
    var = jnp.mean(jnp.square(x - mean), axis=(1, 2, 3), keepdims=True)
    return (x - mean) / jnp.sqrt(var + eps) * p["scale"] + p["bias"]


def _batch_norm(p, stats, x, eps: float = 1e-3):
    return (x - stats["mean"]) / jnp.sqrt(stats["var"] + eps) * p["scale"] \
        + p["bias"]


def _up(x):
    for ax in (1, 2, 3):
        x = jnp.repeat(x, 2, axis=ax)
    return x


def _pool(x):
    b, d, h, w, c = x.shape
    return x.reshape(b, d // 2, 2, h // 2, 2, w // 2, 2, c).max(axis=(2, 4, 6))


def _head(x, activation: str):
    if activation == "sigmoid":
        return jax.nn.sigmoid(x)
    if activation == "softmax":
        return jax.nn.softmax(x, axis=-1)
    return x


def unet_reference(variables, x, *, depth: int, activation: str = "sigmoid",
                   deconvolution: bool = False, logits: bool = False):
    """UNet3D forward (reference: unet.py::unet_model_3d)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})

    def block(name, h):
        p = params[name]
        h = _conv(p["conv"], h)
        if "bn" in p:
            h = _batch_norm(p["bn"], stats[name]["bn"], h)
        elif "in" in p:
            h = _instance_norm(p["in"], h)
        return jax.nn.relu(h)

    h = jnp.asarray(x, jnp.float32)
    skips = []
    for level in range(depth):
        h = block(f"enc{level}_conv1", h)
        h = block(f"enc{level}_conv2", h)
        if level < depth - 1:
            skips.append(h)
            h = _pool(h)
    for level in range(depth - 2, -1, -1):
        h = (_deconv(params[f"dec{level}_up"]["deconv"], h) if deconvolution
             else _up(h))
        h = jnp.concatenate([h, skips[level]], axis=-1)
        h = block(f"dec{level}_conv1", h)
        h = block(f"dec{level}_conv2", h)
    y = _conv(params["head"], h)
    return y if logits else _head(y, activation)


def isensee_reference(variables, x, *, depth: int,
                      n_segmentation_levels: int,
                      activation: str = "sigmoid", logits: bool = False):
    """Isensee2017 forward (reference: isensee2017.py::isensee2017_model)."""
    params = variables["params"]

    def block(name, h, stride=1):
        p = params[name]
        h = _instance_norm(p["in"], _conv(p["conv"], h, stride))
        return jnp.where(h >= 0, h, 0.3 * h)  # LeakyReLU(alpha=0.3)

    h = jnp.asarray(x, jnp.float32)
    outputs = []
    for level in range(depth):
        h_in = block(f"enc{level}_in", h, 1 if level == 0 else 2)
        c = block(f"enc{level}_ctx2", block(f"enc{level}_ctx1", h_in))
        h = h_in + c
        outputs.append(h)
    segs = {}
    for level in range(depth - 2, -1, -1):
        h = block(f"dec{level}_up", _up(h))
        h = jnp.concatenate([outputs[level], h], axis=-1)
        h = block(f"dec{level}_loc2", block(f"dec{level}_loc1", h))
        if level < n_segmentation_levels:
            segs[level] = _conv(params[f"seg{level}"], h)
    out = None
    for level in reversed(range(n_segmentation_levels)):
        out = segs[level] if out is None else out + segs[level]
        if level > 0:
            out = _up(out)
    return out if logits else _head(out, activation)


def reference_forward(config, variables, x, logits: bool = False):
    """The reference forward of ``config``'s model on NDHWC ``x``."""
    with jax.default_matmul_precision("highest"):
        if config.model_name == "unet":
            return unet_reference(variables, x, depth=config.depth,
                                  activation=config.activation_name,
                                  deconvolution=config.deconvolution,
                                  logits=logits)
        if config.model_name == "isensee":
            return isensee_reference(
                variables, x, depth=config.depth,
                n_segmentation_levels=config.n_segmentation_levels,
                activation=config.activation_name, logits=logits)
    raise ValueError(f"unknown model_name {config.model_name!r}")


def reference_sliding_window(config, variables, volume_cdhw: np.ndarray,
                             overlap: int, batch: int = 8) -> np.ndarray:
    """Sliding-window probabilities ``(L, D, H, W)`` built from the numpy
    patch helpers (ops/patches.py: grid, zero-padded extraction, Gaussian
    overlap-add) around `reference_forward`."""
    from fetal_mri_segmentation_tpu.ops.patches import (
        compute_patch_indices, gaussian_importance_map,
        get_patch_from_3d_data, reconstruct_from_patches)

    patch = tuple(config.patch_shape)
    image_shape = volume_cdhw.shape[1:]
    corners = compute_patch_indices(image_shape, patch, overlap)
    fwd = jax.jit(lambda v, p: reference_forward(config, v, p))
    preds = []
    for i in range(0, len(corners), batch):
        chunk = np.stack([get_patch_from_3d_data(volume_cdhw, patch, c)
                          for c in corners[i:i + batch]])
        y = fwd(variables, jnp.transpose(chunk, (0, 2, 3, 4, 1)))
        preds.extend(np.transpose(np.asarray(y), (0, 4, 1, 2, 3)))
    weights = gaussian_importance_map(
        patch, config.gaussian_recon_sigma_scale)
    return reconstruct_from_patches(
        preds, corners, (config.n_labels,) + tuple(image_shape),
        weight_map=weights)
