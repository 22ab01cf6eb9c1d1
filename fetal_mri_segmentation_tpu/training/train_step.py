"""Jitted train / eval steps with fused on-device augmentation.

This is the device-side replacement for the reference's per-batch
``fit_generator`` hot loop (SURVEY.md section 3.1): one compiled XLA program
per step containing augmentation (ops/augment.py), the forward pass, the
dice loss, the backward pass, and the Adam update — zero host round-trips
besides the (prefetched, asynchronous) batch feed.

Batches are channels-first ``(B, C, D, H, W)`` float32 at the boundary
(reference array contract); the NCDHW→NDHWC transpose happens inside jit and
fuses away.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from fetal_mri_segmentation_tpu.ops.augment import augment_batch
from fetal_mri_segmentation_tpu.ops.dice import (
    dice_coefficient, dice_coefficient_loss, weighted_dice_coefficient_loss)


def get_loss_fn(config) -> Callable:
    """Loss selection mirrors the reference: plain negative dice for the UNet
    path (unet.py compile), weighted multi-class dice for Isensee
    (isensee2017.py compile).

    Returned signature: ``loss(y, pred, axis_name, sample_mask)`` — the loss
    value is the GLOBAL loss (identical on every shard, psum'd partial sums),
    so the matching gradient combination across shards is psum (sum of
    partials), handled in `make_train_step`.
    """
    if config.model_name == "isensee" or config.n_labels > 1:
        def loss(y, pred, axis_name=None, sample_mask=None):
            return weighted_dice_coefficient_loss(
                y, pred, axis_name=axis_name, sample_mask=sample_mask)
    else:
        def loss(y, pred, axis_name=None, sample_mask=None):
            if sample_mask is not None:
                # zeroing truth AND prediction of padded samples reproduces
                # the ragged-batch global dice exactly (batch is flattened).
                m = sample_mask.reshape((-1,) + (1,) * (y.ndim - 1))
                y = y * m
                pred = pred * m
            return dice_coefficient_loss(y, pred, axis_name=axis_name)
    return loss


def _forward(model, params, batch_stats, x_ncdhw, *, train, dropout_rng=None):
    """Apply the model on channels-first input; returns (y_ncdhw, new_stats)."""
    x = jnp.transpose(x_ncdhw, (0, 2, 3, 4, 1))
    variables = {"params": params}
    has_bn = bool(jax.tree_util.tree_leaves(batch_stats))
    if has_bn:
        variables["batch_stats"] = batch_stats
    rngs = {"dropout": dropout_rng} if (train and dropout_rng is not None) else None
    if has_bn and train:
        y, mutated = model.apply(variables, x, train=True,
                                 mutable=["batch_stats"], rngs=rngs)
        new_stats = mutated["batch_stats"]
    else:
        y = model.apply(variables, x, train=train, rngs=rngs)
        new_stats = batch_stats
    return jnp.transpose(y, (0, 4, 1, 2, 3)), new_stats


def make_train_step(model, config, *, axis_name: Optional[str] = None,
                    jit: bool = True,
                    debug_return_batch: bool = False) -> Callable:
    """Build ``step(state, x, y, rng) -> (state, metrics)``.

    With ``axis_name`` set the step is written for use inside
    shard_map/pjit: gradients (and BatchNorm stats) are psum-averaged over
    that mesh axis before the update — the all-reduce of BASELINE
    config #5. The same function serves N=1 (axis_name=None) unchanged.

    ``debug_return_batch``: the step additionally returns the post-augment
    ``(x, y)`` it actually trained on — test hook proving per-shard
    augmentation divergence under DP (see tests/test_parallel.py).
    """
    loss_fn_inner = get_loss_fn(config)
    needs_dropout = config.model_name == "isensee" and config.dropout_rate > 0
    aug_kw = dict(flip=config.flip, permute=config.permute,
                  contrast=config.contrast,
                  scale_deviation=config.distort,
                  rotate=getattr(config, "rotate", None))
    do_augment = config.augment and any(
        [config.flip, config.permute, config.contrast, config.distort,
         getattr(config, "rotate", None)])

    use_remat = bool(getattr(config, "remat", False))

    def step(state, x, y, rng, n_valid=None):
        # compressed-staging entry cast (training/loop.py::_compress): x may
        # arrive bf16 (half the H2D bytes; matches the model's own input
        # rounding — note augmentation then interpolates the bf16-rounded
        # values, see the _compress comment) and y uint8 (one-hot/binary
        # labels are integral; exact). f32 inputs unchanged.
        x = x.astype(jnp.float32) if x.dtype != jnp.float32 else x
        y = y.astype(jnp.float32) if y.dtype != jnp.float32 else y
        aug_rng, drop_rng = jax.random.split(rng)
        if do_augment:
            x, y = augment_batch(aug_rng, x, y, **aug_kw)
        sample_mask = _sample_mask(x, n_valid)

        fwd = _forward
        if use_remat and not jax.tree_util.tree_leaves(state.batch_stats):
            # jax.checkpoint: recompute activations in the backward pass
            # instead of stashing them — HBM ~ one level instead of the
            # whole forward, at ~1/3 extra FLOPs (remat lever for large 3D
            # patches). BatchNorm's mutable stats are incompatible with
            # checkpointing the whole forward, hence the empty-stats guard.
            def fwd(model_, params, stats, x, *, train, dropout_rng=None):
                def inner(p, xx, key):
                    return _forward(model_, p, stats, xx, train=train,
                                    dropout_rng=key)
                return jax.checkpoint(inner)(params, x, dropout_rng)

        def loss_of(params):
            pred, new_stats = fwd(
                model, params, state.batch_stats, x, train=True,
                dropout_rng=drop_rng if needs_dropout else None)
            return (loss_fn_inner(y, pred, axis_name, sample_mask),
                    (pred, new_stats))

        (loss, (pred, new_stats)), grads = jax.value_and_grad(
            loss_of, has_aux=True)(state.params)

        if axis_name is not None:
            # Cross-shard gradient combination happens AUTOMATICALLY: the
            # loss is the global loss with shard-partial gradients
            # (ops/dice.py::_collective_ratio), and shard_map's autodiff
            # psums the cotangent of invariant (replicated) inputs — i.e.
            # `grads` already equals the summed global gradient on every
            # shard. Adding an explicit psum here would multiply by the axis
            # size (regression-guarded by tests/test_parallel.py).
            if jax.tree_util.tree_leaves(new_stats):
                new_stats = jax.lax.pmean(new_stats, axis_name)

        new_state = state.apply_gradients(grads).replace(batch_stats=new_stats)
        metrics = {"loss": loss,
                   "dice": _masked_dice(y, pred, sample_mask, axis_name)}
        metrics.update(_label_wise_metrics(config, y, pred, sample_mask,
                                           axis_name))
        if axis_name is not None:
            # numerically a no-op (values are already identical across
            # shards via the psum'd partials) but marks them replicated for
            # shard_map's out_specs=P() variance check.
            metrics = jax.tree_util.tree_map(
                lambda v: jax.lax.pmean(v, axis_name), metrics)
        if debug_return_batch:
            return new_state, metrics, (x, y)
        return new_state, metrics

    if jit and axis_name is None:
        return jax.jit(step, donate_argnums=(0,))
    return step


def make_eval_step(model, config, *, jit: bool = True) -> Callable:
    """Build ``eval_step(state, x, y) -> metrics`` (no augmentation, no
    dropout, running BN stats — the reference's validation-generator path)."""
    loss_fn_inner = get_loss_fn(config)

    def step(state, x, y, n_valid=None, axis_name=None):
        x = x.astype(jnp.float32) if x.dtype != jnp.float32 else x
        y = y.astype(jnp.float32) if y.dtype != jnp.float32 else y
        pred, _ = _forward(model, state.params, state.batch_stats, x,
                           train=False)
        sample_mask = _sample_mask(x, n_valid)
        metrics = {"loss": loss_fn_inner(y, pred, axis_name, sample_mask),
                   "dice": _masked_dice(y, pred, sample_mask, axis_name)}
        metrics.update(_label_wise_metrics(config, y, pred, sample_mask,
                                           axis_name))
        if axis_name is not None:
            metrics = jax.tree_util.tree_map(
                lambda v: jax.lax.pmean(v, axis_name), metrics)
        return metrics

    return jax.jit(step, static_argnames=("axis_name",)) if jit else step


def _sample_mask(x, n_valid):
    """(B,) mask of real (non-padding) samples, or None if full batch."""
    if n_valid is None:
        return None
    return (jnp.arange(x.shape[0]) < n_valid).astype(jnp.float32)


def _label_wise_metrics(config, y, pred, sample_mask, axis_name):
    """Per-label dice metrics, Keras-header naming ``label_{i}_dice_coef``.

    Reference: unet3d/model/unet.py::unet_model_3d
    (include_label_wise_dice_coefficients → metrics.py::
    get_label_dice_coefficient_function closures logged by CSVLogger).
    """
    if not getattr(config, "include_label_wise_dice_coefficients", False):
        return {}
    if config.n_labels <= 1:
        return {}
    out = {}
    for i in range(config.n_labels):
        out[f"label_{i}_dice_coef"] = _masked_dice(
            y[:, i:i + 1], pred[:, i:i + 1], sample_mask, axis_name)
    return out


def _masked_dice(y, pred, sample_mask, axis_name):
    """Global-batch dice metric with jit-padding samples excluded exactly
    (zeroing truth and prediction removes them from the flattened sums)."""
    if sample_mask is not None:
        m = sample_mask.reshape((-1,) + (1,) * (y.ndim - 1))
        y = y * m
        pred = pred * m
    return dice_coefficient(y, pred, axis_name=axis_name)


def pad_batch(x: "jnp.ndarray", y: "jnp.ndarray", batch_size: int):
    """Pad a final partial batch up to the static jit batch size; returns
    (x_padded, y_padded, n_valid). Pass n_valid to the step so padded samples
    are masked out of the loss exactly (see `_valid_mask`) — fit_generator
    ragged-batch parity under static jit shapes (SURVEY.md section 7 hard
    parts list).
    """
    import numpy as np

    n = x.shape[0]
    if n == batch_size:
        return x, y, n
    pad = [(0, batch_size - n)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad), np.pad(y, pad), n
