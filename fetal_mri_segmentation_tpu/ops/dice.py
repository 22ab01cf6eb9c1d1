"""Soft-Dice losses and metrics.

Formula parity with the reference (reference: unet3d/metrics.py::
dice_coefficient, dice_coefficient_loss, weighted_dice_coefficient,
weighted_dice_coefficient_loss, label_wise_dice_coefficient):

- ``dice = (2*sum(t*p) + smooth) / (sum(t) + sum(p) + smooth)`` over the
  flattened tensors, ``smooth = 1.0``.
- The loss is the NEGATIVE dice (not ``1 - dice``) — optimum at -1.
- Weighted (multi-class) dice: per-channel dice over the spatial axes with
  ``smooth = 1e-5`` and ``smooth/2`` added inside the numerator sum, then the
  unweighted mean over channels (equal class weighting).

All functions are pure ``jnp`` and usable under jit/grad/vmap. Reductions are
accumulated in float32 regardless of the compute dtype so that bf16 model
outputs still produce accurate Dice numbers.

Tensor layout: channels-first ``(B, C, D, H, W)`` like the reference
(Keras ``image_data_format="channels_first"``); the functions only assume the
channel axis position where it matters (label-wise metrics).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp


def _collective_ratio(locals_: dict, f, axis_name: Optional[str]
                      ) -> jnp.ndarray:
    """Evaluate ``f(global partial sums)`` under an optional mesh axis with
    gradients that are exact SHARD-PARTIALS of the global value.

    Construction: globals are psum'd with stop_gradient (collectives stay out
    of the differentiated graph — JAX's psum-transpose multiplies replicated
    cotangents by the axis size, which would inflate grads by N); the
    gradient path is the first-order surrogate ``sum_i sg(df/dg_i)*local_i``,
    whose value-shift cancels. Each shard's grad is then d(global f)/d(theta)
    restricted to its local data, so the train step's ``psum(grads)``
    reconstructs the exact global gradient (tests/test_parallel.py).
    """
    if axis_name is None:
        return f(locals_)
    glob = {k: jax.lax.psum(jax.lax.stop_gradient(v), axis_name)
            for k, v in locals_.items()}
    value = f(glob)
    dfdg = jax.grad(f)(glob)
    surrogate = sum(jax.lax.stop_gradient(dfdg[k]) * locals_[k]
                    for k in locals_)
    return value + surrogate - jax.lax.stop_gradient(surrogate)


def dice_coefficient(y_true: jnp.ndarray, y_pred: jnp.ndarray,
                     smooth: float = 1.0,
                     axis_name: Optional[str] = None) -> jnp.ndarray:
    """Global soft Dice over flattened tensors. Reference: metrics.py::dice_coefficient.

    ``axis_name``: when running sharded over a mesh axis (data-parallel), the
    partial sums are reduced across shards so the result equals the
    single-device dice of the GLOBAL batch exactly — dice is nonlinear across
    the batch, so mean-of-per-shard-dice would be a different objective.
    """
    y_true_f = y_true.reshape(-1).astype(jnp.float32)
    y_pred_f = y_pred.reshape(-1).astype(jnp.float32)
    locals_ = {"intersection": jnp.sum(y_true_f * y_pred_f),
               "sums": jnp.sum(y_true_f) + jnp.sum(y_pred_f)}

    def f(g):
        return (2.0 * g["intersection"] + smooth) / (g["sums"] + smooth)

    return _collective_ratio(locals_, f, axis_name)


def dice_coefficient_loss(y_true: jnp.ndarray, y_pred: jnp.ndarray,
                          smooth: float = 1.0,
                          axis_name: Optional[str] = None) -> jnp.ndarray:
    """Negative dice (NOT 1-dice). Reference: metrics.py::dice_coefficient_loss."""
    return -dice_coefficient(y_true, y_pred, smooth=smooth,
                             axis_name=axis_name)


def weighted_dice_coefficient(y_true: jnp.ndarray, y_pred: jnp.ndarray,
                              axis=(-3, -2, -1), smooth: float = 1e-5,
                              axis_name: Optional[str] = None,
                              sample_mask: Optional[jnp.ndarray] = None
                              ) -> jnp.ndarray:
    """Per-channel dice over spatial axes, mean over channels.

    Reference: metrics.py::weighted_dice_coefficient —
    ``mean( 2*(sum(t*p, axis) + smooth/2) / (sum(t, axis) + sum(p, axis) + smooth) )``.

    ``sample_mask`` (B,): 1 for real samples, 0 for jit-padding — masked
    samples are excluded from the mean (a padded all-zero sample would
    otherwise contribute a spurious term of 1.0). Sharded (``axis_name``):
    the masked sum and count are psum-reduced, so the value equals the
    single-device mean over the global ragged batch exactly.
    """
    y_true = y_true.astype(jnp.float32)
    y_pred = y_pred.astype(jnp.float32)
    num = 2.0 * (jnp.sum(y_true * y_pred, axis=axis) + smooth / 2.0)
    den = jnp.sum(y_true, axis=axis) + jnp.sum(y_pred, axis=axis) + smooth
    terms = num / den  # (B, C) for 5-D inputs
    if sample_mask is not None:
        m = sample_mask.reshape(terms.shape[:1] + (1,) * (terms.ndim - 1))
        total = jnp.sum(terms * m)
        count = jnp.sum(m) * (terms.size / terms.shape[0])
    else:
        total = jnp.sum(terms)
        count = jnp.asarray(terms.size, jnp.float32)

    def f(g):
        return g["total"] / jnp.maximum(g["count"], 1.0)

    return _collective_ratio({"total": total, "count": count}, f, axis_name)


def weighted_dice_coefficient_loss(y_true: jnp.ndarray, y_pred: jnp.ndarray,
                                   axis_name: Optional[str] = None,
                                   sample_mask: Optional[jnp.ndarray] = None
                                   ) -> jnp.ndarray:
    """Reference: metrics.py::weighted_dice_coefficient_loss (negative weighted dice)."""
    return -weighted_dice_coefficient(y_true, y_pred, axis_name=axis_name,
                                      sample_mask=sample_mask)


def label_wise_dice_coefficient(y_true: jnp.ndarray, y_pred: jnp.ndarray,
                                label_index: int) -> jnp.ndarray:
    """Dice of one label channel (channels-first axis 1).

    Reference: metrics.py::label_wise_dice_coefficient.
    """
    return dice_coefficient(y_true[:, label_index], y_pred[:, label_index])


def get_label_dice_coefficient_function(label_index: int):
    """Closure with a stable ``__name__`` for logging.

    Reference: metrics.py::get_label_dice_coefficient_function (the name is
    part of the training.log CSV header surface).
    """

    def f(y_true, y_pred):
        return label_wise_dice_coefficient(y_true, y_pred, label_index)

    f.__name__ = f"label_{label_index}_dice_coef"
    return f


def hard_dice(y_true, y_pred) -> float:
    """Hard (binary) Dice used by evaluate.py — numpy-compatible semantics.

    Reference: evaluate.py::dice_coefficient (hard masks, no smoothing;
    empty-vs-empty is defined as 1.0 here to keep per-case CSVs finite).
    """
    import numpy as np

    t = np.asarray(y_true).astype(bool)
    p = np.asarray(y_pred).astype(bool)
    denom = t.sum() + p.sum()
    if denom == 0:
        return 1.0
    return float(2.0 * np.logical_and(t, p).sum() / denom)
