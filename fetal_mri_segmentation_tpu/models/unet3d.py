"""Plain 3D U-Net (encoder–decoder with skip concatenation).

Graph parity with the reference (reference: unet3d/model/unet.py::
unet_model_3d, create_convolution_block, get_up_convolution):

- Encoder, per level L in [0, depth): ConvBlock(n_base * 2^L) →
  ConvBlock(n_base * 2^L * 2); MaxPool3D(2) between levels (none after the
  bottom level).
- Decoder, per level L in [depth-2, 0]: up-convolution (transposed conv or
  nearest upsample), concat with the level-L skip on the channel axis, then
  two ConvBlocks with the skip's channel count.
- Head: Conv3D(n_labels, 1x1x1) → sigmoid (or softmax).

Deltas from the reference: NDHWC layout, bf16 compute / fp32 params, fp32
head.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax.numpy as jnp

from fetal_mri_segmentation_tpu.models import layers as _layers
from fetal_mri_segmentation_tpu.models.layers import (
    ConvBlock, conv, conv_params, head_activation, max_pool_3d, up_conv)
from fetal_mri_segmentation_tpu.models.module import Model, Scope


@dataclasses.dataclass(frozen=True)
class UNet3D(Model):
    """Reference: unet3d/model/unet.py::unet_model_3d (defaults mirrored)."""
    n_labels: int = 1
    depth: int = 4
    n_base_filters: int = 32
    pool_size: Tuple[int, int, int] = (2, 2, 2)
    deconvolution: bool = False
    batch_normalization: bool = False
    instance_normalization: bool = False
    activation_name: str = "sigmoid"
    dtype: Any = jnp.bfloat16
    bn_axis_name: Any = None  # sync-BN mesh axis under data parallelism
    fuse_decoder: bool = True  # collapse upsample+concat+conv (exact math,
                               # 27->8 taps on the up half; docs/PERF.md)
    fold_level0: Any = "auto"  # space-to-depth at the full-resolution
        # level: fold per-axis factors into channels (ops/fold.py; exact
        # math, reference param tree). "auto" (default): layers.FOLD_AUTO
        # where layers.FOLD_BACKENDS allows it and the gates pass
        # (norm-free, fused decoder, depth>=2, even folded axes, batch 1),
        # plain otherwise. None/"off" disables; an explicit (f1,f2,f3)
        # tuple forces it (raising when a gate fails).
    fold_formulation: str = "dense"

    def _conv_block(self, f, fold=None, form="dense"):
        """fold: RESOLVED fold factors (a tuple) or None — "auto" has
        already been resolved by forward."""
        return ConvBlock(f, batch_normalization=self.batch_normalization,
                         instance_normalization=self.instance_normalization,
                         dtype=self.dtype, bn_axis_name=self.bn_axis_name,
                         fold_factors=fold, fold_formulation=form)

    def forward(self, scope: Scope, x: jnp.ndarray, *, train: bool = False,
                logits: bool = False) -> jnp.ndarray:
        """x: (B, D, H, W, C) → (B, D, H, W, n_labels)."""
        from fetal_mri_segmentation_tpu.ops.fold import (
            conv1_folded, fold, pool_folded, unfold)

        fuse = (self.fuse_decoder and not self.deconvolution
                and self.pool_size == (2, 2, 2))
        has_norm = self.batch_normalization or self.instance_normalization
        # shared gate logic (batch-1 / backend / divisibility) lives in
        # layers.resolve_fold; only the unet-specific conditions are here
        ff, form = _layers.resolve_fold(
            self.fold_level0, self.fold_formulation, x,
            extra_gates=fuse and self.depth >= 2 and not has_norm)
        if ff is not None and (not fuse or self.depth < 2):
            raise ValueError("fold_level0 requires the fused decoder path "
                             "(no deconvolution, pool (2,2,2)) and depth>=2")
        x = x.astype(self.dtype)
        if ff is not None:
            x = fold(x, ff)  # level 0 runs in folded layout (ops/fold.py)
        skips = []
        for level in range(self.depth):
            f = self.n_base_filters * (2 ** level)
            folded = ff if level == 0 else None
            x = self._conv_block(f, fold=folded, form=form)(
                scope.child(f"enc{level}_conv1"), x, train=train)
            x = self._conv_block(f * 2, fold=folded, form=form)(
                scope.child(f"enc{level}_conv2"), x, train=train)
            if level < self.depth - 1:
                skips.append(x)  # level 0's skip stays folded
                x = (pool_folded(x, ff) if folded
                     else max_pool_3d(x, self.pool_size))

        for level in range(self.depth - 2, -1, -1):
            skip = skips[level]
            folded = ff if level == 0 else None
            F = ff[0] * ff[1] * ff[2] if folded else 1
            f = skip.shape[-1] // F
            if fuse:
                # upsample_nearest + concat + conv collapsed into one op
                # (identical math and param tree; see
                # layers.up_concat_conv3x3 / ops.fold.up_conv3_folded)
                x = self._conv_block(f, fold=folded, form=form)(
                    scope.child(f"dec{level}_conv1"), (x, skip), train=train)
            else:
                x = up_conv(scope.child(f"dec{level}_up"), x,
                            deconvolution=self.deconvolution,
                            size=self.pool_size, dtype=self.dtype)
                x = jnp.concatenate([x, skip], axis=-1)
                x = self._conv_block(f)(scope.child(f"dec{level}_conv1"), x,
                                        train=train)
            x = self._conv_block(f, fold=folded, form=form)(
                scope.child(f"dec{level}_conv2"), x, train=train)

        head = scope.child("head")
        if ff is not None:
            # folded 1^3 head: per-sub-voxel matmul against the SAME
            # (1,1,1,C,n) kernel (ops/fold.py::conv1_folded), activation
            # per sub-voxel, then unfold
            F = ff[0] * ff[1] * ff[2]
            kernel, bias = conv_params(head, (1, 1, 1), x.shape[-1] // F,
                                       self.n_labels)
            y = conv1_folded(x.astype(jnp.float32), kernel, bias, ff)
            if not logits:
                b, d, h, w, _ = y.shape
                y = head_activation(
                    y.reshape(b, d, h, w, F, self.n_labels),
                    self.activation_name).reshape(b, d, h, w, -1)
            return unfold(y, ff)

        x = conv(head, x.astype(jnp.float32), self.n_labels, (1, 1, 1))
        if logits:
            return x
        return head_activation(x, self.activation_name)
