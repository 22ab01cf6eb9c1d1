"""Isensee 2017 (BRATS) residual U-Net with deep supervision.

Graph parity with the reference (reference: unet3d/model/isensee2017.py::
isensee2017_model, create_context_module, create_up_sampling_module,
create_localization_module):

- Encoder, per level L in [0, depth): ConvBlock(f_L) (stride 2 for L>0 —
  strided-conv downsampling, no pooling) → context module (ConvBlock →
  SpatialDropout3D(rate) → ConvBlock) → residual Add with the in-conv.
  f_L = n_base_filters * 2^L. All conv blocks are InstanceNorm + LeakyReLU.
- Decoder, per level L in [depth-2, 0]: up-sampling module (nearest
  UpSampling3D(2) → ConvBlock(f_L)), concat with level-L encoder output,
  localization module (ConvBlock 3^3 → ConvBlock 1^3).
- Deep supervision: 1^3 Conv(n_labels) segmentation heads at the last
  ``n_segmentation_levels`` decoder levels; summed coarsest-to-finest with
  UpSampling3D(2) between, final sigmoid/softmax.
- Trained with the weighted multi-class dice loss (ops/dice.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp

from fetal_mri_segmentation_tpu.models import layers as _layers
from fetal_mri_segmentation_tpu.models.layers import (
    ConvBlock, conv, conv_params, head_activation, spatial_dropout_3d,
    upsample_nearest)
from fetal_mri_segmentation_tpu.models.module import Model, Scope


@dataclasses.dataclass(frozen=True)
class Isensee2017(Model):
    """Reference: unet3d/model/isensee2017.py::isensee2017_model (defaults mirrored)."""
    n_labels: int = 1
    depth: int = 5
    n_base_filters: int = 16
    dropout_rate: float = 0.3
    n_segmentation_levels: int = 3
    activation_name: str = "sigmoid"
    dtype: Any = jnp.bfloat16
    fuse_decoder: bool = True  # collapse upsample+conv in the up-sampling
                               # module (exact math; layers.up_concat_conv3x3)
    fold_level0: Any = "auto"  # space-to-depth at the full-resolution level
        # (ops/fold.py; folded InstanceNorm keeps the math exact). Same
        # semantics as UNet3D.fold_level0: "auto" folds batch-1 programs
        # where layers.FOLD_BACKENDS allows it, "off"/None disables,
        # explicit tuple forces.
    fold_formulation: str = "dense"

    def _block(self, scope, f, name, fold=None, form="dense", **kw):
        block = ConvBlock(f, instance_normalization=True,
                          activation="leaky_relu", dtype=self.dtype,
                          fold_factors=fold, fold_formulation=form, **kw)
        return lambda x: block(scope.child(name), x)

    def forward(self, scope: Scope, x: jnp.ndarray, *, train: bool = False,
                logits: bool = False) -> jnp.ndarray:
        """x: (B, D, H, W, C) → (B, D, H, W, n_labels)."""
        if self.n_segmentation_levels > self.depth - 1:
            raise ValueError(
                f"n_segmentation_levels={self.n_segmentation_levels} needs "
                f"depth >= n_segmentation_levels+1 (got depth={self.depth}); "
                f"deep-supervision heads sit on decoder levels, of which "
                f"there are depth-1")
        from fetal_mri_segmentation_tpu.ops.fold import (
            concat_folded, conv1_folded, fold, unfold,
            upsample_nearest_folded)

        # shared gate logic (batch-1 / backend / divisibility) lives in
        # layers.resolve_fold; depth>=2 is the only isensee-specific gate
        ff, form = _layers.resolve_fold(
            self.fold_level0, self.fold_formulation, x,
            extra_gates=self.depth >= 2)
        F = ff[0] * ff[1] * ff[2] if ff else 1

        x = x.astype(self.dtype)
        if ff is not None:
            x = fold(x, ff)  # level 0 runs in folded layout (ops/fold.py)
        level_outputs = []
        level_filters = []
        for level in range(self.depth):
            f = self.n_base_filters * (2 ** level)
            level_filters.append(f)
            strides = (1, 1, 1) if level == 0 else (2, 2, 2)
            folded = ff is not None and level == 0
            # level 0 blocks run folded; enc1's stride-2 entry CONSUMES the
            # folded level-0 output and emits the unfolded half-res grid
            # (ops/fold.py::conv3_folded_stride2)
            entry_fold = ff if (level == 0 or (level == 1 and ff is not None)
                                ) else None
            in_conv = self._block(scope, f, f"enc{level}_in",
                                  strides=strides, fold=entry_fold,
                                  form=form)(x)
            h = self._block(scope, f, f"enc{level}_ctx1",
                            fold=ff if folded else None, form=form)(in_conv)
            if train and self.dropout_rate > 0:
                rng = scope.make_rng("dropout")
                h = spatial_dropout_3d(rng, h, self.dropout_rate,
                                       group=F if folded else 1)
            h = self._block(scope, f, f"enc{level}_ctx2",
                            fold=ff if folded else None, form=form)(h)
            x = in_conv + h
            level_outputs.append(x)  # level 0's output stays folded

        segmentation_layers = []
        for level in range(self.depth - 2, -1, -1):
            f = level_filters[level]
            folded = ff is not None and level == 0
            fold_here = ff if folded else None
            # up-sampling module (UpSampling3D + conv block; the fused form
            # computes the conv at the coarse resolution — exact math).
            # Training uses the upsample-then-conv form, whose backward
            # avoids the lhs-dilated conv gradient. Both branches read the
            # identical dec{level}_up/conv/{kernel,bias} param tree, so
            # checkpoints and the Keras interop are form-agnostic.
            if self.fuse_decoder and not train:
                x = self._block(scope, f, f"dec{level}_up", fold=fold_here,
                                form=form)((x, None))
            else:
                x = (upsample_nearest_folded(x, ff) if folded
                     else upsample_nearest(x, (2, 2, 2)))
                x = self._block(scope, f, f"dec{level}_up", fold=fold_here,
                                form=form)(x)
            x = (concat_folded(level_outputs[level], x, ff) if folded
                 else jnp.concatenate([level_outputs[level], x], axis=-1))
            # localization module
            x = self._block(scope, f, f"dec{level}_loc1", fold=fold_here,
                            form=form)(x)
            x = self._block(scope, f, f"dec{level}_loc2",
                            kernel_size=(1, 1, 1), fold=fold_here,
                            form=form)(x)
            if level < self.n_segmentation_levels:
                head = scope.child(f"seg{level}")
                if folded:
                    # per-sub-voxel 1^3 seg head (same param tree;
                    # ops/fold.py::conv1_folded)
                    kernel, bias = conv_params(head, (1, 1, 1),
                                               x.shape[-1] // F,
                                               self.n_labels)
                    seg = conv1_folded(x.astype(jnp.float32), kernel,
                                       bias, ff)
                else:
                    seg = conv(head, x.astype(jnp.float32), self.n_labels,
                               (1, 1, 1))
                segmentation_layers.insert(0, seg)

        out = None
        for level in reversed(range(self.n_segmentation_levels)):
            seg = segmentation_layers[level]
            if level == 0 and ff is not None and out is not None:
                # the accumulated coarser sum arrives UNFOLDED at half
                # resolution (its level-1 upsample was deferred below);
                # its x2 upsample is emitted folded to match seg0's
                # layout (exact: the same voxel values either way)
                out = upsample_nearest_folded(out, ff) + seg
            else:
                out = seg if out is None else out + seg
            if level > 0 and not (level == 1 and ff is not None):
                out = upsample_nearest(out, (2, 2, 2))

        if ff is not None:
            out = unfold(out, ff)
        if logits:
            return out
        return head_activation(out, self.activation_name)
