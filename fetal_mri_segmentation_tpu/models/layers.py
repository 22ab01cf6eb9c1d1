"""Shared building blocks for the 3D U-Net family.

Design notes (not a Keras translation):

- Internal layout is NDHWC (channels-last), which is what XLA's GPU
  convolution emitters and cuDNN take without a relayout. The public API
  stays channels-first like the reference (Keras channels_first; see
  models/__init__.py) — the transpose happens once at the jit boundary and
  is fused by XLA.
- Params are fp32; compute dtype is configurable (bf16 default) — norm
  statistics and the loss accumulate in fp32.
- Blocks are frozen dataclasses called as ``block(scope, x, train=...)``;
  their parameters live at ``scope`` (models/module.py) under the names
  the checkpoint layout has always used (``conv/{kernel,bias}``,
  ``in/{scale,bias}``, ``bn/{scale,bias}`` + ``batch_stats`` ``bn/{mean,
  var}``, ``deconv/{kernel,bias}``).
- InstanceNorm is stateless math (per-sample, per-channel moments over
  D,H,W) — the reference needed keras-contrib for it
  (reference: unet3d/model/unet.py::create_convolution_block,
  keras_contrib InstanceNormalization).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from fetal_mri_segmentation_tpu.models.module import (
    Scope, lecun_normal, ones, zeros)

Dtype = Any
_DN = ("NDHWC", "DHWIO", "NDHWC")


def conv_params(scope: Scope, kernel_size: Tuple[int, int, int],
                in_features: int, features: int):
    """``{"kernel": (k..., Cin, Cout), "bias": (Cout,)}`` at ``scope``."""
    kernel = scope.param("kernel", tuple(kernel_size) + (in_features,
                                                         features),
                         lecun_normal)
    bias = scope.param("bias", (features,), zeros)
    return kernel, bias


def conv(scope: Scope, x: jnp.ndarray, features: int,
         kernel_size: Tuple[int, int, int] = (3, 3, 3),
         strides: Tuple[int, int, int] = (1, 1, 1),
         dtype: Dtype = jnp.float32) -> jnp.ndarray:
    """Conv3D, SAME padding, input/kernel/bias cast to ``dtype``."""
    kernel, bias = conv_params(scope, kernel_size, x.shape[-1], features)
    y = jax.lax.conv_general_dilated(
        x.astype(dtype), kernel.astype(dtype), tuple(strides), "SAME",
        dimension_numbers=_DN)
    return y + bias.astype(dtype)


def instance_norm(scope: Scope, x: jnp.ndarray, *, group: int = 1,
                  epsilon: float = 1e-3,
                  dtype: Dtype = jnp.float32) -> jnp.ndarray:
    """Per-sample, per-channel normalization over the spatial axes.

    Matches keras-contrib InstanceNormalization(axis=channel) semantics:
    learned scale/offset per channel, eps inside the sqrt.

    ``group > 1``: x is space-to-depth folded (B, d, h, w, F*C) in
    sub-voxel-major layout (ops/fold.py). Moments per ORIGINAL channel over
    (d, h, w, sub-voxel) are exactly the unfolded (D, H, W) moments (the
    fold is a permutation of the same voxels), and the (C,) params are the
    plain ones, so checkpoints interchange with the unfolded path.
    """
    b, d, h, w, fc = x.shape
    c = fc // group
    gamma = scope.param("scale", (c,), ones)
    beta = scope.param("bias", (c,), zeros)
    xf = x.astype(jnp.float32).reshape(b, d, h, w, group, c)
    mean = jnp.mean(xf, axis=(1, 2, 3, 4), keepdims=True)
    var = jnp.var(xf, axis=(1, 2, 3, 4), keepdims=True)
    y = (xf - mean) * jax.lax.rsqrt(var + epsilon)
    y = y * gamma + beta
    return y.reshape(b, d, h, w, fc).astype(dtype)


def batch_norm(scope: Scope, x: jnp.ndarray, *, train: bool,
               momentum: float = 0.99, epsilon: float = 1e-3,
               axis_name: Optional[str] = None) -> jnp.ndarray:
    """BatchNorm over (B, D, H, W) in float32 (Keras momentum/epsilon).

    Training uses the batch moments (all-reduced over ``axis_name`` under
    data parallelism: sync-BN) and records the updated running moments;
    inference uses the running moments.
    """
    c = x.shape[-1]
    scale = scope.param("scale", (c,), ones)
    bias = scope.param("bias", (c,), zeros)
    ra_mean = scope.batch_stat("mean", (c,), zeros)
    ra_var = scope.batch_stat("var", (c,), ones)
    xf = x.astype(jnp.float32)
    if train:
        axes = (0, 1, 2, 3)
        mean, mean2 = jnp.mean(xf, axes), jnp.mean(jnp.square(xf), axes)
        if axis_name is not None:
            mean, mean2 = jax.lax.pmean(jnp.stack([mean, mean2]), axis_name)
        var = jnp.maximum(0.0, mean2 - jnp.square(mean))
        if not scope.initializing:
            scope.set_batch_stat("mean", momentum * ra_mean
                                 + (1.0 - momentum) * mean)
            scope.set_batch_stat("var", momentum * ra_var
                                 + (1.0 - momentum) * var)
    else:
        mean, var = ra_mean, ra_var
    y = (xf - mean) * (jax.lax.rsqrt(var + epsilon) * scale)
    return y + bias


def activate(x: jnp.ndarray, name: str, negative_slope: float = 0.3
             ) -> jnp.ndarray:
    if name == "relu":
        return jax.nn.relu(x)
    if name == "leaky_relu":
        return jax.nn.leaky_relu(x, negative_slope)
    return x


# Backends on which the input-dilated decoder form beats the 8-parity form,
# and on which batch-1 programs fold level 0 into channels; a backend not
# listed takes the plain form. Both are set from whole-model timings
# (docs/PERF.md, "H100 bring-up"): on the H100 the dilated form loses at
# every shape (its gradient runs as a slow lhs-dilated conv) and folding
# wins nothing, so both are empty. Module-level so tests can monkeypatch
# them.
DILATED_BACKENDS: frozenset = frozenset()
FOLD_BACKENDS: frozenset = frozenset()

# the fold "auto" applies where FOLD_BACKENDS allows it: fold W into
# channels, dense-embedded kernel (ops/fold.py)
FOLD_AUTO = ((1, 1, 2), "dense")

# jax.export names GPU targets by runtime; the gates are keyed by backend
_EXPORT_PLATFORM_BACKEND = {"cuda": "gpu", "rocm": "gpu"}

# platforms a trace is for (None: the tracing host's backend) — see
# trace_for_platforms
_TRACE_PLATFORMS: Optional[Tuple[str, ...]] = None


def _gate(backends: frozenset, platform: Optional[str]) -> bool:
    if platform is None and _TRACE_PLATFORMS is not None:
        return all(_gate(backends, p) for p in _TRACE_PLATFORMS)
    platform = platform or jax.default_backend()
    return _EXPORT_PLATFORM_BACKEND.get(platform, platform) in backends


def _dilated_backend_ok(platform: Optional[str] = None) -> bool:
    """Whether the input-dilated decoder form is the measured winner on
    ``platform`` (default: the platforms being traced for)."""
    return _gate(DILATED_BACKENDS, platform)


def _fold_backend_ok(platform: Optional[str] = None) -> bool:
    """Whether "auto" space-to-depth folding is a measured win for batch-1
    programs on ``platform`` (default: the platforms being traced for)."""
    return _gate(FOLD_BACKENDS, platform)


class trace_for_platforms:
    """Context manager: trace formulation choices for ``platforms``.

    The gates read the TRACING host's backend, but a `jax.export` artifact
    runs on its target platforms. Inside this context a gate opens only
    when it is open on every target, so an artifact never carries a
    formulation that one of its targets lowers poorly (the choices are
    exact-math twins, so only speed is at stake).

    with trace_for_platforms(["cuda", "cpu"]):
        exported = jax.export(...)
    """

    def __init__(self, platforms):
        self._platforms = tuple(platforms)
        self._prev: Optional[Tuple[str, ...]] = None

    def __enter__(self):
        global _TRACE_PLATFORMS
        self._prev = _TRACE_PLATFORMS
        _TRACE_PLATFORMS = self._platforms
        return self

    def __exit__(self, *exc):
        global _TRACE_PLATFORMS
        _TRACE_PLATFORMS = self._prev
        return False


def resolve_fold(fold_level0, formulation: str, x,
                 extra_gates: bool = True):
    """Resolve a model's ``fold_level0`` setting at trace time.

    Single source for the auto gates shared by UNet3D and Isensee2017
    (models pass their family-specific conditions via ``extra_gates``):
    "auto" folds only for batch-1 programs on a backend in
    ``FOLD_BACKENDS`` with evenly divisible folded axes; None/"off"
    disable; an explicit tuple passes through.

    Returns ``(factors_or_None, formulation)``.
    """
    ff, form = fold_level0, formulation
    if ff in (None, "off"):
        ff = None
    elif ff == "auto":
        ff, form = FOLD_AUTO
        if not (extra_gates and x.shape[0] == 1 and _fold_backend_ok()
                and all(s % f == 0 for s, f in zip(x.shape[1:4], ff))):
            ff = None
    return ff, form


@dataclasses.dataclass(frozen=True)
class ConvBlock:
    """Conv3D(same) → optional BatchNorm/InstanceNorm → activation.

    Reference: unet3d/model/unet.py::create_convolution_block
    (kernel 3x3x3 default, ReLU default; Isensee variant uses
    InstanceNorm + LeakyReLU, optional stride 2).
    """
    features: int
    kernel_size: Tuple[int, int, int] = (3, 3, 3)
    strides: Tuple[int, int, int] = (1, 1, 1)
    batch_normalization: bool = False
    instance_normalization: bool = False
    activation: str = "relu"  # "relu" | "leaky_relu" | "none"
    negative_slope: float = 0.3  # Keras LeakyReLU default alpha (the
                                 # reference Isensee blocks use LeakyReLU())
    dtype: Dtype = jnp.bfloat16
    bn_axis_name: Optional[str] = None  # sync-BN: all-reduce the batch
                                        # moments over this mesh axis (DP)
    fold_factors: Optional[Tuple[int, int, int]] = None  # space-to-depth:
        # inputs/outputs live in folded layout (ops/fold.py); kernel 3x3x3
        # stride 1 only; param tree unchanged (the UNFOLDED (3,3,3,Cin,
        # Cout) kernel), so checkpoints/Keras import are unaffected.
    fold_formulation: str = "parity"

    def __call__(self, scope: Scope, x, *, train: bool = False
                 ) -> jnp.ndarray:
        if self.fold_factors is not None:
            return self._folded_path(scope, x, train=train)
        if isinstance(x, (tuple, list)):
            # fused upsample(+concat)+conv input: (x_deep, skip-or-None).
            # Same param tree as the plain path (one (3,3,3, Cin, f) kernel
            # over the concat channel order) — see up_concat_conv3x3.
            x_deep, skip = x
            cin = x_deep.shape[-1] + (skip.shape[-1] if skip is not None
                                      else 0)
            kernel, bias = conv_params(scope.child("conv"), (3, 3, 3), cin,
                                       self.features)
            # Two exact-math formulations of the same op (same params, same
            # result up to fp reassociation): the input-dilated single conv
            # where DILATED_BACKENDS says it wins (batched or training
            # programs), else the 8-parity decomposed form.
            impl = (up_concat_conv3x3_dilated
                    if (train or x_deep.shape[0] > 1) and _dilated_backend_ok()
                    else up_concat_conv3x3)
            y = impl(
                x_deep.astype(self.dtype),
                None if skip is None else skip.astype(self.dtype),
                kernel.astype(self.dtype), bias.astype(jnp.float32))
            return self._epilogue(scope, y.astype(self.dtype), train=train)
        y = conv(scope.child("conv"), x, self.features, self.kernel_size,
                 self.strides, self.dtype)
        return self._epilogue(scope, y, train=train)

    def _folded_path(self, scope: Scope, x, *, train) -> jnp.ndarray:
        """Space-to-depth variants of the conv-block ops (ops/fold.py).

        Exact reformulations on folded activations; the parameters stay in
        the reference layout. Covers: 3^3 stride-1 (enc/dec blocks), the
        fused upsample(+concat)+conv decoder input, 1^3 stride-1
        (Isensee localization tails — a per-sub-voxel matmul), 3^3
        stride-2 (Isensee's down-sampling entry; output UNFOLDED at the
        next level's natural resolution), and InstanceNorm with moments
        over (spatial x sub-voxel) per original channel. BatchNorm's
        running stats have no folded twin — still gated off.
        """
        if self.batch_normalization:
            raise ValueError("fold_factors requires norm-free conv blocks "
                             "(InstanceNorm is supported; BatchNorm is not)")
        from fetal_mri_segmentation_tpu.ops.fold import (
            conv1_folded, conv3_folded, conv3_folded_stride2,
            up_conv3_folded)
        ff = self.fold_factors
        F = ff[0] * ff[1] * ff[2]
        cscope = scope.child("conv")
        if isinstance(x, (tuple, list)):
            # fused upsample(+concat)+conv: x_deep at cell resolution
            # (unfolded channels), skip in folded layout
            if self.kernel_size != (3, 3, 3) or self.strides != (1, 1, 1):
                raise ValueError("folded fused-decoder input needs a 3x3x3 "
                                 "stride-1 block")
            x_deep, skip = x
            skip_c = 0 if skip is None else skip.shape[-1] // F
            up_ch = x_deep.shape[-1]
            kernel, bias = conv_params(cscope, (3, 3, 3), up_ch + skip_c,
                                       self.features)
            y = up_conv3_folded(x_deep.astype(self.dtype),
                                kernel[:, :, :, :up_ch, :].astype(self.dtype),
                                ff)
            if skip is not None:
                y = y + conv3_folded(skip.astype(self.dtype),
                                     kernel[:, :, :, up_ch:, :], None, ff,
                                     formulation=self.fold_formulation)
            y = y + jnp.tile(bias, F).astype(y.dtype)
        elif self.kernel_size == (1, 1, 1) and self.strides == (1, 1, 1):
            kernel, bias = conv_params(cscope, (1, 1, 1), x.shape[-1] // F,
                                       self.features)
            y = conv1_folded(x.astype(self.dtype), kernel, bias, ff)
        elif self.kernel_size == (3, 3, 3) and self.strides == (1, 1, 1):
            kernel, bias = conv_params(cscope, (3, 3, 3), x.shape[-1] // F,
                                       self.features)
            y = conv3_folded(x.astype(self.dtype), kernel, bias, ff,
                             formulation=self.fold_formulation)
        elif self.kernel_size == (3, 3, 3) and self.strides == (2, 2, 2):
            kernel, bias = conv_params(cscope, (3, 3, 3), x.shape[-1] // F,
                                       self.features)
            # output is UNFOLDED (the stride lands on the cell grid) —
            # norm/activation below see plain channels, which is exactly
            # what the next (unfolded) level expects
            y = conv3_folded_stride2(x.astype(self.dtype), kernel, bias, ff)
            return self._epilogue(scope, y.astype(self.dtype), train=train)
        else:
            raise ValueError(
                f"fold_factors supports 3x3x3 stride-1/2 and 1x1x1 blocks, "
                f"got kernel {self.kernel_size} strides {self.strides}")
        y = y.astype(self.dtype)
        if self.instance_normalization:
            y = instance_norm(scope.child("in"), y, group=F, dtype=self.dtype)
            return activate(y, self.activation, self.negative_slope)
        return self._epilogue(scope, y, train=train)

    def _epilogue(self, scope: Scope, x, *, train):
        """Optional norm + activation after the conv (any conv path)."""
        if self.batch_normalization:
            x = batch_norm(scope.child("bn"), x, train=train,
                           axis_name=self.bn_axis_name).astype(self.dtype)
        elif self.instance_normalization:
            x = instance_norm(scope.child("in"), x, dtype=self.dtype)
        return activate(x, self.activation, self.negative_slope)


def up_concat_conv3x3(x_deep: jnp.ndarray, skip: jnp.ndarray,
                      kernel: jnp.ndarray, bias: jnp.ndarray) -> jnp.ndarray:
    """conv3³(concat([upsample_nearest2(x_deep), skip])) with the upsample
    algebraically collapsed — identical math, ~2× fewer FLOPs.

    Nearest ×2 upsampling makes the 3³ conv redundant: for output parity
    r∈{0,1} per axis, the three taps hit only TWO distinct source voxels
    (floor((p+k-1)/2) with p=2a+r), so

        conv3³(up2(x)) == interleave_r( conv2³(x, Weff_r) )

    with Weff_r[j] = Σ_{k∈G(r,j)} W[k] per axis (G(0,·)={0},{1,2};
    G(1,·)={0,1},{2}). That cuts the up-half of the conv from 27 to 8 MACs
    per output — the full-resolution decoder conv is ~44% of the U-Net's
    forward FLOPs (docs/PERF.md). The skip half stays a plain SAME conv.
    The channel split follows the concat order ``[upsampled, skip]``
    (reference: unet3d/model/unet.py decoder concatenate), so the SAME
    ``(3,3,3, up_ch+skip_ch, f)`` kernel parameter serves both paths —
    checkpoints and the Keras importer are unaffected.
    """
    up_ch = x_deep.shape[-1]
    w_up = kernel[:, :, :, :up_ch, :]

    y_skip = None
    if skip is not None:  # Isensee's up-sampling module has no concat
        w_skip = kernel[:, :, :, up_ch:, :]
        y_skip = jax.lax.conv_general_dilated(
            skip, w_skip.astype(skip.dtype), (1, 1, 1), "SAME",
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))

    # per-axis tap-merge matrices: S[r][j, k] = 1 iff kernel tap k lands on
    # source offset j for output parity r
    S = jnp.asarray([[[1, 0, 0], [0, 1, 1]],
                     [[1, 1, 0], [0, 0, 1]]], kernel.dtype)
    B = x_deep.shape[0]
    d, h, w = x_deep.shape[1:4]
    co = kernel.shape[-1]
    xpad = jnp.pad(x_deep, ((0, 0), (1, 1), (1, 1), (1, 1), (0, 0)))

    outs = []
    for r1 in range(2):
        for r2 in range(2):
            for r3 in range(2):
                weff = jnp.einsum("ak,bl,cm,klmio->abcio",
                                  S[r1], S[r2], S[r3],
                                  w_up.astype(jnp.float32)).astype(x_deep.dtype)
                xs = jax.lax.slice(
                    xpad, (0, r1, r2, r3, 0),
                    (B, r1 + d + 1, r2 + h + 1, r3 + w + 1, up_ch))
                outs.append(jax.lax.conv_general_dilated(
                    xs, weff, (1, 1, 1), "VALID",
                    dimension_numbers=("NDHWC", "DHWIO", "NDHWC")))
    y_up = jnp.stack(outs, axis=1).reshape(B, 2, 2, 2, d, h, w, co)
    y_up = jnp.transpose(y_up, (0, 4, 1, 5, 2, 6, 3, 7)).reshape(
        B, 2 * d, 2 * h, 2 * w, co)
    if y_skip is not None:
        y_up = y_up + y_skip
    return y_up + bias.astype(y_up.dtype)


# Per-axis tap-spread matrix for the input-dilated formulation:
# M[a, j] = 1 iff 3³-kernel tap j contributes to 4³-kernel tap a when the
# nearest-×2 upsample is absorbed into the kernel. Row a covers output
# offset a−1 relative to 2·(source index); taps {0},{0,1},{1,2},{2} —
# exactly the transpose-expansion of up_concat_conv3x3's S matrices
# (S[0] = rows {0,2} of M, S[1] = rows {1,3}).
_DILATE_M = ((1, 0, 0), (1, 1, 0), (0, 1, 1), (0, 0, 1))


def up_concat_conv3x3_dilated(x_deep: jnp.ndarray, skip: jnp.ndarray,
                              kernel: jnp.ndarray,
                              bias: jnp.ndarray) -> jnp.ndarray:
    """Same op as :func:`up_concat_conv3x3`, as ONE input-dilated conv.

    conv3³(up_nearest2(x)) == conv4³(x, M⊗M⊗M·W, lhs_dilation=2, pad 2) —
    the upsample is absorbed into a 4³ kernel over the ×2-dilated input.
    Identical math and FLOPs (the dilated input's zeros are skipped by
    XLA's lowering, which performs the same parity split internally), but
    a 2-op graph instead of the 9-op slice/stack/transpose graph. Which
    form is faster depends on the backend's conv lowering (``DILATED_
    BACKENDS``; docs/PERF.md). Param layout identical (concat order
    ``[upsampled, skip]``): checkpoints and Keras import interoperate
    unchanged.
    """
    up_ch = x_deep.shape[-1]
    M = jnp.asarray(_DILATE_M, jnp.float32)
    w_up = kernel[:, :, :, :up_ch, :].astype(jnp.float32)
    k4 = jnp.einsum("aj,bk,cl,jklio->abcio", M, M, M,
                    w_up).astype(x_deep.dtype)
    y = jax.lax.conv_general_dilated(
        x_deep, k4, (1, 1, 1), [(2, 2)] * 3, lhs_dilation=(2, 2, 2),
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
    if skip is not None:  # Isensee's up-sampling module has no concat
        w_skip = kernel[:, :, :, up_ch:, :]
        y = y + jax.lax.conv_general_dilated(
            skip, w_skip.astype(skip.dtype), (1, 1, 1), "SAME",
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
    return y + bias.astype(y.dtype)


def up_conv(scope: Scope, x: jnp.ndarray, *, deconvolution: bool = False,
            size: Tuple[int, int, int] = (2, 2, 2),
            dtype: Dtype = jnp.bfloat16) -> jnp.ndarray:
    """Upsampling: transposed conv (kernel=stride=2) or nearest-neighbor repeat.

    Reference: unet3d/model/unet.py::get_up_convolution — Conv3DTranspose(2^3,
    strides 2) when ``deconvolution`` else UpSampling3D(2). With kernel==stride
    the transposed conv has no overlap, so Keras/XLA padding conventions agree
    exactly (output = 2x input). Params at ``scope.child("deconv")``, kernel
    ``(2, 2, 2, C, C)``.
    """
    if not deconvolution:
        return upsample_nearest(x, size)
    c = x.shape[-1]
    kernel, bias = conv_params(scope.child("deconv"), size, c, c)
    y = jax.lax.conv_transpose(x.astype(dtype), kernel.astype(dtype),
                               tuple(size), "VALID", dimension_numbers=_DN)
    return y + bias.astype(dtype)


def upsample_nearest(x: jnp.ndarray, size: Tuple[int, int, int]) -> jnp.ndarray:
    """UpSampling3D — nearest-neighbor repeat on the spatial axes (NDHWC)."""
    for ax, s in zip((1, 2, 3), size):
        if s != 1:
            x = jnp.repeat(x, s, axis=ax)
    return x


def max_pool_3d(x: jnp.ndarray, window: Tuple[int, int, int] = (2, 2, 2)
                ) -> jnp.ndarray:
    """MaxPooling3D, stride == window (reference: MaxPooling3D(pool_size))."""
    dims = (1,) + tuple(window) + (1,)
    return jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, dims, dims,
                                 "VALID")


def spatial_dropout_3d(rng: jax.Array, x: jnp.ndarray, rate: float,
                       group: int = 1) -> jnp.ndarray:
    """SpatialDropout3D: drops whole channels (broadcast over D,H,W).

    Reference: isensee2017.py::create_context_module (SpatialDropout3D(0.3),
    channels_first there; channel axis is -1 here).

    ``group > 1``: x is space-to-depth folded (sub-voxel-major, F = group);
    the mask is drawn per ORIGINAL channel and tiled across the sub-voxel
    blocks, so a dropped channel is dropped at every sub-voxel — the same
    semantics (and the same rng consumption) as the unfolded op.
    """
    keep = 1.0 - rate
    c = x.shape[-1] // group
    mask = jax.random.bernoulli(rng, keep, (x.shape[0], 1, 1, 1, c))
    if group > 1:
        mask = jnp.tile(mask, (1, 1, 1, 1, group))
    return jnp.where(mask, x / keep, 0.0).astype(x.dtype)


def head_activation(x: jnp.ndarray, name: str) -> jnp.ndarray:
    """Final activation over the channel axis (NDHWC)."""
    if name == "sigmoid":
        return jax.nn.sigmoid(x)
    if name == "softmax":
        return jax.nn.softmax(x, axis=-1)
    if name in ("none", "linear", None):
        return x
    raise ValueError(f"unknown activation {name!r}")
