"""Device-side ingest resampling: crop on host, zoom + normalize on device.

Reference behavior: unet3d/utils/utils.py::resize → scipy.ndimage.zoom
(order 1 for images, order 0 for label maps, ``grid_mode=True``,
``mode="nearest"``) followed by normalize.py z-scoring — both host-side in
the reference (and in utils/geometry.py's host twin here). At 128³ the
order-1 zoom is a large single-core host cost per modality, which caps
serving throughput: the serve pipeline overlaps host preprocessing with
device compute, so the HOST path can become the bottleneck stage.

This module moves zoom + normalization onto the device:

- the host does only: read NIfTI, shared background crop (6 ms), pad the
  cropped volume to a SHAPE BUCKET (next multiple of 16 per axis), H2D;
- one jitted program per (bucket, out_shape, mode) — the true pre-pad
  extents enter as DYNAMIC scalars, so arbitrary scan geometries reuse a
  handful of compiled executables instead of recompiling per case (XLA
  needs static shapes; bucketing + dynamic extents is the XLA way to
  handle variable-size ingest);
- the zoom is three separable 1-D linear gathers (order-1 exact —
  clamped-edge lerp reproduces scipy's ``grid_mode=True`` +
  ``mode="nearest"`` coordinate convention ``src = (i+0.5)·(n_in/n_out)
  − 0.5``); order-0 uses scipy's ``floor(src+0.5)`` knot;
- normalization (per_volume / global / windowed — data/normalize.py
  semantics) runs on the resampled volume in fp32 on device;
- the result is a DEVICE array handed straight to
  SlidingWindowPredictor.predict_labels_async — no host round-trip.

Parity with the host path is floating-point-level, not bit-level (the
lerp reassociates vs scipy's spline evaluation); tests pin both paths to
the scipy oracle at 1e-4.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

BUCKET_STEP = 16


def bucket_shape(shape: Sequence[int], step: int = BUCKET_STEP
                 ) -> Tuple[int, ...]:
    """Round each axis up to the next multiple of ``step`` (compile-count
    bound: distinct buckets, not distinct scan geometries, cost a compile)."""
    return tuple(int(-(-int(s) // step) * step) for s in shape)


def _axis_resample(vol: jnp.ndarray, axis: int, n_true: jnp.ndarray,
                   n_out: int, order: int) -> jnp.ndarray:
    """Resample ONE spatial axis from dynamic extent ``n_true`` (within the
    padded static axis) to static ``n_out``. scipy grid_mode=True mapping."""
    nf = n_true.astype(jnp.float32)
    src = (jnp.arange(n_out, dtype=jnp.float32) + 0.5) * (nf / n_out) - 0.5
    src = jnp.clip(src, 0.0, nf - 1.0)  # mode="nearest" edge extension
    if order == 0:
        idx = jnp.floor(src + 0.5).astype(jnp.int32)  # scipy order-0 knot
        idx = jnp.clip(idx, 0, n_true - 1)
        return jnp.take(vol, idx, axis=axis, mode="clip")
    i0 = jnp.maximum(jnp.minimum(jnp.floor(src).astype(jnp.int32),
                                 n_true - 2), 0)
    w = jnp.clip(src - i0.astype(jnp.float32), 0.0, 1.0)
    shape = [1] * vol.ndim
    shape[axis] = n_out
    w = w.reshape(shape)
    x0 = jnp.take(vol, i0, axis=axis, mode="clip")
    x1 = jnp.take(vol, i0 + 1, axis=axis, mode="clip")
    return x0 * (1.0 - w) + x1 * w


def resample_3d(vol: jnp.ndarray, true_shape: jnp.ndarray,
                out_shape: Sequence[int], order: int = 1) -> jnp.ndarray:
    """(..., Dp, Hp, Wp) padded → (..., *out_shape); the last three axes are
    spatial, valid data occupying ``[:true_shape[a]]`` per axis (zero pad
    beyond — never read, indices are clamped to the true extent)."""
    for a in range(3):
        axis = vol.ndim - 3 + a
        vol = _axis_resample(vol, axis, true_shape[a], int(out_shape[a]),
                             order)
    return vol


def _normalize_dev(data: jnp.ndarray, mode: Optional[str],
                   mean: Optional[jnp.ndarray], std: Optional[jnp.ndarray],
                   lower_percentile: float, upper_percentile: float
                   ) -> jnp.ndarray:
    """Device twin of data/normalize.py::normalize_case over (C, D, H, W)."""
    if mode is None or mode == "none":
        return data
    if mode == "global":
        m = mean.reshape(-1, 1, 1, 1)
        s = std.reshape(-1, 1, 1, 1)
        s = jnp.where(s == 0, 1.0, s)
        return (data - m) / s
    if mode == "windowed":
        lo, hi = jax.vmap(lambda c: jnp.percentile(
            c, jnp.asarray([lower_percentile, upper_percentile])),
            out_axes=1)(data.reshape(data.shape[0], -1))
        data = jnp.clip(data, lo.reshape(-1, 1, 1, 1),
                        hi.reshape(-1, 1, 1, 1))
    elif mode != "per_volume":
        raise ValueError(f"unknown normalization mode: {mode!r}")
    m = data.mean(axis=(1, 2, 3), keepdims=True)
    s = data.std(axis=(1, 2, 3), keepdims=True)
    s = jnp.where(s == 0, 1.0, s)
    return (data - m) / s


class DevicePreprocessor:
    """Crop-on-host → zoom+normalize-on-device ingest for serving.

    One instance per (out_shape, normalization config); jitted programs are
    cached per input bucket. ``global`` mode needs the training dataset's
    persisted moments (same contract as normalize_case).
    """

    def __init__(self, image_shape: Sequence[int], normalization: str,
                 moments=None, lower_percentile: float = 1.0,
                 upper_percentile: float = 99.0,
                 compute_dtype=jnp.float32, transfer_dtype=jnp.float32):
        self.image_shape = tuple(int(s) for s in image_shape)
        self.normalization = normalization
        # bfloat16 halves the raw-volume H2D bytes at ~0.4% relative
        # intensity error BEFORE normalization — worthwhile on thin host
        # links where the upload dominates;
        # float32 keeps fp-level parity with the host path.
        self._transfer_dtype = transfer_dtype
        if normalization == "global":
            if moments is None:
                raise ValueError(
                    "DevicePreprocessor(normalization='global') needs the "
                    "training dataset's (mean, std)")
            self._mean = jnp.asarray(moments[0], jnp.float32)
            self._std = jnp.asarray(moments[1], jnp.float32)
            # host copies for validation (predict.py::preprocess_case):
            # reading the device arrays back per case would block the
            # pipelined serving hot loop on a D2H sync
            self._host_moments = (np.asarray(moments[0], np.float32),
                                  np.asarray(moments[1], np.float32))
        else:
            self._mean = self._std = None
            self._host_moments = None
        self._lo, self._hi = float(lower_percentile), float(upper_percentile)
        self._dtype = compute_dtype
        self._programs = {}

    def _program(self, bucket: Tuple[int, ...]):
        fn = self._programs.get(bucket)
        if fn is None:
            mode, lo, hi, dtype = (self.normalization, self._lo, self._hi,
                                   self._dtype)
            out_shape = self.image_shape

            @jax.jit
            def run(padded, true_shape, mean, std):
                v = resample_3d(padded.astype(jnp.float32), true_shape,
                                out_shape, order=1)
                v = _normalize_dev(v, mode, mean, std, lo, hi)
                # predictor staging is a no-op for device arrays; pre-cast
                # here so the H2D-free handoff also skips the cast program
                return v.astype(dtype)

            fn = self._programs[bucket] = run
        return fn

    def __call__(self, arrays: Sequence[np.ndarray]) -> jax.Array:
        """list of C cropped (d, h, w) float32 volumes (one per modality,
        equal shapes) → normalized (C, *image_shape) DEVICE array."""
        true = np.asarray(arrays[0].shape, np.int32)
        bucket = bucket_shape(true)
        if self._transfer_dtype == jnp.bfloat16:
            import ml_dtypes
            np_dtype = ml_dtypes.bfloat16
        else:
            np_dtype = np.dtype(self._transfer_dtype)
        stack = np.zeros((len(arrays),) + bucket, np_dtype)
        for c, a in enumerate(arrays):
            if a.shape != arrays[0].shape:
                raise ValueError("modalities must share the crop shape: "
                                 f"{a.shape} vs {arrays[0].shape}")
            stack[c, :true[0], :true[1], :true[2]] = a.astype(np_dtype)
        return self._program(bucket)(
            jnp.asarray(stack), jnp.asarray(true), self._mean, self._std)
