"""Patch-grid math and overlap-add reconstruction (host/numpy reference layer).

Behavioral contract from the reference (reference: unet3d/utils/patches.py::
compute_patch_indices, get_set_of_patch_indices, get_patch_from_3d_data,
fix_out_of_bound_patch_attempt, reconstruct_from_patches):

- Patch corners form a grid with step ``patch_size - overlap``. When ``start``
  is not given, the grid is centered: ``n = ceil(shape / step)``,
  ``overflow = step*n - shape + overlap``, ``start = -ceil(overflow/2)`` —
  corners may be NEGATIVE and reads beyond the volume are zero-padded.
- Reconstruction is overlap-add: arithmetic mean over overlapping voxels
  (upstream), or Gaussian-importance-weighted mean (fetal fork / our default
  for inference).

The numpy functions here are the semantic oracle used by tests and the host
fallback; the on-device `lax.scan` reconstruction lives in
``inference/sliding_window.py`` and must agree with these.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import os

import numpy as np


def _native_enabled() -> bool:
    return os.environ.get("FETAL_NO_NATIVE", "0") != "1"


def compute_patch_indices(image_shape: Sequence[int],
                          patch_size: Sequence[int],
                          overlap: Union[int, Sequence[int]],
                          start: Optional[Union[int, Sequence[int]]] = None
                          ) -> np.ndarray:
    """Grid of patch corner indices, centered with negative-start overflow.

    Reference: patches.py::compute_patch_indices.
    """
    image_shape = np.asarray(image_shape, dtype=np.int64)
    patch_size = np.asarray(patch_size, dtype=np.int64)
    if isinstance(overlap, (int, np.integer)):
        overlap = np.full(len(image_shape), overlap, dtype=np.int64)
    else:
        overlap = np.asarray(overlap, dtype=np.int64)
    if np.any(overlap >= patch_size):
        raise ValueError(
            f"patch overlap {tuple(overlap)} must be smaller than the patch "
            f"size {tuple(patch_size)} (grid step = patch_size - overlap)")
    if start is None:
        step = patch_size - overlap
        n_patches = np.ceil(image_shape / step.astype(np.float64))
        overflow = step * n_patches - image_shape + overlap
        start = -np.ceil(overflow / 2.0).astype(np.int64)
    elif isinstance(start, (int, np.integer)):
        start = np.full(len(image_shape), start, dtype=np.int64)
    else:
        start = np.asarray(start, dtype=np.int64)
    stop = image_shape + start
    step = patch_size - overlap
    return get_set_of_patch_indices(start, stop, step)


def get_set_of_patch_indices(start: np.ndarray, stop: np.ndarray,
                             step: np.ndarray) -> np.ndarray:
    """Cartesian grid of corners via mgrid. Reference: patches.py::get_set_of_patch_indices."""
    return np.asarray(
        np.mgrid[start[0]:stop[0]:step[0],
                 start[1]:stop[1]:step[1],
                 start[2]:stop[2]:step[2]].reshape(3, -1).T,
        dtype=np.int64)


def get_random_nd_index(index_max: Sequence[int],
                        rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Random nd index in [0, index_max] inclusive. Reference: patches.py::get_random_nd_index."""
    rng = rng or np.random.default_rng()
    return np.asarray([rng.integers(0, m, endpoint=True) for m in index_max],
                      dtype=np.int64)


def get_patch_from_3d_data(data: np.ndarray, patch_shape: Sequence[int],
                           patch_index: Sequence[int]) -> np.ndarray:
    """Slice a (possibly out-of-bounds) patch; out-of-bounds reads are zero.

    ``data`` has shape ``(..., D, H, W)``; the patch indexes the last 3 axes.
    Reference: patches.py::get_patch_from_3d_data + fix_out_of_bound_patch_attempt
    (which pads the SOURCE; we pad the extracted patch — same result, no copy
    of the full volume).

    Hot path: contiguous float32 (C, D, H, W) volumes go through the native
    memcpy kernel (native/fastloader.cpp::extract_patch_f32) when the library
    is built; anything else uses the numpy path below (same semantics, tested
    equal). Set FETAL_NO_NATIVE=1 to force numpy.
    """
    if (_native_enabled() and isinstance(data, np.ndarray)
            and data.dtype == np.float32 and data.ndim in (3, 4)
            and data.flags.c_contiguous):
        from fetal_mri_segmentation_tpu.utils import native as _native

        out = _native.extract_patch(data, patch_shape, patch_index)
        if out is not None:
            return out[0] if data.ndim == 3 else out
    patch_shape = np.asarray(patch_shape, dtype=np.int64)
    patch_index = np.asarray(patch_index, dtype=np.int64)
    image_shape = np.asarray(data.shape[-3:], dtype=np.int64)

    lo = np.maximum(patch_index, 0)
    hi = np.minimum(patch_index + patch_shape, image_shape)
    pad_before = lo - patch_index
    pad_after = (patch_index + patch_shape) - hi

    sl = (...,) + tuple(slice(int(a), int(b)) for a, b in zip(lo, hi))
    patch = data[sl]
    if np.any(pad_before > 0) or np.any(pad_after > 0):
        pad = [(0, 0)] * (data.ndim - 3) + [
            (int(b), int(a)) for b, a in zip(pad_before, pad_after)]
        patch = np.pad(patch, pad, mode="constant", constant_values=0)
    return patch


def gaussian_importance_map(patch_shape: Sequence[int],
                            sigma_scale: float = 0.125,
                            dtype=np.float32) -> np.ndarray:
    """Separable Gaussian window over the patch, peak-normalized to 1.

    The fetal fork weights each predicted patch by a Gaussian importance map
    before overlap-add (reference: fetal adaptation of patches.py::
    reconstruct_from_patches; BASELINE.json config #3). A small floor keeps
    border voxels covered by a single patch well-defined.
    """
    maps = []
    for size in patch_shape:
        sigma = max(size * sigma_scale, 1e-8)
        x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
        maps.append(np.exp(-0.5 * (x / sigma) ** 2))
    w = maps[0][:, None, None] * maps[1][None, :, None] * maps[2][None, None, :]
    w = w / w.max()
    w = np.maximum(w, 1e-3 * w.max())
    return w.astype(dtype)


def reconstruct_from_patches(patches: Sequence[np.ndarray],
                             patch_indices: np.ndarray,
                             data_shape: Sequence[int],
                             default_value: float = 0.0,
                             weight_map: Optional[np.ndarray] = None
                             ) -> np.ndarray:
    """Overlap-add patches back into a volume (weighted mean over overlaps).

    ``data_shape = (C, D, H, W)``; each patch is ``(C, *patch_shape)`` with its
    corner from ``patch_indices`` (corners may be negative / beyond the edge —
    the out-of-bounds region is discarded, mirroring zero-pad extraction).

    ``weight_map=None`` → arithmetic mean (upstream semantics);
    ``weight_map=gaussian_importance_map(...)`` → Gaussian overlap-add (fetal).
    Reference: patches.py::reconstruct_from_patches.
    """
    data_shape = tuple(int(s) for s in data_shape)
    image_shape = np.asarray(data_shape[-3:], dtype=np.int64)
    acc = np.zeros(data_shape, dtype=np.float64)
    wsum = np.zeros(data_shape[-3:], dtype=np.float64)

    for patch, index in zip(patches, np.asarray(patch_indices, dtype=np.int64)):
        patch = np.asarray(patch, dtype=np.float64)
        pshape = np.asarray(patch.shape[-3:], dtype=np.int64)
        w = np.ones(tuple(pshape)) if weight_map is None else np.asarray(
            weight_map, dtype=np.float64)

        lo = np.maximum(index, 0)
        hi = np.minimum(index + pshape, image_shape)
        if np.any(hi <= lo):
            continue
        src = tuple(slice(int(a - i), int(b - i))
                    for a, b, i in zip(lo, hi, index))
        dst = tuple(slice(int(a), int(b)) for a, b in zip(lo, hi))
        acc[(...,) + dst] += patch[(...,) + src] * w[src]
        wsum[dst] += w[src]

    out = np.full(data_shape, float(default_value), dtype=np.float64)
    covered = wsum > 0
    out[..., covered] = acc[..., covered] / wsum[covered]
    return out.astype(np.float32)
