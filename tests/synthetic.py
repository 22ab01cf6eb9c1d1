"""Synthetic ellipsoid "fetal brain" dataset generator for tests & smoke runs.

SURVEY.md section 4: golden-file and integration tests run on tiny synthetic
NIfTI cases (random ellipsoids as truth, noisy intensity as image).
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from fetal_mri_segmentation_tpu.utils.nifti import save_nifti


def make_ellipsoid_case(shape=(24, 24, 24), seed=0,
                        noise: float = 0.3) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    center = np.array(shape) / 2 + rng.uniform(-3, 3, 3)
    radii = np.array(shape) * rng.uniform(0.2, 0.35, 3)
    grids = np.mgrid[: shape[0], : shape[1], : shape[2]]
    d = sum(((g - c) / r) ** 2 for g, c, r in zip(grids, center, radii))
    truth = (d < 1).astype(np.uint8)
    vol = truth * 2.0 + rng.normal(0, noise, shape)
    return vol.astype(np.float32), truth


def make_multiclass_case(shape=(36, 36, 36), seed=0, noise: float = 0.25
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Three DISJOINT ellipsoid structures with distinct intensities along
    the volume diagonal: labels 1, 2 and 4 — non-contiguous label values
    exercise the argmax→labels[i] mapping (reference: prediction.py::
    get_prediction_labels).

    Why disjoint and ~1000+ voxels each: the reference's multi-class loss
    (per-channel soft dice, sigmoid or softmax) has saturation pathologies
    the synthetic task must not trip for an end-to-end quality demo —
    a channel whose probability saturates early (a shell channel claiming
    a nested bright core, or a softmax channel underflowing on a tiny
    structure) gets ~zero dice gradient and never recovers. Measured in
    round 3; see docs/PARITY.md "multi-class" notes.
    """
    rng = np.random.default_rng(seed)
    grids = np.mgrid[: shape[0], : shape[1], : shape[2]]

    def ellipsoid(center, radii):
        return sum(((g - c) / r) ** 2
                   for g, c, r in zip(grids, center, radii)) < 1

    truth = np.zeros(shape, np.uint8)
    for lab, frac in ((1, 0.24), (2, 0.52), (4, 0.78)):
        center = np.array(shape) * frac + rng.uniform(-1.5, 1.5, 3)
        radii = np.array(shape) * rng.uniform(0.16, 0.20, 3)
        truth[ellipsoid(center, radii) & (truth == 0)] = lab
    vol = ((truth == 1) * 1.0 + (truth == 2) * 3.0 + (truth == 4) * 2.0
           + rng.normal(0, noise, shape))
    return vol.astype(np.float32), truth


def write_multiclass_dataset(directory: str, n_cases: int = 24,
                             shape=(40, 40, 40)) -> List[List[str]]:
    """Per-case [volume, truth] NIfTIs with the 3-structure label maps."""
    os.makedirs(directory, exist_ok=True)
    training_files = []
    for i in range(n_cases):
        vol, truth = make_multiclass_case(shape=shape, seed=i)
        case_dir = os.path.join(directory, f"case_{i}")
        os.makedirs(case_dir, exist_ok=True)
        affine = np.diag([1.0, 1.0, 2.0, 1.0])
        affine[:3, 3] = (-12, -12, -24)
        pv = os.path.join(case_dir, "volume.nii.gz")
        pt = os.path.join(case_dir, "truth.nii.gz")
        save_nifti(vol, pv, affine=affine)
        save_nifti(truth, pt, affine=affine)
        training_files.append([pv, pt])
    return training_files


def write_synthetic_dataset(directory: str, n_cases: int = 4,
                            shape=(24, 24, 24),
                            modalities: Sequence[str] = ("volume",)
                            ) -> List[List[str]]:
    """Write per-case NIfTI files; returns the [mod..., truth] path lists."""
    os.makedirs(directory, exist_ok=True)
    training_files = []
    for i in range(n_cases):
        vol, truth = make_ellipsoid_case(shape=shape, seed=i)
        case_dir = os.path.join(directory, f"case_{i}")
        os.makedirs(case_dir, exist_ok=True)
        affine = np.diag([1.0, 1.0, 2.0, 1.0])  # anisotropic like fetal MRI
        affine[:3, 3] = (-12, -12, -24)
        files = []
        for m in modalities:
            p = os.path.join(case_dir, f"{m}.nii.gz")
            save_nifti(vol, p, affine=affine)
            files.append(p)
        pt = os.path.join(case_dir, "truth.nii.gz")
        save_nifti(truth, pt, affine=affine)
        files.append(pt)
        training_files.append(files)
    return training_files


def decoder_level_case(B=2, d=4, CU=16, CS=8, CO=8, seed=0):
    """Random (x_deep, skip, kernel, bias) for the fused decoder-level ops
    (tests/test_dilated_decoder.py)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(B, d, d, d, CU)), jnp.float32)
    s = jnp.asarray(rng.normal(size=(B, 2 * d, 2 * d, 2 * d, CS)),
                    jnp.float32)
    k = jnp.asarray(rng.normal(size=(3, 3, 3, CU + CS, CO)) * 0.1,
                    jnp.float32)
    b = jnp.asarray(rng.normal(size=(CO,)), jnp.float32)
    return x, s, k, b


def synthetic_data_file(n_cases: int = 4, shape=(24, 24, 24), seed: int = 0):
    """An in-memory dataset (`DataFile.from_arrays`, no HDF5 file) of
    ellipsoid cases, z-scored per volume as the builder's default does."""
    from fetal_mri_segmentation_tpu.data import DataFile
    from fetal_mri_segmentation_tpu.data.normalize import (
        normalize_data_storage_per_volume)

    cases = [make_ellipsoid_case(shape=shape, seed=seed + i)
             for i in range(n_cases)]
    data = np.stack([v for v, _ in cases])[:, None]
    truth = np.stack([t for _, t in cases])[:, None]
    normalize_data_storage_per_volume(data)
    affine = np.diag([1.0, 1.0, 2.0, 1.0])
    return DataFile.from_arrays(data, truth, np.tile(affine, (n_cases, 1, 1)),
                                subject_ids=[f"case_{seed + i}"
                                             for i in range(n_cases)])
