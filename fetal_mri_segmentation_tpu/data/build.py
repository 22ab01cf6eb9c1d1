"""NIfTI → HDF5 dataset builder.

On-disk contract identical to the reference (reference: unet3d/data.py::
write_data_to_file, create_data_file, write_image_data_to_file,
add_data_to_storage, open_data_file):

- one HDF5 file with arrays
  ``data``   (N, n_channels, *image_shape)  float32
  ``truth``  (N, 1, *image_shape)           uint8 (configurable)
  ``affine`` (N, 4, 4)                      float64
  plus ``subject_ids`` (N,) variable-length strings when provided;
- per case: optional shared background crop across modalities+truth, resample
  to the uniform ``image_shape`` (linear for images / nearest for truth);
- optional z-score normalization pass over the stored volumes.

Implementation notes: h5py instead of PyTables; chunked per-volume with
gzip-1 compression — chunking by whole volume makes the training-time case
reads single-chunk sequential I/O, which is what the host→device prefetch
path wants. A thin `DataFile` wrapper provides the reference's PyTables-style
``.root.data[...]`` access so downstream code and user muscle memory keep
working; `DataFile.from_arrays` serves the same surface from in-memory
arrays (no HDF5 file, no h5py). h5py is imported only when an HDF5 file is
opened or written.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from fetal_mri_segmentation_tpu.utils.geometry import process_case_images
from fetal_mri_segmentation_tpu.utils.nifti import load_nifti


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "HDF5 dataset files need the h5py package, which is not "
            "installed; install h5py, or pass the arrays directly with "
            "DataFile.from_arrays") from e
    return h5py


class _ArrayStore(dict):
    """In-memory stand-in for an open h5py file: name -> numpy array."""
    filename = "<memory>"

    def close(self) -> None:
        pass


class _Root:
    """PyTables-style ``file.root.data`` facade over an h5py file.

    Datasets compressed with the blosc HDF5 filter (the REFERENCE's on-disk
    format — PyTables blosc complevel-5) are wrapped transparently in a
    chunk-decompressing view when the filter plugin is absent, so a
    migrating user's existing dataset file trains/predicts directly (see
    data/blosc_compat.py; tools/convert_reference_h5.py rewrites it into
    the native layout for full-speed reads).
    """

    def __init__(self, h5):
        self._h5 = h5
        self._wrapped = {}

    def __getattr__(self, name: str):
        try:
            dset = self._h5[name]
        except KeyError as e:
            raise AttributeError(name) from e
        if name not in self._wrapped:
            if isinstance(self._h5, _ArrayStore):
                self._wrapped[name] = dset
                return dset
            from fetal_mri_segmentation_tpu.data.blosc_compat import (
                BloscDataset, blosc_available, is_unreadable_blosc)
            wrap = (isinstance(dset, _h5py().Dataset)
                    and is_unreadable_blosc(dset))
            if wrap and not blosc_available():
                raise RuntimeError(
                    f"{self._h5.filename}:{name} is blosc-compressed "
                    f"(PyTables reference format) and neither the HDF5 "
                    f"blosc filter nor libblosc is available — convert "
                    f"the file with tools/convert_reference_h5.py on a "
                    f"machine that has libblosc")
            self._wrapped[name] = BloscDataset(dset) if wrap else dset
        return self._wrapped[name]


class DataFile:
    """Open dataset handle. Reference surface: tables.open_file(...).root.*"""

    def __init__(self, h5):
        self._h5 = h5
        self.root = _Root(h5)
        self.filename = h5.filename

    @classmethod
    def from_arrays(cls, data: np.ndarray, truth: np.ndarray,
                    affine: Optional[np.ndarray] = None,
                    subject_ids: Optional[Sequence[str]] = None
                    ) -> "DataFile":
        """The dataset contract (``data`` (N, C, *shape) float32, ``truth``
        (N, 1, *shape), ``affine`` (N, 4, 4)) from in-memory arrays."""
        n = len(data)
        store = _ArrayStore(
            data=np.asarray(data, np.float32), truth=np.asarray(truth),
            affine=(np.asarray(affine, np.float64) if affine is not None
                    else np.tile(np.eye(4), (n, 1, 1))))
        if subject_ids is not None:
            store["subject_ids"] = np.asarray(list(subject_ids), object)
        return cls(store)

    def close(self) -> None:
        self._h5.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __len__(self) -> int:
        return self._h5["data"].shape[0]


def open_data_file(filename: str, readwrite: str = "r") -> DataFile:
    """Reference: data.py::open_data_file."""
    return DataFile(_h5py().File(filename, readwrite))


def create_data_file(out_file: str, n_channels: int, n_samples: int,
                     image_shape: Sequence[int], truth_dtype=np.uint8):
    """Create the HDF5 layout (pre-sized, chunk = one volume).

    Reference: data.py::create_data_file (PyTables EArrays + blosc5; here
    fixed-size h5py datasets + gzip — same array contract).
    """
    h5py = _h5py()
    h5 = h5py.File(out_file, "w")
    image_shape = tuple(int(s) for s in image_shape)
    h5.create_dataset("data", shape=(n_samples, n_channels) + image_shape,
                      dtype=np.float32, chunks=(1, n_channels) + image_shape,
                      compression="gzip", compression_opts=1, shuffle=True)
    h5.create_dataset("truth", shape=(n_samples, 1) + image_shape,
                      dtype=truth_dtype, chunks=(1, 1) + image_shape,
                      compression="gzip", compression_opts=1, shuffle=True)
    h5.create_dataset("affine", shape=(n_samples, 4, 4), dtype=np.float64)
    return h5


def write_data_to_file(training_data_files: Sequence[Sequence[str]],
                       out_file: str,
                       image_shape: Sequence[int],
                       truth_dtype=np.uint8,
                       subject_ids: Optional[Sequence[str]] = None,
                       normalize: Optional[str] = "per_volume",
                       crop: bool = True) -> str:
    """Convert per-case NIfTI file lists ``[mod1.nii, ..., truth.nii]`` into
    one HDF5 file. Reference: data.py::write_data_to_file.

    ``normalize``: None | "per_volume" | "global" | "windowed" (see
    data/normalize.py for the semantics split — the upstream lineage uses a
    single global (mean,std), the fetal adaptation per-volume z-score).
    """
    if normalize not in (None, "per_volume", "global", "windowed"):
        # the serving-time twin (normalize.py::normalize_case) validates;
        # the builder must too — silently applying per_volume for a typo
        # like "per-volume" and PERSISTING the bogus string in attrs would
        # poison every later consumer of attrs["normalization"]
        raise ValueError(
            f"normalize={normalize!r} — must be None, 'per_volume', "
            f"'global' or 'windowed'")
    n_samples = len(training_data_files)
    n_channels = len(training_data_files[0]) - 1

    h5 = create_data_file(out_file, n_channels, n_samples, image_shape,
                          truth_dtype=truth_dtype)
    try:
        for i, case_files in enumerate(training_data_files):
            # single-read: each (gzipped) file decompressed exactly once
            # for both the shared-crop scan and the resample
            images = process_case_images(
                [load_nifti(f) for f in case_files],
                image_shape=image_shape, crop=crop)
            data = np.stack([img.get_fdata(dtype=np.float32)
                             for img in images[:-1]], axis=0)
            truth = images[-1].get_fdata(dtype=np.float32)[None].astype(truth_dtype)
            h5["data"][i] = data
            h5["truth"][i] = truth
            h5["affine"][i] = images[0].affine
        if subject_ids is not None:
            h5.create_dataset(
                "subject_ids",
                data=np.asarray([str(s) for s in subject_ids], dtype=object),
                dtype=_h5py().string_dtype())
        if normalize:
            from fetal_mri_segmentation_tpu.data.normalize import (
                normalize_data_storage, normalize_data_storage_per_volume,
                normalize_data_storage_windowed)
            if normalize == "global":
                mean, std = normalize_data_storage(h5["data"])
                # persisted so serving-time ad-hoc cases (inference/
                # predict.py::predict_case) can be shifted into the
                # TRAINING distribution rather than z-scored per-volume.
                h5.attrs["norm_mean"] = np.asarray(mean, np.float64)
                h5.attrs["norm_std"] = np.asarray(std, np.float64)
            elif normalize == "windowed":
                normalize_data_storage_windowed(h5["data"])
            else:
                normalize_data_storage_per_volume(h5["data"])
            h5.attrs["normalization"] = normalize
    finally:
        h5.close()
    return out_file
