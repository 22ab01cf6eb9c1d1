"""Experiment configuration.

The reference declares its experiment config as an in-script Python dict in
each train script (reference: train.py / train_fetal.py ``config`` dict; see
SURVEY.md section 5.6 for the canonical key list). We keep those exact key
names as the compatibility surface, expose them as a dataclass, and support
JSON round-tripping so configs are artifacts rather than code.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple


def _tup(x) -> Optional[Tuple[int, ...]]:
    return None if x is None else tuple(int(v) for v in x)


@dataclass
class Config:
    """Full experiment config, key names matching the reference train scripts.

    Reference keys (train.py::config): image_shape, patch_shape, labels,
    n_labels, all_modalities, training_modalities, nb_channels, input_shape,
    truth_channel, deconvolution, batch_size, validation_batch_size, n_epochs,
    patience, early_stop, initial_learning_rate, learning_rate_drop,
    validation_split, flip, permute, distort, augment,
    validation_patch_overlap, training_patch_start_offset, skip_blank,
    data_file, model_file, training_file, validation_file, overwrite.
    """

    # --- geometry -----------------------------------------------------------
    image_shape: Tuple[int, int, int] = (144, 144, 144)
    patch_shape: Optional[Tuple[int, int, int]] = (64, 64, 64)
    labels: Tuple[int, ...] = (1,)
    n_labels: int = 1
    all_modalities: Tuple[str, ...] = ("volume",)
    training_modalities: Optional[Tuple[str, ...]] = None  # default: all
    truth_channel: int = 1  # index of the truth "modality" slot (metadata only)

    # --- model --------------------------------------------------------------
    model_name: str = "unet"  # "unet" | "isensee"
    depth: Optional[int] = None  # None = model default (unet: 4, isensee: 5);
                                 # an explicit value is always honored as-is
    n_base_filters: int = 32
    deconvolution: bool = False
    batch_normalization: bool = False
    instance_normalization: bool = False
    activation_name: str = "sigmoid"  # "sigmoid" | "softmax"
    dropout_rate: float = 0.3  # isensee SpatialDropout3D rate
    n_segmentation_levels: int = 3  # isensee deep-supervision heads
    include_label_wise_dice_coefficients: bool = False  # per-label metrics
    compute_dtype: str = "bfloat16"  # bf16 compute, fp32 params
    fold_level0: Any = "auto"  # space-to-depth at the full-resolution
        # level (both model families): exact math, same checkpoint layout
        # (ops/fold.py). "auto" (default) folds BATCH-1 programs on the
        # backends where it is a measured win (models/layers.py
        # FOLD_BACKENDS) when the gates pass (unet: norm-free level-0 +
        # fused decoder; isensee: folded InstanceNorm twin; even folded
        # axes); "off"/None disables; an explicit [f1,f2,f3] (factors in
        # {1,2}) forces it.
    fold_formulation: str = "dense"  # "parity" | "parity_batched" | "dense"
    remat: bool = False  # rematerialize the forward in the backward pass
                         # (trade FLOPs for device memory -- enables
                         # bigger patches)

    # --- optimization -------------------------------------------------------
    batch_size: int = 6
    validation_batch_size: Optional[int] = 12
    n_epochs: int = 500
    patience: int = 10  # LR-plateau patience (epochs)
    early_stop: int = 50  # early-stopping patience (epochs)
    initial_learning_rate: float = 5e-4
    learning_rate_drop: float = 0.5
    learning_rate_epochs: Optional[int] = None  # if set: step decay, else plateau
    validation_split: float = 0.8

    # --- augmentation -------------------------------------------------------
    augment: bool = True
    flip: bool = True  # random axis flips
    permute: bool = True  # one of the 48 cube symmetries (cubic patches only)
    distort: Optional[float] = None  # scale-deviation factor, e.g. 0.25
    contrast: Optional[float] = 0.1  # fetal-fork intensity augmentation factor
    rotate: Optional[float] = None  # max rotation angle in degrees, e.g. 15

    # --- patch sampling -----------------------------------------------------
    validation_patch_overlap: int = 16
    training_patch_start_offset: Optional[Tuple[int, int, int]] = (16, 16, 16)
    skip_blank: bool = True
    gaussian_recon_sigma_scale: float = 0.125  # Gaussian importance-map sigma
                                               # as a fraction of patch size
    device_case_cache: str = "auto"  # "auto" | "on" | "off": keep all cases
                                     # device-resident and gather patches on
                                     # device (single-device and pure-DP
                                     # training); auto falls back to host
                                     # staging when the padded stacks exceed
                                     # the device budget or the mesh is
                                     # spatial/hybrid

    # --- normalization ------------------------------------------------------
    normalization: str = "per_volume"  # "per_volume" | "global" | "windowed"

    # --- files --------------------------------------------------------------
    data_dir: Optional[str] = None  # per-case NIfTI folders for the builder
                                    # (train.py --data-dir overrides; default
                                    # "data" when neither is given)
    data_file: str = "fetal_data.h5"
    model_file: str = "model.ckpt"
    training_file: str = "training_ids.pkl"
    validation_file: str = "validation_ids.pkl"
    training_log: str = "training.log"
    overwrite: bool = False

    # --- parallelism (net-new; reference is single-device) -------------------
    num_devices: Optional[int] = None  # None = all visible devices (DP mesh)
    spatial_devices: int = 1  # >1: hybrid data x spatial mesh — volume depth
                              # sharded with XLA halo exchange (whole-volume
                              # training beyond one card's memory)

    # -------------------------------------------------------------------------
    def __post_init__(self):
        if self.depth is None:
            # Reference defaults: unet_model_3d(depth=4),
            # isensee2017_model(depth=5). Resolved here so an explicitly
            # configured depth is never reinterpreted downstream.
            self.depth = 5 if self.model_name == "isensee" else 4
        self.image_shape = _tup(self.image_shape)
        self.patch_shape = _tup(self.patch_shape)
        self.labels = _tup(self.labels)
        if self.labels is not None and len(self.labels) != self.n_labels:
            # A mismatch would make the multi-class label map silently wrong
            # (jnp.take clips argmax indices into a too-short label table).
            raise ValueError(
                f"len(labels)={len(self.labels)} must equal "
                f"n_labels={self.n_labels}; got labels={self.labels}")
        self.all_modalities = tuple(self.all_modalities)
        if self.training_modalities is None:
            self.training_modalities = self.all_modalities
        else:
            self.training_modalities = tuple(self.training_modalities)
        if self.training_patch_start_offset is not None:
            self.training_patch_start_offset = _tup(self.training_patch_start_offset)
        if self.device_case_cache not in ("auto", "on", "off"):
            # a typo like "On"/"true" would otherwise behave as an
            # undocumented fourth mode (cache attempted, budget check AND
            # auto-fallback both skipped)
            raise ValueError(
                f"device_case_cache={self.device_case_cache!r} — must be "
                "'auto', 'on' or 'off'")
        # fail at construction, not epochs later inside the pipeline:
        if self.model_name not in ("unet", "isensee"):
            raise ValueError(f"model_name={self.model_name!r} — must be "
                             "'unet' or 'isensee'")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype={self.compute_dtype!r} — must "
                             "be 'float32' or 'bfloat16'")
        if self.fold_level0 not in (None, "auto", "off"):
            try:
                f = tuple(int(v) for v in self.fold_level0)
            except (TypeError, ValueError):
                f = ()
            if len(f) != 3 or any(v not in (1, 2) for v in f):
                raise ValueError(f"fold_level0={self.fold_level0!r} — must "
                                 "be 'auto', 'off' or three per-axis "
                                 "factors in {1, 2}")
            self.fold_level0 = f
        if self.fold_formulation not in ("parity", "parity_batched",
                                         "dense"):
            raise ValueError(
                f"fold_formulation={self.fold_formulation!r} — must be "
                "'parity', 'parity_batched' or 'dense'")
        if self.normalization not in ("per_volume", "global", "windowed",
                                      "none", None):
            raise ValueError(
                f"normalization={self.normalization!r} — must be "
                "'per_volume', 'global', 'windowed' or 'none' "
                "(normalize_case semantics, data/normalize.py)")
        if self.batch_size < 1 or (self.validation_batch_size is not None
                                   and self.validation_batch_size < 1):
            raise ValueError(
                f"batch_size={self.batch_size} / validation_batch_size="
                f"{self.validation_batch_size} must be >= 1")
        if self.initial_learning_rate <= 0:
            raise ValueError(f"initial_learning_rate="
                             f"{self.initial_learning_rate} must be > 0")
        # NOTE: patch geometry is deliberately NOT validated here —
        # patch_shape larger than image_shape is legal (one centered
        # zero-padded patch, reference grid semantics), and the default
        # validation_patch_overlap (16) may exceed a small test patch;
        # the grid math raises a clear error at first use for genuinely
        # impossible grids (ops/patches.py::compute_patch_indices)

    @property
    def nb_channels(self) -> int:
        return len(self.training_modalities)

    @property
    def input_shape(self) -> Tuple[int, ...]:
        """Channels-first single-example shape, reference-compatible."""
        shape = self.patch_shape if self.patch_shape is not None else self.image_shape
        return (self.nb_channels,) + tuple(shape)

    # --- JSON round-trip ----------------------------------------------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["nb_channels"] = self.nb_channels
        d["input_shape"] = list(self.input_shape)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)}
        # derived keys that to_dict() adds for reference-surface parity;
        # "_"-prefixed keys are JSON comments (e.g. configs/*.json)
        derived = {"nb_channels", "input_shape"}
        unknown = sorted(k for k in d if k not in known | derived
                         and not k.startswith("_"))
        if unknown:
            # a silently dropped key means the experiment runs with a
            # DEFAULT the user thinks they overrode (e.g. "normalize" vs
            # the reference key "normalization") — warn, don't error, so
            # forward-compatible configs still load.
            import difflib
            import warnings
            hints = []
            for k in unknown:
                close = difflib.get_close_matches(k, known, n=1)
                hints.append(f"{k!r}"
                             + (f" (did you mean {close[0]!r}?)"
                                if close else ""))
            warnings.warn("Config: ignoring unknown keys: "
                          + ", ".join(hints), stacklevel=2)
        return cls(**{k: v for k, v in d.items() if k in known})

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=str)

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))
