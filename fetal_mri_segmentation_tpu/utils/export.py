"""Portable model export (StableHLO) for deployment without Python model code.

Reference: the reference "deploys" by shipping the Keras ``.h5`` plus the
repo (training.py::load_old_model with custom_objects). The JAX
equivalent is a **self-contained serialized program**: `jax.export` captures
the jitted whole-volume label-map program — model graph, trained weights
(baked as constants), sliding-window reconstruction, thresholding — as one
StableHLO artifact that any later jax (or XLA runtime) can load and run with
NO dependency on this package's model classes.

    # producer (has the framework + checkpoint)
    export_predictor(model, config, variables, image_shape, "model.fetal")

    # consumer (only needs jax)
    predict = load_predictor("model.fetal")
    labels = predict(volume)  # (C, D, H, W) f32 -> integer label map
                              # (uint8; widens to uint16/uint32 when any
                              # configured label value exceeds the dtype)

The exported program is the SAME compiled path `predict.py` serves, so
outputs are identical by construction (round-trip test in
tests/test_export.py).
"""

from __future__ import annotations

import json
import struct
from typing import Optional, Sequence, Union

import numpy as np

_MAGIC = b"FETALTPU1"


def export_predictor(model, config, variables, image_shape: Sequence[int],
                     path: str, overlap: int = 16,
                     patch_batch_size: int = 27,
                     threshold: float = 0.5, tta: Union[bool, str] = False,
                     platforms: Optional[Sequence[str]] = None,
                     direct: bool = False) -> None:
    """Serialize the whole-volume label-map program with weights baked in.

    ``platforms`` defaults to ["cuda", "cpu"] so the artifact runs both on
    the GPU AND on CPU-only consumers — a single-platform export
    would refuse to execute anywhere else (the portability this module
    exists for). ``tta`` bakes symmetry averaging into the program (mirrors
    ``predict.py --tta`` / ``--tta-mode``: True/"permute" = 48 symmetries,
    "flips" = the 8-way subgroup). ``direct`` serializes the DIRECT
    whole-volume forward instead of the sliding window (mirrors
    ``predict.py --direct``: no patch grid, ~2x less device work; volume
    dims must satisfy the direct-mode divisibility guard, checked here at
    export time).
    """
    import jax
    from jax import export as jexport

    variables = jax.device_get(variables)  # bake host copies as constants
    n_ch = len(config.training_modalities)

    if direct:
        from fetal_mri_segmentation_tpu.parallel.spatial import (
            make_direct_predictor)

        predictor = make_direct_predictor(model, config, tta=tta)
        # fail at EXPORT time (curated divisibility/cubic errors), not when
        # the consumer first calls the artifact
        predictor._check_volume((n_ch,) + tuple(image_shape))

        def program(vol_cdhw):
            return predictor._labels_fn(variables, vol_cdhw, threshold)
    else:
        from fetal_mri_segmentation_tpu.inference.sliding_window import (
            SlidingWindowPredictor)

        predictor = SlidingWindowPredictor(model, config,
                                           image_shape=image_shape,
                                           overlap=overlap,
                                           patch_batch_size=patch_batch_size,
                                           tta_permute=tta)

        def program(vol_cdhw):
            return predictor._predict_labels_packed(variables, vol_cdhw,
                                                    threshold)
    spec = jax.ShapeDtypeStruct((n_ch,) + tuple(image_shape), np.float32)
    plats = list(platforms) if platforms else ["cuda", "cpu"]
    # the formulation gates (models/layers.py) answer for the targets, not
    # for the tracing host
    from fetal_mri_segmentation_tpu.models.layers import trace_for_platforms
    with trace_for_platforms(plats):
        exported = jexport.export(jax.jit(program), platforms=plats)(spec)
    meta = {
        "image_shape": list(int(s) for s in image_shape),
        "n_channels": n_ch,
        "n_labels": int(config.n_labels),
        # the EFFECTIVE label values the program emits (multi-class argmax
        # defaults to 1..n_labels when config.labels is unset)
        "labels": list(config.labels
                       or range(1, int(config.n_labels) + 1)),
        "threshold": threshold,
        "tta": tta,
        "direct": direct,
        "packed_bits": config.n_labels == 1,
        "model_name": config.model_name,
    }
    meta_blob = json.dumps(meta).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(meta_blob)))
        f.write(meta_blob)
        f.write(exported.serialize())


def load_predictor(path: str):
    """Load an exported artifact; returns ``predict(vol) -> label map``
    (unsigned integer array — uint8 unless the configured label values
    required widening to uint16/uint32 at export time).

    Needs only jax — no model classes, no checkpoint files.
    """
    from jax import export as jexport

    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a fetal-segmentation export "
                             "artifact")
        try:
            (meta_len,) = struct.unpack("<I", f.read(4))
            meta = json.loads(f.read(meta_len).decode())
            exported = jexport.deserialize(f.read())
        except (struct.error, json.JSONDecodeError, UnicodeDecodeError,
                EOFError) as e:
            # truncated/corrupt artifact behind a valid magic — keep the
            # documented ValueError contract instead of leaking parser
            # internals
            raise ValueError(
                f"{path}: truncated or corrupt export artifact "
                f"({type(e).__name__}: {e})") from e

    image_shape = tuple(meta["image_shape"])

    def predict(vol_cdhw) -> np.ndarray:
        out = np.asarray(exported.call(np.asarray(vol_cdhw, np.float32)))
        if meta["packed_bits"]:
            from fetal_mri_segmentation_tpu.utils.packing import (
                unpack_bit_mask)

            return unpack_bit_mask(out, image_shape)
        return out

    predict.meta = meta
    return predict
