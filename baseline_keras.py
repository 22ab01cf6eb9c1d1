#!/usr/bin/env python
"""CPU-Keras reference measurement — the 10x denominator (BASELINE config #1).

The reference publishes no numbers (BASELINE.md), so this script measures an
equivalent of its training/inference hot path locally with the pip Keras/TF:
a depth-3 3D U-Net (n_base_filters=32, two convs per level, transposed-conv
decoder, sigmoid head) trained with soft-Dice (negative dice, smooth=1) via
Adam on single 64^3 patches, plus sliding-window whole-volume inference
(128^3 volume, 64^3 patches, overlap 16 -> 27 patches) with host Gaussian
overlap-add — exactly the composite that bench.py measures on the GPU.

Writes baseline_cpu_keras.json:
  {"train_step_sec": ..., "patch_infer_sec_per_patch": ...,
   "reconstruct_sec": ..., "composite_volumes_per_sec": ...}

Composite definition (shared with bench.py): one "volume-equivalent" =
8 batch-1 train steps on 64^3 patches + 1 whole-volume inference
(27 patch predictions + Gaussian overlap-add reconstruction).
"""

from __future__ import annotations

import json
import time

import numpy as np

PATCH = (64, 64, 64)
VOLUME = (128, 128, 128)
OVERLAP = 16
TRAIN_PATCHES_PER_VOLUME = 8


def build_keras_unet3d(depth=3, n_base_filters=32, input_shape=PATCH,
                       learning_rate=1e-5):
    import keras
    from keras import layers

    inp = keras.Input(shape=tuple(input_shape) + (1,))
    x = inp
    skips = []
    for level in range(depth):
        f = n_base_filters * 2 ** level
        x = layers.Conv3D(f, 3, padding="same", activation="relu")(x)
        x = layers.Conv3D(f * 2, 3, padding="same", activation="relu")(x)
        if level < depth - 1:
            skips.append(x)
            x = layers.MaxPooling3D(2)(x)
    for level in range(depth - 2, -1, -1):
        x = layers.Conv3DTranspose(x.shape[-1], 2, strides=2)(x)
        x = layers.Concatenate()([x, skips[level]])
        f = skips[level].shape[-1]
        x = layers.Conv3D(f, 3, padding="same", activation="relu")(x)
        x = layers.Conv3D(f, 3, padding="same", activation="relu")(x)
    out = layers.Conv3D(1, 1, activation="sigmoid")(x)
    model = keras.Model(inp, out)

    def dice_loss(y_true, y_pred):
        import keras.ops as K
        t = K.reshape(y_true, (-1,))
        p = K.reshape(y_pred, (-1,))
        inter = K.sum(t * p)
        return -(2.0 * inter + 1.0) / (K.sum(t) + K.sum(p) + 1.0)

    model.compile(optimizer=keras.optimizers.Adam(learning_rate),
                  loss=dice_loss)
    return model


def main(out_json="baseline_cpu_keras.json", n_train_steps=3, n_infer_reps=1):
    rng = np.random.default_rng(0)
    model = build_keras_unet3d()

    x = rng.normal(0, 1, (1,) + PATCH + (1,)).astype(np.float32)
    y = (rng.random((1,) + PATCH + (1,)) > 0.7).astype(np.float32)

    # warmup (graph build) then timed train steps
    model.train_on_batch(x, y)
    t0 = time.perf_counter()
    for _ in range(n_train_steps):
        model.train_on_batch(x, y)
    train_step_sec = (time.perf_counter() - t0) / n_train_steps

    # sliding-window inference path
    import sys, os
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fetal_mri_segmentation_tpu.ops.patches import (
        compute_patch_indices, gaussian_importance_map,
        get_patch_from_3d_data, reconstruct_from_patches)

    vol = rng.normal(0, 1, (1,) + VOLUME).astype(np.float32)
    corners = compute_patch_indices(VOLUME, PATCH, OVERLAP)
    n_patches = len(corners)
    patches = np.stack([get_patch_from_3d_data(vol, PATCH, c)[0]
                        for c in corners])[..., None]
    model.predict(patches[:1], verbose=0)  # warmup
    t0 = time.perf_counter()
    for _ in range(n_infer_reps):
        preds = model.predict(patches, batch_size=1, verbose=0)
    infer_sec = (time.perf_counter() - t0) / n_infer_reps
    patch_infer_sec = infer_sec / n_patches

    wmap = gaussian_importance_map(PATCH)
    t0 = time.perf_counter()
    reconstruct_from_patches([p.transpose(3, 0, 1, 2) for p in preds],
                             corners, (1,) + VOLUME, weight_map=wmap)
    reconstruct_sec = time.perf_counter() - t0

    composite_sec = (TRAIN_PATCHES_PER_VOLUME * train_step_sec
                     + infer_sec + reconstruct_sec)
    result = {
        "hardware": "CPU (1 core), Keras " + __import__("keras").__version__,
        "train_step_sec": train_step_sec,
        "patch_infer_sec_per_patch": patch_infer_sec,
        "whole_volume_infer_sec": infer_sec + reconstruct_sec,
        "reconstruct_sec": reconstruct_sec,
        "n_infer_patches": int(n_patches),
        "composite_volumes_per_sec": 1.0 / composite_sec,
        "composite_def": f"{TRAIN_PATCHES_PER_VOLUME} batch-1 train steps "
                         f"(64^3, depth-3) + 1 whole-volume inference "
                         f"(128^3, overlap {OVERLAP}, Gaussian overlap-add)",
    }
    with open(out_json, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))


if __name__ == "__main__":
    main()
