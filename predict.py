#!/usr/bin/env python
"""Inference entry point: predict every validation case to NIfTI.

Reference surface: predict.py::main — load validation index pickle + trained
model, run run_validation_cases → per-case directory with prediction.nii.gz
(reference: unet3d/prediction.py::run_validation_cases).

Usage:
    python predict.py --config my_experiment.json [--output-dir prediction]
                      [--overlap 16] [--tta]
"""

from __future__ import annotations

import argparse

import jax


def assign_output_names(paths):
    """Unique output-dir name per input path, in order.

    Derived from the basename (sans a trailing .nii[.gz] — shared helper
    with serve.py so the two surfaces name cases identically); duplicates
    get a numeric suffix chosen against every name already ASSIGNED — not
    just raw-basename counts — so a literal ``foo_2`` input is never
    overwritten by the deduped second ``foo``.
    """
    from fetal_mri_segmentation_tpu.utils.io_utils import case_name_from_path

    assigned, names = set(), []
    for path in paths:
        base = case_name_from_path(path)
        name, n = base, 1
        while name in assigned:
            n += 1
            name = f"{base}_{n}"
        assigned.add(name)
        names.append(name)
    return names


def main(config, output_dir: str = "prediction", overlap: int = None,
         tta: bool = False, patch_batch_size: int = 8,
         num_devices: int = 1, spatial_devices: int = 1,
         direct: bool = False, export_path: str = None,
         inputs=None, device_preprocess: bool = False,
         prob_map: bool = False, threshold: float = 0.5,
         prob_dtype: str = "float32", from_keras: str = None):
    if from_keras:
        # config-free reference migration (reference: predict.py loads the
        # model .h5 directly via load_old_model — SURVEY.md section 3.2):
        # architecture from the file's model_config, weights imported below
        from fetal_mri_segmentation_tpu.utils.keras_migrate import (
            derive_config_from_keras_h5)
        config = derive_config_from_keras_h5(from_keras, base=config)
    if overlap is None:
        # follow the config's validation grid: a patch_shape smaller than
        # the old hardcoded 16 would otherwise reject its own config
        # (overlap must be < patch size)
        overlap = config.validation_patch_overlap
    # flag-combination validation BEFORE the (slow) model build/restore
    if inputs and ((num_devices and num_devices > 1)
                   or (spatial_devices and spatial_devices > 1)):
        raise ValueError(
            "--input is single-device; --num-devices/--spatial-devices "
            "apply to the validation-set path only")
    if device_preprocess and not inputs:
        raise ValueError("--device-preprocess applies to raw-NIfTI ingest "
                         "(--input); the validation set is already "
                         "preprocessed inside the HDF5 dataset")
    if prob_map and export_path:
        raise ValueError("--export serializes the LABEL-MAP program; "
                         "probability output (--prob-map) is not exportable")
    if prob_dtype != "float32" and not prob_map:
        raise ValueError("--prob-dtype applies to the probability-map "
                         "transfer only — pass --prob-map (label-map "
                         "output already uses the bit-packed transfer)")

    from fetal_mri_segmentation_tpu.utils.compilation_cache import (
        enable_compilation_cache)
    enable_compilation_cache()
    from fetal_mri_segmentation_tpu.data import open_data_file
    from fetal_mri_segmentation_tpu.inference import run_validation_cases
    from fetal_mri_segmentation_tpu.inference.predict import (
        build_serving_predictor, load_serving_model)

    if from_keras:
        import jax.tree_util as jtu
        import jax.numpy as jnp

        from fetal_mri_segmentation_tpu.utils.keras_migrate import (
            load_old_model as load_keras_model)
        model, state, _ = load_keras_model(from_keras, config=config,
                                           with_optimizer=False, derived=True)
        variables = {"params": jtu.tree_map(jnp.asarray, state.params)}
    else:
        model, variables = load_serving_model(config)

    if export_path:
        from fetal_mri_segmentation_tpu.utils.export import export_predictor
        export_predictor(model, config, variables, config.image_shape,
                         export_path, overlap=overlap,
                         patch_batch_size=patch_batch_size, tta=tta,
                         threshold=threshold, direct=direct)
        print(f"exported portable label-map program to {export_path}"
              + (" (direct whole-volume mode)" if direct else ""))
        return

    if inputs:
        # ad-hoc NIfTI cases (no HDF5 ingest; beyond the reference surface,
        # which could only predict cases already inside its HDF5 file)
        import os

        from fetal_mri_segmentation_tpu.inference.predict import (
            load_global_moments, make_device_preprocessor,
            predict_cases_pipelined)

        # (incompatible flag combinations already rejected at the top of
        # main — same fail-loudly policy as run_validation_cases)
        predictor = build_serving_predictor(
            model, config, direct=direct, tta=tta, overlap=overlap,
            patch_batch_size=patch_batch_size)
        # training-distribution moments loaded ONCE, not per case
        moments = (load_global_moments(config.data_file)
                   if config.normalization == "global" else None)
        device_pre = (make_device_preprocessor(model, config, moments=moments)
                      if device_preprocess else None)
        # pipelined batch: case i's preprocessing+H2D overlaps case i-1's
        # device compute+D2H (same two-stage overlap as serve.py and
        # run_validation_cases; per-case results identical to predict_case)
        predict_cases_pipelined(
            [(path, os.path.join(output_dir, name))
             for path, name in zip(inputs, assign_output_names(inputs))],
            model, variables, config, predictor, global_moments=moments,
            device_pre=device_pre, output_label_map=not prob_map,
            threshold=threshold, prob_dtype=prob_dtype)
        return

    mesh = None
    if num_devices and num_devices > 1:
        from fetal_mri_segmentation_tpu.parallel import make_mesh
        mesh = make_mesh(num_devices)
    spatial_mesh = None
    if spatial_devices and spatial_devices > 1:
        from fetal_mri_segmentation_tpu.parallel import make_hybrid_mesh
        spatial_mesh = make_hybrid_mesh(1, spatial_devices)
    elif direct:
        # single-device whole-volume forward (no patching) = a 1-device
        # spatial mesh; the collectives compile away (parallel/spatial.py).
        import numpy as np
        from jax.sharding import Mesh
        spatial_mesh = Mesh(np.asarray(jax.devices()[:1]), ("spatial",))

    data_file = open_data_file(config.data_file)
    try:
        run_validation_cases(config.validation_file, model, variables,
                             data_file, config, output_dir=output_dir,
                             overlap=overlap, permute=tta,
                             patch_batch_size=patch_batch_size, mesh=mesh,
                             spatial_mesh=spatial_mesh,
                             output_label_map=not prob_map,
                             threshold=threshold, prob_dtype=prob_dtype)
    finally:
        data_file.close()
    print(f"predictions written under {output_dir}/")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None,
                    help="experiment JSON (required unless --from-keras "
                         "supplies the model config)")
    ap.add_argument("--from-keras", metavar="MODEL_H5", default=None,
                    help="predict with a reference Keras model: the "
                         "architecture is reconstructed from the .h5's "
                         "model_config and the weights imported — no "
                         "hand-written model config (reference: predict.py "
                         "loads the model file directly). Combine with "
                         "--input for HDF5-free ad-hoc cases, or with "
                         "--config for validation-set prediction")
    ap.add_argument("--output-dir", default="prediction")
    ap.add_argument("--overlap", type=int, default=None,
                    help="sliding-window patch overlap (default: the "
                         "config's validation_patch_overlap)")
    ap.add_argument("--patch-batch-size", type=int, default=8)
    ap.add_argument("--tta", action="store_true",
                    help="test-time augmentation averaging (see --tta-mode)")
    ap.add_argument("--tta-mode", choices=["permute", "flips"],
                    default=None,
                    help="implies --tta. permute = all 48 cube symmetries "
                         "(cubic patches only, ~48x forward cost; the "
                         "default with bare --tta); flips = 8-way "
                         "axis-flip subgroup (~6x cheaper, any patch shape)")
    ap.add_argument("--num-devices", type=int, default=1,
                    help="shard the patch grid over N devices")
    ap.add_argument("--export", metavar="PATH", default=None,
                    help="serialize the whole-volume label-map program "
                         "(trained weights baked in, StableHLO) to PATH "
                         "and exit — deployable with jax alone")
    ap.add_argument("--spatial-devices", type=int, default=1,
                    help="whole-volume inference with the depth axis "
                         "sharded over N devices (no patching; XLA halo "
                         "exchange)")
    ap.add_argument("--input", nargs="+", metavar="CASE", default=None,
                    help="predict ad-hoc NIfTI case(s) instead of the "
                         "validation set: each CASE is a directory with "
                         "<modality>.nii.gz files (train-time layout) or a "
                         "single .nii[.gz] for one-modality configs; same "
                         "crop/resample/normalize preprocessing as the "
                         "dataset builder, no HDF5 needed")
    ap.add_argument("--direct", action="store_true",
                    help="single-device whole-volume inference (one "
                         "forward, no patch grid — ~2x less device time "
                         "than sliding-window; volume dims must divide "
                         "2^(depth-1))")
    ap.add_argument("--device-preprocess", action="store_true",
                    help="with --input: run the ingest zoom + normalization "
                         "on the device (host does read + crop only; "
                         "shape-bucketed compiles, fp-level parity with "
                         "the host path — same option as serve.py)")
    ap.add_argument("--prob-map", action="store_true",
                    help="write the raw probability map instead of the "
                         "thresholded/argmaxed label map (reference: "
                         "run_validation_cases output_label_map=False; "
                         "multi-class writes one channel per label as a "
                         "4-D NIfTI) — for QA, calibration, or ensembling")
    ap.add_argument("--threshold", type=float, default=0.5,
                    help="binary label-map threshold (default 0.5; "
                         "reference: prediction_to_image)")
    ap.add_argument("--prob-dtype",
                    choices=["float32", "float16", "uint8", "uint16"],
                    default="float32",
                    help="with --prob-map: device->host transfer dtype. "
                         "float16 halves the D2H bytes at <=4.9e-4 "
                         "quantization on [0,1] (written as float32); "
                         "uint8/uint16 fixed-point transfers quarter/halve "
                         "them at <=2.0e-3 / 7.6e-6 and stay integer on "
                         "disk via NIfTI scl_slope scaling (4x/2x smaller "
                         "files; scl-aware readers incl. nibabel and "
                         "tools/ensemble.py still see [0,1] floats; "
                         "measured 2x faster per case than float32 — "
                         "docs/PERF.md add. 17)")
    args = ap.parse_args()

    from fetal_mri_segmentation_tpu.config import Config
    from fetal_mri_segmentation_tpu.inference.predict import resolve_tta

    if not args.config and not args.from_keras:
        ap.error("one of --config / --from-keras is required")
    main(Config.load(args.config) if args.config else Config(),
         output_dir=args.output_dir,
         overlap=args.overlap, tta=resolve_tta(args.tta, args.tta_mode),
         patch_batch_size=args.patch_batch_size,
         num_devices=args.num_devices,
         spatial_devices=args.spatial_devices, direct=args.direct,
         export_path=args.export, inputs=args.input,
         device_preprocess=args.device_preprocess,
         prob_map=args.prob_map, threshold=args.threshold,
         prob_dtype=args.prob_dtype, from_keras=args.from_keras)
