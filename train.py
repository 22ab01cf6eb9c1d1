#!/usr/bin/env python
"""Training entry point.

Reference surface: train.py / train_fetal.py — an in-script ``config`` dict +
``main(overwrite=False)`` that builds the HDF5 dataset if missing, builds or
resumes the model, creates the generators, and trains (reference: train.py::
main, fetch_training_data_files). Here the config is a JSON file (same key
names, SURVEY.md section 5.6) with CLI overrides; everything else matches.

Usage:
    python train.py --config my_experiment.json [--overwrite]
    python train.py --data-dir /path/to/cases --model isensee  # quick start
    python train.py --smoke        # synthetic end-to-end smoke run

Data layout: <data_dir>/<case>/{<modality>.nii.gz..., truth.nii.gz}
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import jax
import numpy as np


def fetch_training_data_files(data_dir: str, modalities, truth_name="truth"):
    """Glob per-case [mod1.nii.gz, ..., truth.nii.gz] lists.

    Reference: train.py::fetch_training_data_files.
    """
    training_data_files = []
    subject_ids = []
    for case_dir in sorted(glob.glob(os.path.join(data_dir, "*"))):
        if not os.path.isdir(case_dir):
            continue
        files = []
        ok = True
        for name in tuple(modalities) + (truth_name,):
            matches = (glob.glob(os.path.join(case_dir, name + ".nii.gz"))
                       or glob.glob(os.path.join(case_dir, name + ".nii")))
            if not matches:
                ok = False
                break
            files.append(matches[0])
        if ok:
            training_data_files.append(files)
            subject_ids.append(os.path.basename(case_dir))
    return training_data_files, subject_ids


def main(config, data_dir: str, overwrite: bool = False, verbose: bool = True,
         profile_dir: str = None, seed: int = 0, from_keras: str = None,
         data_file=None):
    """Build (or reuse) the dataset, build or resume the model, train;
    returns the final train state.

    ``data_file``: an already-open dataset (`DataFile`, e.g.
    `DataFile.from_arrays`) to train on instead of ``config.data_file``;
    ``data_dir`` is then unused.
    """
    from fetal_mri_segmentation_tpu.utils.compilation_cache import (
        enable_compilation_cache)
    enable_compilation_cache()
    if from_keras:
        # derive the MODEL config from the .h5 BEFORE anything touches the
        # config: the data build below globs the derived modalities and the
        # generators use the derived patch geometry (reference: training.py
        # ::load_old_model rebuilds the architecture from the file alone)
        from fetal_mri_segmentation_tpu.utils.keras_migrate import (
            derive_config_from_keras_h5)
        config = derive_config_from_keras_h5(from_keras, base=config,
                                             verbose=verbose)
    # reconcile the two overwrite surfaces (CLI arg and config key): the
    # abstract-state fast path below gates on `overwrite` while train_model
    # gates its restore on `config.overwrite` — if they disagreed, a fresh
    # start could crash on an abstract template with the restore skipped
    # (or silently resume over a requested fresh run)
    overwrite = bool(overwrite or config.overwrite)
    config.overwrite = overwrite
    from fetal_mri_segmentation_tpu.data import (open_data_file,
                                                 write_data_to_file)
    from fetal_mri_segmentation_tpu.models import build_model
    from fetal_mri_segmentation_tpu.parallel import make_mesh
    from fetal_mri_segmentation_tpu.pipeline import (
        get_training_and_validation_generators)
    from fetal_mri_segmentation_tpu.training import (create_train_state,
                                                     train_model)

    # 1. dataset build (cached unless overwrite — reference: write_data_to_file)
    if data_file is None and (overwrite
                              or not os.path.exists(config.data_file)):
        files, subject_ids = fetch_training_data_files(
            data_dir, config.training_modalities)
        if not files:
            mods = ", ".join(f"{m}.nii[.gz]"
                             for m in (config.training_modalities
                                       or config.all_modalities))
            sys.exit(
                f"no cases found under {data_dir} — each case needs its own "
                f"directory containing {mods} AND truth.nii[.gz] "
                "(incomplete case dirs are skipped)")
        print(f"building {config.data_file} from {len(files)} cases...")
        write_data_to_file(files, config.data_file,
                           image_shape=config.image_shape,
                           subject_ids=subject_ids,
                           normalize=config.normalization)
    if data_file is None:
        data_file = open_data_file(config.data_file)

    try:
        # 2. model + state (resume handled inside train_model via checkpoint).
        # When a checkpoint will be restored anyway, build the state as a
        # compile-free abstract template (jax.eval_shape) — running the full
        # model.init jit here would be a throwaway compile (~30 s on one CPU
        # core) whose every leaf the restore overwrites. Same lever the
        # serving cold-start path uses (training/state.py).
        from fetal_mri_segmentation_tpu.training.checkpoint import CheckpointIO
        ckpt_io = CheckpointIO(config.model_file)
        if from_keras:
            # config-free reference migration (reference: training.py::
            # load_old_model — arch + weights + optimizer from one .h5):
            # the model config was already derived from the file in
            # __main__; here the weights and Adam slots come in. Resume of
            # OUR checkpoints and a Keras import are mutually exclusive
            # starting points — refuse the ambiguity rather than pick one.
            if ckpt_io.exists() and not overwrite:
                sys.exit(
                    f"--from-keras {from_keras}: a checkpoint already "
                    f"exists at {config.model_file} — resuming it would "
                    "ignore the Keras model. Pass --overwrite to start "
                    "from the .h5, or a fresh --config model_file")
            from fetal_mri_segmentation_tpu.utils.keras_migrate import (
                load_old_model as load_keras_model)
            model, state, _ = load_keras_model(from_keras, config=config,
                                               verbose=verbose, derived=True)
            resuming = False
        else:
            model = build_model(config)
            resuming = ckpt_io.exists() and not overwrite
            if resuming:
                from fetal_mri_segmentation_tpu.training.state import (
                    create_abstract_state)
                state = create_abstract_state(model, config)
            else:
                state = create_train_state(model, config,
                                           jax.random.PRNGKey(seed))
        # data-order exact resume: fast-forward the generators by the
        # start_epoch*steps batches the interrupted run consumed, so a
        # resumed run trains on the exact batch sequence an uninterrupted
        # run would (None for legacy checkpoints without the sidecar ->
        # fresh streams, the pre-sidecar behavior)
        start_epoch = (ckpt_io.peek_epoch() or 0) if resuming else 0

        # 3. generators (reference: get_training_and_validation_generators)
        tg, n_train, vg, n_val = get_training_and_validation_generators(
            data_file, batch_size=config.batch_size, n_labels=config.n_labels,
            training_keys_file=config.training_file,
            validation_keys_file=config.validation_file,
            data_split=config.validation_split, overwrite=overwrite,
            labels=config.labels, patch_shape=config.patch_shape,
            validation_batch_size=config.validation_batch_size,
            validation_patch_overlap=config.validation_patch_overlap,
            training_patch_start_offset=config.training_patch_start_offset,
            skip_blank=config.skip_blank, seed=seed,
            start_epoch=start_epoch)

        # 4. train (multi-device DP when >1 device visible; hybrid
        #    data x spatial mesh when spatial_devices > 1)
        n_dev = config.num_devices or len(jax.devices())
        n_spatial = getattr(config, "spatial_devices", 1) or 1
        if n_spatial > 1:
            if n_dev % n_spatial != 0:
                sys.exit(f"spatial_devices={n_spatial} must divide the "
                         f"device count ({n_dev}) — devices would sit idle")
            from fetal_mri_segmentation_tpu.parallel import make_hybrid_mesh
            mesh = make_hybrid_mesh(n_dev // n_spatial, n_spatial)
        else:
            mesh = make_mesh(n_dev) if n_dev > 1 else None
        if verbose:
            desc = (f"mesh {tuple(mesh.devices.shape)} {mesh.axis_names}"
                    if mesh is not None else "1 device")
            print(f"training on {desc}; "
                  f"{n_train} steps/epoch, {n_val} val steps")

        # device-resident case cache (single-device or pure-DP mesh): cases
        # live in device memory, steps feed int32 patch indices instead of
        # uploaded patch arrays (pipeline/device_cache.py; exact-parity
        # with the host staging path; spatial/hybrid meshes keep host
        # staging)
        device_cache = None
        from fetal_mri_segmentation_tpu.pipeline.device_cache import (
            maybe_build_device_cache)
        # pin the interrupted run's data-order mode: the partial-cache
        # decision otherwise reads LIVE free device memory, which may differ
        # between the crashed run and this one — and partial batch grouping must
        # match for skip_batches to land on the same sequence. Legacy
        # sidecars (no field) resume as lockstep, the pre-partial behavior.
        resume_order = None
        if resuming and start_epoch > 0:
            resume_order = (ckpt_io.peek_data_order()
                            or {"mode": "lockstep"})
        dc = maybe_build_device_cache(data_file, config, mesh=mesh,
                                      seed=seed,
                                      train_skip_batches=start_epoch * n_train,
                                      val_skip_batches=start_epoch * n_val,
                                      resume_data_order=resume_order,
                                      verbose=verbose)
        if dc is not None:
            device_cache, tg, vg = dc

        if profile_dir:
            # device-timeline trace (tensorboard-loadable) around training —
            # observability the reference lacked (SURVEY.md section 5.1)
            from fetal_mri_segmentation_tpu.utils.profiling import trace
            with trace(profile_dir):
                return train_model(model, state, config, tg, vg, n_train,
                                   n_val, mesh=mesh, seed=seed,
                                   verbose=verbose,
                                   device_cache=device_cache)
        return train_model(model, state, config, tg, vg, n_train, n_val,
                           mesh=mesh, seed=seed, verbose=verbose,
                           device_cache=device_cache)
    finally:
        data_file.close()


def run_smoke(tmpdir: str = "/tmp/fetal_smoke"):
    """Synthetic end-to-end: generate data, train 2 epochs, tiny model."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tests"))
    from synthetic import write_synthetic_dataset
    from fetal_mri_segmentation_tpu.config import Config

    os.makedirs(tmpdir, exist_ok=True)
    write_synthetic_dataset(os.path.join(tmpdir, "cases"), n_cases=4,
                            shape=(24, 24, 24))
    cfg = Config(image_shape=(16, 16, 16), patch_shape=(8, 8, 8),
                 validation_patch_overlap=2,
                 training_patch_start_offset=(2, 2, 2),
                 depth=2, n_base_filters=4, batch_size=4, n_epochs=2,
                 data_file=os.path.join(tmpdir, "data.h5"),
                 model_file=os.path.join(tmpdir, "model.ckpt"),
                 training_file=os.path.join(tmpdir, "training_ids.pkl"),
                 validation_file=os.path.join(tmpdir, "validation_ids.pkl"),
                 training_log=os.path.join(tmpdir, "training.log"),
                 compute_dtype="float32", overwrite=True)
    cfg.save(os.path.join(tmpdir, "config.json"))
    main(cfg, os.path.join(tmpdir, "cases"), overwrite=True)
    print("smoke run complete; artifacts in", tmpdir)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", help="JSON config (reference key names)")
    ap.add_argument("--data-dir", default=None,
                    help="directory of per-case NIfTI folders (overrides "
                         "the config's data_dir; default: data)")
    ap.add_argument("--model", dest="model_name",
                    choices=["unet", "isensee"], default=None)
    ap.add_argument("--overwrite", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="synthetic end-to-end smoke run")
    ap.add_argument("--profile", metavar="LOGDIR", default=None,
                    help="capture a jax.profiler trace of training")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed for init, patch sampling and augmentation")
    ap.add_argument("--from-keras", metavar="MODEL_H5", default=None,
                    help="continue training a reference Keras model: the "
                         "architecture (depth, filters, deconvolution, "
                         "normalization, labels, patch shape) is "
                         "reconstructed from the .h5's model_config, and "
                         "weights + Adam optimizer state are imported — no "
                         "hand-written model config (reference: training.py"
                         "::load_old_model). --config still supplies data "
                         "paths and schedule knobs")
    args = ap.parse_args()

    if args.smoke:
        run_smoke()
        sys.exit(0)

    from fetal_mri_segmentation_tpu.config import Config

    cfg = Config.load(args.config) if args.config else Config()
    if args.model_name:
        cfg.model_name = args.model_name
    if args.overwrite:
        cfg.overwrite = True
    main(cfg, args.data_dir or cfg.data_dir or "data",
         overwrite=cfg.overwrite, profile_dir=args.profile, seed=args.seed,
         from_keras=args.from_keras)
