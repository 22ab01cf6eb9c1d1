#!/usr/bin/env python
"""GPU benchmark — BASELINE.md composite + the measurement configs.

Default run: ONE JSON line to stdout whose primary value is the BASELINE
composite (config #1+#3), with the other configs' numbers in "detail":

  composite "volume-equivalent" = 8 batch-1 train steps on 64^3 patches
  (depth-3 3D U-Net, soft-Dice, Adam) + 1 whole-volume sliding-window
  inference (128^3 volume, 64^3 patches, overlap 16, Gaussian overlap-add),
  measured as a PIPELINED STREAM of volumes (async label fetch — the
  production serving shape; reference processes cases sequentially with a
  host round-trip per patch batch).

  config2: composite with full on-device flip/permute/contrast augmentation
           in the train step.
  config4: Isensee2017 composite (deep supervision, weighted dice).

Runs on a GPU only: with no GPU visible it exits non-zero before measuring.
Every result carries the device (platform, kind, count) and the card's name
and power limit as nvidia-smi reports them.

vs_baseline = composite volumes/sec divided by the CPU-Keras volumes/sec
from ``baseline_cpu_keras.json`` (north star: >= 10x).

``--config {1,2,3,4}`` measures a single config; ``--quick`` skips
configs 2/4 and the detail rows (composite only).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

PATCH = (64, 64, 64)
VOLUME = (128, 128, 128)
OVERLAP = 16
TRAIN_PATCHES_PER_VOLUME = 8


def _make_batch(rng):
    y = (rng.random((1, 1) + PATCH) > 0.7).astype(np.float32)
    x = (y * 2 + rng.normal(0, 0.3, y.shape)).astype(np.float32)
    return x, y


def _composite(model_name: str, augment: bool, n_reps: int = 5):
    """volumes/sec + component times for one model/aug settings."""
    import jax
    import jax.numpy as jnp

    from fetal_mri_segmentation_tpu.config import Config
    from fetal_mri_segmentation_tpu.inference import SlidingWindowPredictor
    from fetal_mri_segmentation_tpu.models import build_model
    from fetal_mri_segmentation_tpu.training import (create_train_state,
                                                     make_train_step)

    # unet: the BASELINE config-#1 depth-3/32 model; isensee: the reference
    # isensee2017_model defaults (depth 5, n_base_filters 16, 3 seg heads)
    depth, nbf = (3, 32) if model_name == "unet" else (5, 16)
    config = Config(model_name=model_name, depth=depth, n_base_filters=nbf,
                    patch_shape=PATCH, image_shape=VOLUME, batch_size=1,
                    augment=augment, flip=augment, permute=augment,
                    contrast=0.1 if augment else None,
                    compute_dtype="bfloat16",
                    initial_learning_rate=1e-5)
    model = build_model(config)
    state = create_train_state(model, config, jax.random.PRNGKey(0))
    train_step = make_train_step(model, config)

    rng = np.random.default_rng(0)
    x, y = _make_batch(rng)
    x, y = jnp.asarray(x), jnp.asarray(y)
    key = jax.random.PRNGKey(1)

    predictor = SlidingWindowPredictor(model, config, image_shape=VOLUME,
                                       patch_shape=PATCH, overlap=OVERLAP,
                                       patch_batch_size=27, use_gaussian=True)
    vol = rng.normal(0, 1, (1,) + VOLUME).astype(np.float32)

    # ---- warmup / compile ----
    # (the train step donates its input state, so always read params from the
    # CURRENT state object; inference produces the reference's artifact — the
    # uint8 label map — computed on device)
    state, m = train_step(state, x, y, key, None)
    jax.block_until_ready(m["loss"])
    predictor.predict_labels({"params": state.params}, vol)

    # ---- timed pipelined stream ----
    # async label fetch: the D2H + dispatch overhead of volume i overlaps the
    # train steps of volume i+1 (device execution stays serial).
    # median of 3 independent stream trials: host-clock noise that one
    # trial would absorb into the headline; the median is the steady state.
    trials = []
    for _ in range(3):
        outs = []
        t0 = time.perf_counter()
        for _ in range(n_reps):
            for _ in range(TRAIN_PATCHES_PER_VOLUME):
                state, m = train_step(state, x, y, key, None)
            outs.append(predictor.predict_labels_async(
                {"params": state.params}, vol))
        labels = [predictor.unpack_labels(o) for o in outs]
        trials.append((time.perf_counter() - t0) / n_reps)
        assert all(l.shape == VOLUME for l in labels)
    dt = float(np.median(trials))

    # components (informational)
    t0 = time.perf_counter()
    for _ in range(20):
        state, m = train_step(state, x, y, key, None)
    jax.block_until_ready(m["loss"])
    train_step_sec = (time.perf_counter() - t0) / 20
    t0 = time.perf_counter()
    predictor.predict_labels({"params": state.params}, vol)
    infer_sec = time.perf_counter() - t0

    return {"volumes_per_sec": round(1.0 / dt, 4),
            "train_step_sec": round(train_step_sec, 5),
            "whole_volume_infer_sec": round(infer_sec, 5)}


def _batched_train_steps():
    """Throughput-shape train steps: B=8 and B=27 (BASELINE config #1 pins
    the composite at B=1, but a real epoch batches)."""
    import jax
    import jax.numpy as jnp

    from fetal_mri_segmentation_tpu.config import Config
    from fetal_mri_segmentation_tpu.models import build_model
    from fetal_mri_segmentation_tpu.training import (create_train_state,
                                                     make_train_step)

    out = {}
    rng = np.random.default_rng(0)
    for B in (8, 27):
        config = Config(model_name="unet", depth=3, n_base_filters=32,
                        patch_shape=PATCH, batch_size=B,
                        compute_dtype="bfloat16", initial_learning_rate=1e-5)
        model = build_model(config)
        state = create_train_state(model, config, jax.random.PRNGKey(0))
        step = make_train_step(model, config)
        y = (rng.random((B, 1) + PATCH) > 0.7).astype(np.float32)
        x = (y * 2 + rng.normal(0, 0.3, y.shape)).astype(np.float32)
        x, y = jnp.asarray(x), jnp.asarray(y)
        key = jax.random.PRNGKey(1)
        state, m = step(state, x, y, key, None)   # compile
        jax.block_until_ready(m["loss"])
        t0 = time.perf_counter()
        for _ in range(10):
            state, m = step(state, x, y, key, None)
        jax.block_until_ready(m["loss"])
        dt = (time.perf_counter() - t0) / 10
        out[f"train_step_b{B}_sec"] = round(dt, 5)
        out[f"train_patches_per_sec_b{B}"] = round(B / dt, 2)
    return out


def _real_epoch_row():
    """An ACTUAL train.py epoch (generator + prefetch + jitted steps +
    checkpoint), not a microbench: patches/sec as logged to training.log.
    The synthetic 128^3 dataset is made in memory (tests/synthetic.py)."""
    import sys as _sys

    import jax

    _sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from synthetic import synthetic_data_file

    from fetal_mri_segmentation_tpu.config import Config
    from fetal_mri_segmentation_tpu.models import build_model
    from fetal_mri_segmentation_tpu.pipeline import (
        get_training_and_validation_generators)
    from fetal_mri_segmentation_tpu.training import (create_train_state,
                                                     train_model)

    run_dir = tempfile.mkdtemp(prefix="fetal_bench_epoch_")
    cfg = Config(model_name="unet", depth=3, n_base_filters=32,
                 image_shape=VOLUME, patch_shape=PATCH, batch_size=8,
                 # 2 epochs: the LAST training.log row is the steady-state
                 # rate — epoch 1 pays the train-step compile, which a
                 # 1-epoch run would charge to the throughput denominator
                 validation_batch_size=8, n_epochs=2, compute_dtype="bfloat16",
                 initial_learning_rate=1e-5,
                 training_patch_start_offset=(16, 16, 16),
                 validation_patch_overlap=0,
                 model_file=os.path.join(run_dir, "model.ckpt"),
                 training_file=os.path.join(run_dir, "t.pkl"),
                 validation_file=os.path.join(run_dir, "v.pkl"),
                 training_log=os.path.join(run_dir, "training.log"))
    data_file = synthetic_data_file(n_cases=24, shape=VOLUME)
    try:
        tg, n_t, vg, n_v = get_training_and_validation_generators(
            data_file, batch_size=cfg.batch_size, n_labels=1,
            training_keys_file=cfg.training_file,
            validation_keys_file=cfg.validation_file,
            data_split=0.875, overwrite=True, patch_shape=cfg.patch_shape,
            validation_batch_size=cfg.validation_batch_size,
            training_patch_start_offset=(16, 16, 16), skip_blank=True,
            seed=0)
        model = build_model(cfg)
        state = create_train_state(model, cfg, jax.random.PRNGKey(0))
        # shipped default (train.py): device-resident case cache — cases in
        # device memory, steps feed int32 patch indices (pipeline/device_cache.py)
        from fetal_mri_segmentation_tpu.pipeline.device_cache import (
            maybe_build_device_cache)
        device_cache = None
        dc = maybe_build_device_cache(data_file, cfg, seed=0)
        if dc is not None:
            device_cache, tg, vg = dc
        train_model(model, state, cfg, tg, vg, n_t, n_v, verbose=False,
                    device_cache=device_cache)
    finally:
        data_file.close()
    import csv

    with open(cfg.training_log) as f:
        row = list(csv.DictReader(f))[-1]
    return {"epoch_patches_per_sec": round(float(row["patches_per_sec"]), 2),
            "epoch_steps": n_t, "epoch_batch_size": cfg.batch_size,
            "device_case_cache": device_cache is not None,
            "note": "full train.py epoch: generator + prefetch "
                    "+ jitted steps + validation + checkpoint, 21 cases "
                    "128^3, 64^3 patches; device-resident case cache"}


def _tta_volume_secs():
    """TTA cost per volume (single-shot wall, distinct volumes): the full
    48-symmetry average (~48x forward) and the 8-way flips subgroup."""
    import jax
    import jax.numpy as jnp

    from fetal_mri_segmentation_tpu.config import Config
    from fetal_mri_segmentation_tpu.inference import SlidingWindowPredictor
    from fetal_mri_segmentation_tpu.models import build_model

    config = Config(model_name="unet", depth=3, n_base_filters=32,
                    patch_shape=PATCH, image_shape=VOLUME,
                    compute_dtype="bfloat16")
    model = build_model(config)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1,) + PATCH + (1,), jnp.float32))
    rng = np.random.default_rng(0)
    out = {}
    for mode, key in (("flips", "tta_flips_volume_sec"),
                      ("permute", "tta_permute_volume_sec")):
        predictor = SlidingWindowPredictor(
            model, config, image_shape=VOLUME, patch_shape=PATCH,
            overlap=OVERLAP, patch_batch_size=27, tta_permute=mode)
        vols = [rng.normal(0, 1, (1,) + VOLUME).astype(np.float32)
                for _ in range(3)]
        predictor.predict_labels(variables, vols[0])  # compile
        t0 = time.perf_counter()
        for v in vols[1:]:
            predictor.predict_labels(variables, v)
        out[key] = round((time.perf_counter() - t0) / (len(vols) - 1), 4)
    # volume-level TTA on the DIRECT whole-volume predictor (beyond-parity
    # mode: the symmetry group acts on the full volume, so overlap regions
    # are never recomputed — ~2x less device work than patch-level TTA)
    from fetal_mri_segmentation_tpu.parallel.spatial import (
        make_direct_predictor)

    for mode, key in (("flips", "tta_flips_direct_volume_sec"),
                      ("permute", "tta_permute_direct_volume_sec")):
        predictor = make_direct_predictor(model, config, tta=mode)
        vols = [rng.normal(0, 1, (1,) + VOLUME).astype(np.float32)
                for _ in range(3)]
        predictor.predict_labels(variables, vols[0])  # compile
        t0 = time.perf_counter()
        for v in vols[1:]:
            predictor.predict_labels(variables, v)
        out[key] = round((time.perf_counter() - t0) / (len(vols) - 1), 4)
    return out


def _serve_case_sec(raw_shape=None, device_preprocess=False, n_cases=4,
                    croppable=False):
    """End-to-end serving wall per case (serve.py's unit of work): NIfTI
    read, builder-identical preprocessing, whole-volume direct forward,
    bit-packed D2H, label-map NIfTI write. Median of the post-compile
    cases; each case is a DIFFERENT random volume.

    ``raw_shape``: on-disk volume shape; when != VOLUME the ingest zoom
    actually runs (scanner-resolution serving shape). ``device_preprocess``
    moves zoom+normalize onto the device (ops/resample.py). ``croppable``
    embeds the foreground in a zero background (the reference's data
    shape: fetal brains are cropped to their bounding box on ingest), so
    the shared-crop stage actually shrinks the volume."""
    import tempfile

    import jax
    import jax.numpy as jnp

    from fetal_mri_segmentation_tpu.config import Config
    from fetal_mri_segmentation_tpu.inference.predict import predict_case
    from fetal_mri_segmentation_tpu.models import build_model
    from fetal_mri_segmentation_tpu.parallel.spatial import (
        make_direct_predictor)
    from fetal_mri_segmentation_tpu.utils.nifti import save_nifti

    raw_shape = raw_shape or VOLUME
    config = Config(model_name="unet", depth=4, n_base_filters=32,
                    image_shape=VOLUME, patch_shape=PATCH,
                    compute_dtype="bfloat16")
    model = build_model(config)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1,) + PATCH + (1,), jnp.float32))
    predictor = make_direct_predictor(model, config)
    device_pre = None
    if device_preprocess:
        from fetal_mri_segmentation_tpu.ops.resample import (
            DevicePreprocessor)
        # compute_dtype matched to the bf16 model, as serve.py builds it —
        # the f32 default would compile a second label-program signature
        # and charge every case an extra on-device cast (serve.py:57)
        device_pre = DevicePreprocessor(config.image_shape,
                                        config.normalization,
                                        compute_dtype=jnp.bfloat16,
                                        transfer_dtype=jnp.bfloat16)
    rng = np.random.default_rng(0)
    times = []
    with tempfile.TemporaryDirectory() as d:
        for i in range(n_cases):
            case = os.path.join(d, f"case_{i}")
            os.makedirs(case)
            if croppable:
                vol = np.zeros(raw_shape, np.float32)
                box = tuple(slice(int(0.17 * n), int(0.80 * n))
                            for n in raw_shape)
                vol[box] = rng.normal(
                    200, 50, [s.stop - s.start for s in box]
                ).astype(np.float32)
            else:
                vol = rng.normal(0, 1, raw_shape).astype(np.float32)
            save_nifti(vol, os.path.join(case, "volume.nii.gz"))
            t0 = time.perf_counter()
            # full serve-path semantics: shared-crop + resample + normalize
            predict_case(case, os.path.join(d, "out", f"case_{i}"), model,
                         variables, config, predictor=predictor,
                         save_inputs=False, device_pre=device_pre)
            times.append(time.perf_counter() - t0)
    return round(float(np.median(times[1:])), 5)


def _serve_backlog_sec_per_case(n_cases=8, raw_shape=(170, 170, 110)):
    """The PIPELINED serving number: serve.py's ``watch_and_predict`` on an
    n-case backlog (``once=True``) with the direct predictor + device
    preprocessing — wall/case. This is the round-2 verdict item-2 claim
    (docs/PERF.md addendum 8) as a driver-captured row; the serial
    ``serve_case_*`` rows above time per-case `predict_case` calls for
    comparison (the pipeline overlaps case i+1's host work with case i's
    device compute, so backlog wall/case < serial per-case wall)."""
    import tempfile

    import jax
    import jax.numpy as jnp

    from fetal_mri_segmentation_tpu.config import Config
    from fetal_mri_segmentation_tpu.inference.serve import watch_and_predict
    from fetal_mri_segmentation_tpu.models import build_model
    from fetal_mri_segmentation_tpu.ops.resample import DevicePreprocessor
    from fetal_mri_segmentation_tpu.parallel.spatial import (
        make_direct_predictor)
    from fetal_mri_segmentation_tpu.utils.nifti import save_nifti

    config = Config(model_name="unet", depth=4, n_base_filters=32,
                    image_shape=VOLUME, patch_shape=PATCH,
                    compute_dtype="bfloat16")
    model = build_model(config)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1,) + PATCH + (1,), jnp.float32))
    predictor = make_direct_predictor(model, config)
    device_pre = DevicePreprocessor(config.image_shape, config.normalization,
                                    compute_dtype=jnp.bfloat16,
                                    transfer_dtype=jnp.bfloat16)
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as d:
        watch, out = os.path.join(d, "in"), os.path.join(d, "out")
        os.makedirs(watch)
        # croppable scanner-resolution volumes (the reference's data shape)
        for i in range(n_cases):
            case = os.path.join(watch, f"case_{i}")
            os.makedirs(case)
            vol = np.zeros(raw_shape, np.float32)
            box = tuple(slice(int(0.17 * n), int(0.80 * n))
                        for n in raw_shape)
            vol[box] = rng.normal(200, 50, [s.stop - s.start for s in box]
                                  ).astype(np.float32)
            save_nifti(vol, os.path.join(case, "volume.nii.gz"))
        # warm the compile on a copy of case_0 in a separate sweep so the
        # timed backlog measures steady state
        warm = os.path.join(d, "warm")
        os.makedirs(os.path.join(warm))
        import shutil
        shutil.copytree(os.path.join(watch, "case_0"),
                        os.path.join(warm, "case_w"))
        nw = watch_and_predict(warm, out, model, variables, config,
                               predictor, once=True, verbose=False,
                               device_pre=device_pre)
        if nw != 1:
            # watch_and_predict quarantines per-case failures instead of
            # raising; an un-warmed timed sweep would fold the first
            # compile into its first case and record it as steady state
            raise RuntimeError(
                f"serve-backlog warm sweep predicted {nw}/1 cases — refusing "
                "to time a cold backlog (check the quarantine dir)")
        t0 = time.perf_counter()
        n = watch_and_predict(watch, out, model, variables, config,
                              predictor, once=True, verbose=False,
                              device_pre=device_pre)
        dt = time.perf_counter() - t0
    assert n == n_cases, n
    return round(dt / n_cases, 5)


def _prob_batch_rows(n_cases=8):
    """--prob-map batch throughput: the pipelined probability stream
    (fp32 D2H, the opt-in fp16-packed and uint8 fixed-point transfers),
    sec/case — the K-model-ensemble workflow's unit of work."""
    import tempfile

    import jax
    import jax.numpy as jnp

    from fetal_mri_segmentation_tpu.config import Config
    from fetal_mri_segmentation_tpu.inference import SlidingWindowPredictor
    from fetal_mri_segmentation_tpu.inference.predict import (
        predict_cases_pipelined)
    from fetal_mri_segmentation_tpu.models import build_model
    from fetal_mri_segmentation_tpu.utils.nifti import save_nifti

    config = Config(model_name="unet", depth=3, n_base_filters=32,
                    image_shape=VOLUME, patch_shape=PATCH,
                    compute_dtype="bfloat16")
    model = build_model(config)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1,) + PATCH + (1,), jnp.float32))
    predictor = SlidingWindowPredictor(model, config, image_shape=VOLUME,
                                       patch_shape=PATCH, overlap=OVERLAP,
                                       patch_batch_size=27)
    rng = np.random.default_rng(0)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        cases = []
        for i in range(n_cases):
            case = os.path.join(d, f"case_{i}")
            os.makedirs(case)
            save_nifti(rng.normal(0, 1, VOLUME).astype(np.float32),
                       os.path.join(case, "volume.nii.gz"))
            cases.append(case)
        for dtype, key in (("float32", "prob_batch_sec_per_case_f32"),
                           ("float16", "prob_batch_sec_per_case_f16"),
                           ("uint8", "prob_batch_sec_per_case_u8")):
            pairs = [(c, os.path.join(d, f"out_{dtype}", f"case_{i}"))
                     for i, c in enumerate(cases)]
            # compile warmup on the first case alone
            predict_cases_pipelined(pairs[:1], model, variables, config,
                                    predictor, verbose=False,
                                    save_inputs=False,
                                    output_label_map=False, prob_dtype=dtype)
            t0 = time.perf_counter()
            n = predict_cases_pipelined(pairs, model, variables, config,
                                        predictor, verbose=False,
                                        save_inputs=False,
                                        output_label_map=False,
                                        prob_dtype=dtype)
            out[key] = round((time.perf_counter() - t0) / n, 5)
    return out


def _distort_step_rows():
    """Scale-distortion augmentation cost (VERDICT round-3 item 4): the
    train step with distort=0.25 ON vs the flip/permute/contrast trio, at
    B=1 and B=8 — how much the trilinear gathers cost."""
    import jax
    import jax.numpy as jnp

    from fetal_mri_segmentation_tpu.config import Config
    from fetal_mri_segmentation_tpu.models import build_model
    from fetal_mri_segmentation_tpu.training import (create_train_state,
                                                     make_train_step)

    rng = np.random.default_rng(0)
    out = {}
    for B in (1, 8):
        for distort, key in ((None, f"train_step_b{B}_aug_sec"),
                             (0.25, f"train_step_b{B}_aug_distort_sec")):
            config = Config(model_name="unet", depth=3, n_base_filters=32,
                            patch_shape=PATCH, batch_size=B,
                            augment=True, flip=True, permute=True,
                            contrast=0.1, distort=distort,
                            compute_dtype="bfloat16",
                            initial_learning_rate=1e-5)
            model = build_model(config)
            state = create_train_state(model, config, jax.random.PRNGKey(0))
            step = make_train_step(model, config)
            y = (rng.random((B, 1) + PATCH) > 0.7).astype(np.float32)
            x = (y * 2 + rng.normal(0, 0.3, y.shape)).astype(np.float32)
            x, y = jnp.asarray(x), jnp.asarray(y)
            key_rng = jax.random.PRNGKey(1)
            state, m = step(state, x, y, key_rng, None)
            jax.block_until_ready(m["loss"])  # compile
            t0 = time.perf_counter()
            for _ in range(10):
                state, m = step(state, x, y, key_rng, None)
            jax.block_until_ready(m["loss"])
            out[key] = round((time.perf_counter() - t0) / 10, 5)
    return out


def _direct_volume_infer():
    """Beyond-parity serving mode: ONE whole-volume forward (no patch grid,
    no overlap recompute) on one device — `predict.py --direct`'s program
    (forward + threshold), timed on distinct volumes with
    block_until_ready. Device-side labels; no D2H."""
    import jax
    import jax.numpy as jnp

    from fetal_mri_segmentation_tpu.config import Config
    from fetal_mri_segmentation_tpu.models import build_model

    config = Config(model_name="unet", depth=3, n_base_filters=32,
                    patch_shape=PATCH, image_shape=VOLUME, batch_size=1,
                    compute_dtype="bfloat16")
    model = build_model(config)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1,) + PATCH + (1,), jnp.float32))

    @jax.jit
    def labels(variables, vol):
        x = jnp.transpose(vol, (1, 2, 3, 0))[None]
        return (model.apply(variables, x)[0, ..., 0] > 0.5).astype(jnp.uint8)

    rng = np.random.default_rng(0)
    vols = [jnp.asarray(rng.normal(0, 1, (1,) + VOLUME).astype(np.float32))
            for _ in range(11)]
    jax.block_until_ready(labels(variables, vols[0]))  # compile
    t0 = time.perf_counter()
    for v in vols[1:]:
        out = labels(variables, v)
    jax.block_until_ready(out)
    return round((time.perf_counter() - t0) / (len(vols) - 1), 5)


def _device_info():
    """The device as JAX reports it, plus the card's name and power limit
    (nvidia-smi); exits non-zero when no GPU is visible."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: no GPU visible (found {dev.platform}) — this "
                 "benchmark measures the GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
            "nvidia_smi": smi.stdout.strip().splitlines()[0]
            if smi.returncode == 0 and smi.stdout.strip() else None}


def main():
    from fetal_mri_segmentation_tpu.utils.compilation_cache import enable_compilation_cache
    enable_compilation_cache()
    # host-load annotation: host-path rows (serving, prob-map batches,
    # device-ingest) swing with background load on a shared host;
    # recording loadavg before AND after lets a reader tell a regression
    # from a busy host.
    load_before = os.getloadavg()
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, choices=[1, 2, 3, 4],
                    help="measure a single BASELINE config")
    ap.add_argument("--quick", action="store_true",
                    help="composite (configs 1+3) only")
    args = ap.parse_args()
    device = _device_info()

    if args.config in (1, 3):
        res = _composite("unet", augment=False)
        print(json.dumps({"metric": "config1+3 composite", **res,
                          "device": device}))
        return
    if args.config == 2:
        res = _composite("unet", augment=True)
        print(json.dumps({"metric": "config2 augmented composite", **res,
                          "device": device}))
        return
    if args.config == 4:
        res = _composite("isensee", augment=False)
        print(json.dumps({"metric": "config4 isensee composite", **res,
                          "device": device}))
        return

    base = _composite("unet", augment=False)
    detail = {
        "train_step_sec": base["train_step_sec"],
        "whole_volume_infer_sec": base["whole_volume_infer_sec"],
    }
    if not args.quick:
        detail["config2_augmented"] = _composite("unet", augment=True)
        detail["config4_isensee"] = _composite("isensee", augment=False)
        # beyond-parity direct serving mode (predict.py --direct); device
        # time — not part of the composite (config #3 is defined as
        # sliding-window + Gaussian overlap-add)
        detail["direct_volume_infer_sec"] = _direct_volume_infer()
        # streaming-serving unit of work (serve.py): raw NIfTI -> label map
        detail["serve_case_sec"] = _serve_case_sec()
        # scanner-resolution ingest (crop + zoom actually run): host path
        # vs zoom+normalize on the device (ops/resample.py)
        raw = (170, 170, 110)
        detail["serve_case_resample_sec"] = _serve_case_sec(
            raw_shape=raw, croppable=True)
        detail["serve_case_resample_device_sec"] = _serve_case_sec(
            raw_shape=raw, device_preprocess=True, croppable=True)
        # PIPELINED serving backlog (the actual serve.py claim): 8-case
        # once=True sweep with direct predictor + device preprocessing
        detail["serve_backlog_sec_per_case"] = _serve_backlog_sec_per_case()
        # --prob-map batch throughput (ensembling workflows), fp32 vs the
        # opt-in fp16-packed D2H
        detail.update(_prob_batch_rows())
        # distortion-augmentation cost (PARITY deviation, now measured)
        detail.update(_distort_step_rows())
        # throughput-shape training rows (BASELINE #1 pins B=1; these show
        # the realistic epoch shape) + a REAL train.py epoch's logged rate
        detail.update(_batched_train_steps())
        detail["real_epoch"] = _real_epoch_row()
        # TTA cost rows (48-symmetry ~48x forward; flips subgroup ~6x less)
        detail.update(_tta_volume_secs())

    load_after = os.getloadavg()
    detail["host_loadavg"] = {"before": [round(v, 2) for v in load_before],
                              "after": [round(v, 2) for v in load_after]}

    vs_baseline = None
    base_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "baseline_cpu_keras.json")
    if os.path.exists(base_path):
        with open(base_path) as f:
            cpu = json.load(f)
        vs_baseline = base["volumes_per_sec"] / cpu["composite_volumes_per_sec"]

    result = {
        "metric": "volumes/sec end-to-end fetal-brain seg (8x 64^3 train "
                  "steps + whole-volume Gaussian sliding-window infer, "
                  "pipelined stream)",
        "value": base["volumes_per_sec"],
        "unit": "volumes/sec",
        "vs_baseline": round(vs_baseline, 2) if vs_baseline else None,
        "detail": detail,
        "device": device,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
