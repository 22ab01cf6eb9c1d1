#!/usr/bin/env python
"""GPU smoke run of the system's main paths, through the entry points a
user calls, at the full width of ``configs/fetal_unet.json``.

    python chip_smoke.py            # one GPU: device, train, predict, serve
    python chip_smoke.py --multi    # four GPUs: DP step + spatial predictor

Phases (one process owns the card; any failure propagates and the script
exits non-zero):

- device: JAX must report GPUs (no CPU fallback); prints the device kind and
  count, and the card's name and power limit from nvidia-smi.
- train: ``train.main`` (device case cache "auto", the shipped default)
  for one epoch on seeded
  synthetic ellipsoid volumes — the flagship UNet3D (depth 4, 32 base
  filters, 64^3 patches, batch 6, 128^3 images, flip/permute/contrast
  augmentation, bf16), then the Isensee family at
  ``configs/fetal_isensee.json`` widths (depth 5). Losses must be finite;
  the best checkpoint must restore to the trained state exactly.
- predict: on a 128^3 volume, the sliding-window predictor (overlap 16,
  Gaussian overlap-add, device label pack), the direct whole-volume
  predictor, and the direct predictor with flip TTA, each against the
  plain float32 reference (models/reference.py); plus the float32 model
  against the reference. Per-program wall times are printed beside the
  card name, for information.
- serve: ``serve.main`` (direct predictor, device preprocessing) on two
  seeded NIfTI cases at scanner size 170x170x110; each must get a label
  map in the model's 128^3 image space.
- multi (``--multi`` only, and then alone): the data-parallel train step
  over four cards against the same global batch on one card, and the
  spatially sharded predictor over a 1-D four-card mesh against the
  one-card direct predictor, both at flagship widths in float32 compute
  (the check is of the collectives, so the tighter dtype).

Tolerances (the reason for each is in docs/PERF.md, "H100 bring-up"):
label maps agree with the reference's at Dice >= LABEL_DICE_MIN; the
probabilities of the bf16 programs within BF16_PROB_ATOL of the reference,
of the float32 model within F32_PROB_ATOL.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

#: Dice between a program's label map and the reference's
LABEL_DICE_MIN = 0.99
#: max |p - p_ref| for bf16-compute programs (8-bit mantissa activations)
BF16_PROB_ATOL = 0.1
#: max |p - p_ref| for the float32 model (TF32 convolutions on the GPU)
F32_PROB_ATOL = 0.02
#: DP vs one card (float32 compute, TF32 convolutions, the two sides free
#: to pick different conv algorithms): loss relative difference, and the
#: gradient's relative L2 error over all parameters — a collective that
#: dropped or double-counted a shard errs by >= 1/4 of the norm
DP_LOSS_RTOL = 1e-3
DP_GRAD_RTOL = 1e-2

SERVE_RAW_SHAPE = (170, 170, 110)


def phases(multi: bool):
    """The phases a run executes, in order."""
    return ["device", "multi"] if multi else ["device", "train", "predict",
                                              "serve"]


def result_line(platform: str, kind: str, count: int) -> str:
    """The last line of a successful run."""
    return json.dumps({"ok": True, "device": {"platform": platform,
                                              "kind": kind, "count": count}})


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_device(n_devices: int):
    """The first ``n_devices`` GPUs; exits non-zero when there are fewer."""
    import jax

    devices = jax.devices()
    gpus = [d for d in devices if d.platform == "gpu"]
    if len(gpus) < n_devices:
        raise SystemExit(
            f"chip_smoke: needs {n_devices} GPU(s), JAX reports "
            f"{[d.platform for d in devices]}")
    card = nvidia_smi()
    print(f"[device] {gpus[0].device_kind} x{len(gpus)} "
          f"(platform {gpus[0].platform}); nvidia-smi: {card}", flush=True)
    return gpus[:n_devices], card


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _synthetic():
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import synthetic
    return synthetic


def load_config(name: str, workdir: str, **overrides):
    """``configs/<name>.json`` with its files under ``workdir``, one epoch,
    one device, a fresh start."""
    from fetal_mri_segmentation_tpu.config import Config

    cfg = Config.load(os.path.join(REPO, "configs", name + ".json"))
    stem = os.path.join(workdir, cfg.model_name)
    for key, value in dict(
            model_file=stem + ".ckpt", training_file=stem + "_train.pkl",
            validation_file=stem + "_val.pkl",
            training_log=stem + "_training.log", data_file=stem + ".h5",
            n_epochs=1, num_devices=1, device_case_cache="auto",
            overwrite=True, **overrides).items():
        setattr(cfg, key, value)
    cfg.__post_init__()
    return cfg


def dice(a, b) -> float:
    a, b = np.asarray(a) > 0, np.asarray(b) > 0
    denom = a.sum() + b.sum()
    return 1.0 if denom == 0 else float(2 * (a & b).sum() / denom)


def _timed(fn, *args):
    """(result, seconds) of a second call after a warm-up call."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def _memory() -> str:
    """The device's memory limit and peak use so far, as JAX reports it."""
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return ", ".join(f"{k} {stats[k] / 2**30:.2f} GiB"
                     for k in ("bytes_limit", "peak_bytes_in_use")
                     if k in stats) or "no memory stats"


def _tree_equal(a, b) -> bool:
    import jax

    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_train(workdir: str, seed: int = 0, n_cases: int = 8, **overrides):
    """Train the flagship unet and the Isensee family for one epoch each;
    returns the unet config and its trained state."""
    import csv

    import train
    from fetal_mri_segmentation_tpu.models import build_model
    from fetal_mri_segmentation_tpu.training import load_old_model

    synthetic = _synthetic()
    result = None
    for name in ("fetal_unet", "fetal_isensee"):
        cfg = load_config(name, workdir, **overrides)
        data = synthetic.synthetic_data_file(
            n_cases=n_cases, shape=cfg.image_shape, seed=seed)
        t0 = time.perf_counter()
        state = train.main(cfg, None, seed=seed, data_file=data)
        wall = time.perf_counter() - t0
        with open(cfg.training_log) as f:
            row = list(csv.DictReader(f))[-1]
        losses = {k: float(row[k]) for k in ("loss", "val_loss")}
        steps = int(state.step)
        if steps < 4 or not all(np.isfinite(v) for v in losses.values()):
            raise RuntimeError(f"[train] {cfg.model_name}: {steps} steps, "
                               f"losses {losses}")
        restored, epoch, _ = load_old_model(cfg.model_file,
                                            build_model(cfg), cfg)
        for part in ("params", "opt_state", "batch_stats", "step"):
            if not _tree_equal(getattr(state, part), getattr(restored, part)):
                raise RuntimeError(f"[train] {cfg.model_name}: restored "
                                   f"{part} differs from the trained state")
        print(f"[train] {cfg.model_name} depth {cfg.depth} "
              f"{cfg.n_base_filters} filters batch {cfg.batch_size} "
              f"patch {cfg.patch_shape} {cfg.compute_dtype}: {steps} steps, "
              f"loss {losses['loss']:.5f} val_loss {losses['val_loss']:.5f}, "
              f"checkpoint restored equal (epoch {epoch}); "
              f"{wall:.1f} s wall incl. compile; {_memory()}", flush=True)
        if name == "fetal_unet":
            result = (cfg, state)
    return result


def _flip_average(fn, vol):
    """Mean of ``fn`` over the 8 axis flips of an NDHWC volume."""
    import itertools

    import jax.numpy as jnp

    acc = 0.0
    for axes in itertools.chain.from_iterable(
            itertools.combinations((1, 2, 3), k) for k in range(4)):
        y = fn(jnp.flip(vol, axes) if axes else vol)
        acc = acc + (jnp.flip(y, axes) if axes else y)
    return acc / 8.0


def phase_predict(cfg, state, card: str, seed: int = 0):
    """Each predictor against the plain float32 reference on one volume."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from fetal_mri_segmentation_tpu.inference import SlidingWindowPredictor
    from fetal_mri_segmentation_tpu.models import build_model
    from fetal_mri_segmentation_tpu.models.reference import (
        reference_forward, reference_sliding_window)
    from fetal_mri_segmentation_tpu.parallel import make_direct_predictor

    synthetic = _synthetic()
    model = build_model(cfg)
    variables = {"params": state.params}
    vol = synthetic.synthetic_data_file(
        1, cfg.image_shape, seed=seed + 1000).root.data[0]  # (1, D, H, W)
    x = jnp.asarray(np.transpose(vol, (1, 2, 3, 0))[None])
    ref_fwd = jax.jit(lambda v, a: reference_forward(cfg, v, a))
    ref_direct = np.asarray(ref_fwd(variables, x))[0, ..., 0]
    ref_flips = np.asarray(_flip_average(
        lambda a: ref_fwd(variables, a), x))[0, ..., 0]
    overlap = cfg.validation_patch_overlap
    ref_window = reference_sliding_window(cfg, variables, vol,
                                          overlap=overlap)[0]

    sliding = SlidingWindowPredictor(model, cfg, image_shape=cfg.image_shape,
                                     overlap=overlap, patch_batch_size=8,
                                     use_gaussian=True)
    f32_cfg = dataclasses.replace(cfg, compute_dtype="float32")
    programs = [
        ("sliding_window", sliding, ref_window, BF16_PROB_ATOL),
        ("direct", make_direct_predictor(model, cfg), ref_direct,
         BF16_PROB_ATOL),
        ("direct_tta_flips", make_direct_predictor(model, cfg, tta="flips"),
         ref_flips, BF16_PROB_ATOL),
        ("direct_f32", make_direct_predictor(build_model(f32_cfg), f32_cfg),
         ref_direct, F32_PROB_ATOL),
    ]
    report = {}
    for name, predictor, ref, atol in programs:
        prob = np.asarray(predictor(variables, vol))[0]
        labels, sec = _timed(
            lambda v: predictor.predict_labels_async(variables, v), vol)
        labels = predictor.unpack_labels(labels)
        d = dice(labels, ref > 0.5)
        err = float(np.abs(prob - ref).max())
        report[name] = {"dice": d, "max_abs_prob_diff": err, "sec": sec}
        print(f"[predict] {name}: dice vs reference {d:.5f}, max |p - "
              f"p_ref| {err:.3e} (limit {atol}), foreground "
              f"{int((labels > 0).sum())} voxels; {sec * 1e3:.1f} ms per "
              f"volume on {card}", flush=True)
        if labels.shape != tuple(cfg.image_shape):
            raise RuntimeError(f"[predict] {name}: labels {labels.shape}")
        if d < LABEL_DICE_MIN or err > atol:
            raise RuntimeError(f"[predict] {name} disagrees with the "
                               f"reference: dice {d}, max diff {err}")
    return report


def _write_scanner_case(path: str, rng, shape) -> None:
    """A croppable scanner-size volume: an ellipsoid 'brain' with noisy
    intensity inside a zero background."""
    from fetal_mri_segmentation_tpu.utils.nifti import save_nifti

    grids = np.mgrid[tuple(slice(0, n) for n in shape)]
    center = np.asarray(shape) / 2 + rng.uniform(-4, 4, 3)
    radii = np.asarray(shape) * rng.uniform(0.2, 0.3, 3)
    inside = sum(((g - c) / r) ** 2 for g, c, r in zip(grids, center,
                                                      radii)) < 1
    vol = np.zeros(shape, np.float32)
    box = tuple(slice(int(0.15 * n), int(0.85 * n)) for n in shape)
    vol[box] = rng.normal(100, 20, [s.stop - s.start for s in box])
    vol[inside] += 200
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_nifti(vol, path, affine=np.diag([0.8, 0.8, 2.0, 1.0]))


def phase_serve(cfg, workdir: str, card: str, seed: int = 0,
                raw_shape=SERVE_RAW_SHAPE, n_cases: int = 2):
    """``serve.main --direct --device-preprocess --once`` over seeded cases."""
    import serve
    from fetal_mri_segmentation_tpu.utils.nifti import load_nifti

    rng = np.random.default_rng(seed)
    watch = os.path.join(workdir, "incoming")
    out = os.path.join(workdir, "served")
    for i in range(n_cases):
        _write_scanner_case(os.path.join(watch, f"case_{i}", "volume.nii.gz"),
                            rng, raw_shape)
    t0 = time.perf_counter()
    serve.main(cfg, watch, out, direct=True, once=True,
               device_preprocess=True)
    wall = time.perf_counter() - t0
    for i in range(n_cases):
        pred = load_nifti(os.path.join(out, f"case_{i}", "prediction.nii.gz"))
        labels = np.asarray(pred.get_fdata())
        # the label map lives in the model's (resampled) image space, as
        # the dataset builder and the reference write it
        if labels.shape != tuple(cfg.image_shape):
            raise RuntimeError(f"[serve] case_{i}: label map {labels.shape}"
                               f", expected {cfg.image_shape}")
        print(f"[serve] case_{i} ({raw_shape}): label map {labels.shape}, "
              f"{int((labels > 0).sum())} foreground voxels", flush=True)
    print(f"[serve] {n_cases} cases in {wall:.2f} s wall incl. compile on "
          f"{card}", flush=True)


def phase_multi(devices, workdir: str, card: str, seed: int = 0,
                batch: int = 8, **overrides):
    """DP step over ``devices`` vs one device; spatially sharded predictor
    over a 1-D mesh of ``devices`` vs the one-device direct predictor."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    from fetal_mri_segmentation_tpu.models import build_model
    from fetal_mri_segmentation_tpu.parallel import (
        make_direct_predictor, make_dp_train_step, make_mesh,
        make_spatial_predictor, replicate_state, shard_batch)
    from fetal_mri_segmentation_tpu.training import (create_train_state,
                                                     make_train_step)

    n = len(devices)
    overrides.setdefault("compute_dtype", "float32")
    cfg = load_config("fetal_unet", workdir, batch_size=batch,
                      augment=False, **overrides)
    model = build_model(cfg)
    synthetic = _synthetic()
    data = synthetic.synthetic_data_file(batch, cfg.patch_shape, seed=seed)
    x = np.asarray(data.root.data[:], np.float32)
    y = np.asarray(data.root.truth[:], np.float32)
    key = jax.random.PRNGKey(seed + 7)
    # plain SGD(1): the parameter delta IS the gradient, so the comparison
    # is of gradients (post-Adam params are ~lr*sign(g) on step one)
    tx = optax.sgd(1.0)

    def fresh():
        return create_train_state(model, cfg, jax.random.PRNGKey(seed),
                                  tx=tx)

    s0 = jax.device_get(fresh().params)
    one = jax.device_put(fresh(), devices[0])
    new1, m1 = make_train_step(model, cfg)(
        one, jax.device_put(jnp.asarray(x), devices[0]),
        jax.device_put(jnp.asarray(y), devices[0]), key, batch)
    mesh = make_mesh(n, devices)
    stepn = make_dp_train_step(model, cfg, mesh)
    newn, mn = stepn(replicate_state(mesh, fresh()),
                     *shard_batch(mesh, x, y), key, jnp.asarray(batch))
    l1, ln = float(m1["loss"]), float(mn["loss"])
    loss_rel = abs(l1 - ln) / max(abs(l1), 1e-12)
    sq_err = sq_ref = 0.0
    for p0, a, b in zip(jax.tree_util.tree_leaves(s0),
                        jax.tree_util.tree_leaves(jax.device_get(new1.params)),
                        jax.tree_util.tree_leaves(jax.device_get(newn.params))):
        g1, gn = p0 - np.asarray(a), p0 - np.asarray(b)
        sq_err += float(np.sum((g1 - gn) ** 2))
        sq_ref += float(np.sum(g1 ** 2))
    grad_rel = (sq_err / max(sq_ref, 1e-30)) ** 0.5
    print(f"[multi] DP step over {n} devices vs 1 (global batch {batch}, "
          f"{cfg.compute_dtype}): loss {l1:.6f} vs {ln:.6f} (rel "
          f"{loss_rel:.2e}, limit {DP_LOSS_RTOL}); gradient relative L2 "
          f"error {grad_rel:.2e} (limit {DP_GRAD_RTOL}) on {card}",
          flush=True)
    if loss_rel > DP_LOSS_RTOL or grad_rel > DP_GRAD_RTOL:
        raise RuntimeError("[multi] DP step disagrees with one device")

    variables = {"params": new1.params}
    vol = synthetic.synthetic_data_file(
        1, cfg.image_shape, seed=seed + 1000).root.data[0]
    spatial = make_spatial_predictor(model, cfg,
                                     Mesh(np.asarray(devices), ("spatial",)))
    direct = make_direct_predictor(model, cfg)
    p_n = np.asarray(spatial(variables, vol))[0]
    p_1 = np.asarray(direct(variables, vol))[0]
    err = float(np.abs(p_n - p_1).max())
    d = dice(p_n > 0.5, p_1 > 0.5)
    print(f"[multi] spatial predictor over a 1-D {n}-device mesh vs direct "
          f"on 1: max |p - p_1| {err:.3e} (limit {F32_PROB_ATOL}), label "
          f"dice {d:.5f} on {card}", flush=True)
    if err > F32_PROB_ATOL or d < LABEL_DICE_MIN:
        raise RuntimeError("[multi] spatial predictor disagrees with one "
                           "device")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU phases")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    devices, card = phase_device(4 if args.multi else 1)
    from fetal_mri_segmentation_tpu.utils.compilation_cache import (
        enable_compilation_cache)
    enable_compilation_cache()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        trained = None  # (unet config, trained state) from "train"
        for phase in phases(args.multi)[1:]:
            if phase == "multi":
                phase_multi(devices, workdir, card, seed=args.seed)
            elif phase == "train":
                trained = phase_train(workdir, seed=args.seed)
            elif phase == "predict":
                phase_predict(*trained, card, seed=args.seed)
            elif phase == "serve":
                phase_serve(trained[0], workdir, card, seed=args.seed)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(card)
    print(result_line(devices[0].platform, devices[0].device_kind,
                      len(devices)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
