"""Epoch-driver: the functional replacement for Keras ``fit_generator``.

Reference: unet3d/training.py::train_model — fit_generator(steps_per_epoch,
epochs≈500) with callbacks {ModelCheckpoint(best-only), CSVLogger,
LearningRateScheduler(step_decay) | ReduceLROnPlateau, EarlyStopping}.

Design: one jitted train step (augmentation fused, see training/train_step.py)
fed by a background-prefetching generator; epoch-level control (LR schedule,
early stop, best-checkpoint) stays in Python — it runs once per epoch, so
host control flow costs nothing. Multi-device: pass a Mesh and the loop
shards each batch and uses the shard_map step (parallel/data_parallel.py).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, Optional

import jax
import jax.numpy as jnp
import numpy as np

from fetal_mri_segmentation_tpu.pipeline.prefetch import prefetch
from fetal_mri_segmentation_tpu.training.callbacks import (
    CSVLogger, EarlyStopping, ReduceLROnPlateau, ThroughputMeter, step_decay)
from fetal_mri_segmentation_tpu.training.checkpoint import CheckpointIO
from fetal_mri_segmentation_tpu.training.state import TrainState
from fetal_mri_segmentation_tpu.training.train_step import (
    make_eval_step, make_train_step, pad_batch)


def _weighted_mean(values, weights) -> float:
    w = np.asarray(weights, np.float64)
    v = np.asarray(values, np.float64)
    return float((v * w).sum() / max(w.sum(), 1e-12))


def detect_dice_collapse(dice_history, *, patience: int = 3,
                         threshold: float = 0.01) -> bool:
    """True when training dice has been ~0 for `patience` consecutive epochs.

    Soft-Dice + sigmoid has a silent failure mode shared with the Keras
    reference: a too-large learning rate saturates the logits within the
    first epochs, the dice gradient vanishes, and the run sits at
    dice ≈ 0 forever while the loss looks "stable". (Observed concretely:
    this synthetic quality loop converges to 0.98+ at the default
    initial_learning_rate=5e-4 but flatlines at dice ≈ 2e-4 at 5e-3.)
    The loop surfaces this as an explicit warning instead of letting the
    user burn a full epoch budget.
    """
    if len(dice_history) < patience:
        return False
    return all(d < threshold for d in dice_history[-patience:])


def train_model(model, state: TrainState, config,
                training_generator: Iterator, validation_generator: Iterator,
                steps_per_epoch: int, validation_steps: int,
                *, mesh=None, seed: int = 0,
                n_epochs: Optional[int] = None,
                device_cache=None,
                verbose: bool = True) -> TrainState:
    """Train until n_epochs or early stopping; returns the final state.

    Mirrors the reference signature semantics (reference: training.py::
    train_model(model, model_file, training_generator, validation_generator,
    steps_per_epoch, validation_steps, initial_learning_rate,
    learning_rate_drop, learning_rate_epochs, n_epochs, learning_rate_patience,
    early_stopping_patience)) with config carrying the scalar knobs.

    ``device_cache``: a pipeline/device_cache.py::DeviceCaseCache — the
    generators must then be index generators yielding
    ``(rows, corners, n_valid)``; patch gather, label conversion and
    augmentation run inside the jitted step and the per-step H2D shrinks
    to ~100 bytes. Supported for single-device and pure data-parallel
    meshes (stacks replicated per shard); spatial/hybrid meshes are not
    (a depth-sharded volume axis would need halo-aware gathers).
    """
    n_epochs = n_epochs if n_epochs is not None else config.n_epochs
    batch_size = config.batch_size
    val_batch_size = config.validation_batch_size or batch_size

    if steps_per_epoch <= 0:
        # without this, the epoch loop body never runs and the metric
        # aggregation crashes with a bare KeyError('loss') — say what is
        # actually wrong
        raise ValueError(
            f"steps_per_epoch={steps_per_epoch}: the training split "
            "produced no (non-blank) patches — check validation_split "
            "(a tiny dataset can round the training share to 0 cases), "
            "skip_blank, and the patch geometry")
    has_validation = validation_steps is not None and validation_steps > 0
    if not has_validation and verbose:
        # a 1-case or unsplit dataset is a legitimate smoke scenario;
        # fabricating val metrics of 0.0 (the old weighted-mean-of-nothing
        # behavior) silently pinned best_val at 0.0 and decayed the LR
        # every `patience` epochs — monitor the training loss instead and
        # say so
        print("[warning] validation_steps == 0 — no validation will run; "
              "best-checkpoint, LR plateau and early stopping monitor the "
              "TRAINING loss for this run")

    # restore BEFORE any replication/sharding of the state: `state` may be
    # the compile-free abstract template (train.py skips the throwaway
    # model.init when a checkpoint exists), which only becomes concrete
    # here.
    ckpt = CheckpointIO(config.model_file)
    start_epoch = 0
    best_val = float("inf")
    sched: dict = {}
    if ckpt.exists() and not config.overwrite:
        state, start_epoch, best_val, sched = ckpt.restore(state)
        if verbose:
            print(f"[resume] epoch {start_epoch}, best val {best_val:.4f}")
        # the .meta.json sidecar is what callers peeked to fast-forward
        # the generators (train.py); if it disagrees with the checkpoint
        # payload (kill between the two writes, or a checkpoint dir
        # copied without its sidecar) the streams are misaligned — data
        # order then differs from an uninterrupted run. Training remains
        # correct; say so instead of silently diverging.
        peeked = ckpt.peek_epoch()
        if peeked is not None and peeked != start_epoch:
            print(f"[resume] warning: checkpoint epoch {start_epoch} != "
                  f"sidecar epoch {peeked} — generator streams were "
                  "fast-forwarded to the sidecar epoch, so the data order "
                  "of this resumed run will not exactly match an "
                  "uninterrupted run (training is otherwise unaffected)")
    if any(isinstance(leaf, jax.ShapeDtypeStruct)
           for leaf in jax.tree_util.tree_leaves(state.params)):
        raise ValueError(
            "train_model got an abstract state template but no checkpoint "
            "to restore from — pass a concrete create_train_state result "
            "(or build the dataset/checkpoint first)")

    if (device_cache is not None and mesh is not None
            and len(mesh.devices.flat) > 1 and "spatial" in mesh.axis_names):
        raise ValueError(
            "device_cache is not supported on spatial/hybrid meshes (a "
            "depth-sharded volume axis would need halo-aware gathers) — "
            "pass device_cache=None and (x, y) generators; "
            "maybe_build_device_cache makes this decision automatically")
    use_cache = device_cache is not None
    partial_cache = use_cache and getattr(device_cache, "partial", False)
    host_train_step = host_eval_step = None
    if partial_cache and mesh is not None and len(mesh.devices.flat) > 1:
        raise ValueError(
            "a partial device cache is single-device only (per-shard host "
            "routing is not implemented) — maybe_build_device_cache makes "
            "this decision automatically")
    if partial_cache:
        # non-resident batches ride the plain host-staging step
        host_train_step = make_train_step(model, config)
        host_eval_step = make_eval_step(model, config)
    if use_cache and mesh is not None and len(mesh.devices.flat) > 1:
        # data-parallel cached path: stacks replicated over the mesh once,
        # per-step index arrays sharded on "data"
        from jax.sharding import NamedSharding, PartitionSpec as P

        from fetal_mri_segmentation_tpu.parallel.data_parallel import (
            replicate_state, shard_batch)
        from fetal_mri_segmentation_tpu.pipeline.device_cache import (
            make_cached_dp_eval_step, make_cached_dp_train_step)
        _cts = make_cached_dp_train_step(model, config, mesh,
                                         device_cache.margin_lo)
        _ces = make_cached_dp_eval_step(model, config, mesh,
                                        device_cache.margin_lo)
        state = replicate_state(mesh, state)
        repl = NamedSharding(mesh, P())
        _ds = jax.device_put(device_cache.data_stack, repl)
        _ts = jax.device_put(device_cache.truth_stack, repl)
        train_step = lambda st, rows, corners, rng, n_valid: _cts(
            st, _ds, _ts, rows, corners, rng, n_valid)
        eval_step = lambda st, rows, corners, n_valid: _ces(
            st, _ds, _ts, rows, corners, n_valid)
        put = lambda arrs: shard_batch(mesh, *arrs)
    elif use_cache:
        from fetal_mri_segmentation_tpu.pipeline.device_cache import (
            make_cached_eval_step, make_cached_train_step)
        _cts = make_cached_train_step(model, config, device_cache.margin_lo)
        _ces = make_cached_eval_step(model, config, device_cache.margin_lo)
        _ds, _ts = device_cache.data_stack, device_cache.truth_stack
        # stacks ride as explicit (already-device-resident) args each call
        train_step = lambda st, rows, corners, rng, n_valid: _cts(
            st, _ds, _ts, rows, corners, rng, n_valid)
        eval_step = lambda st, rows, corners, n_valid: _ces(
            st, _ds, _ts, rows, corners, n_valid)
        put = lambda arrs: tuple(jax.device_put(a) for a in arrs)
    elif (mesh is not None and len(mesh.devices.flat) > 1
            and "spatial" in mesh.axis_names):
        # hybrid data x spatial GSPMD path (parallel/spatial.py): batch on
        # "data", volume depth on "spatial"; XLA inserts halo exchanges +
        # gradient all-reduce. Enables whole-volume training beyond one
        # chip's HBM.
        from fetal_mri_segmentation_tpu.parallel.spatial import (
            make_gspmd_eval_step, make_gspmd_train_step, shard_batch_spatial)
        train_step = make_gspmd_train_step(model, config, mesh)
        eval_step = make_gspmd_eval_step(model, config, mesh)
        put = lambda arrs: shard_batch_spatial(mesh, *arrs)
    elif mesh is not None and len(mesh.devices.flat) > 1:
        from fetal_mri_segmentation_tpu.parallel.data_parallel import (
            make_dp_eval_step, make_dp_train_step, replicate_state, shard_batch)
        train_step = make_dp_train_step(model, config, mesh)
        eval_step = make_dp_eval_step(model, config, mesh)
        state = replicate_state(mesh, state)
        put = lambda arrs: shard_batch(mesh, *arrs)
    else:
        train_step = make_train_step(model, config)
        eval_step = make_eval_step(model, config)
        put = lambda arrs: tuple(jax.device_put(a) for a in arrs)

    csv = CSVLogger(config.training_log, append=True)
    meter = ThroughputMeter(config.patch_shape, config.image_shape)

    # construct schedulers AFTER the restore so a resumed run keeps its
    # (possibly already-dropped) learning rate, best-val history AND its
    # patience counters — an interrupted run must drop the LR / stop at the
    # same epoch an uninterrupted one would (exact resume; the sched dict
    # is empty for legacy checkpoints, falling back to best_val seeding)
    plateau = ReduceLROnPlateau(state.learning_rate,
                                factor=config.learning_rate_drop,
                                patience=config.patience)
    early = EarlyStopping(patience=config.early_stop)
    plateau.best = sched.get("plateau_best", best_val)
    plateau.wait = int(sched.get("plateau_wait", 0))
    early.best = sched.get("early_best", best_val)
    early.wait = int(sched.get("early_wait", 0))

    # epoch k's augmentation/dropout keys are derived fold_in(seed, k) —
    # a pure function of (seed, epoch), NOT one stream split across the
    # whole run — so a resumed run replays the exact keys an uninterrupted
    # run used at that epoch (data-order exact resume, matching the
    # generators' per-epoch rng derivation in pipeline/generator.py)
    base_rng = jax.random.PRNGKey(seed)

    # Compressed batch staging: the per-step H2D of FRESH patches is the
    # real-epoch bottleneck on thin device links (docs/PERF.md round-3
    # addendum 9) — the composite microbench reuses one device-resident
    # batch and never sees it. x rides as bf16 for bf16 models: with
    # augmentation OFF this is bit-exact (the model's first device op is
    # the same cast); with augmentation ON the interpolation operates on
    # bf16-rounded intensities (the ±0.4% quantization the model applies
    # anyway) instead of f32 — a deliberate, quality-neutral trade shared
    # with the device-cache path, NOT bit-identical to f32 staging. y
    # rides as uint8 (one-hot/binary labels are integral; exact), cutting
    # 16 MB/step to ~4.25 MB. The train/eval steps cast back on device
    # (train_step.py). Non-integral y (never produced by the generator
    # contract) falls back to f32 per batch.
    x_bf16 = getattr(model, "dtype", None) == jnp.bfloat16

    def _compress(x, y):
        if x_bf16:
            import ml_dtypes

            x = x.astype(ml_dtypes.bfloat16)
        yb = y.astype(np.uint8)
        if np.array_equal(y, yb):
            y = yb
        return x, y

    def _batches(gen, n_steps, bs):
        """Pad + device_put in the prefetch thread so H2D overlaps compute.

        Every batch is normalized to ``(kind, a, b, n_valid)``: kind "idx"
        = cached-gather indices (rows, corners), kind "host" = staged
        (x, y) patches. Non-partial paths emit a constant kind.
        """
        def producer():
            for _ in range(n_steps):
                if partial_cache:
                    kind, a, b, n_valid = next(gen)
                    if kind == "host":
                        a, b, n_valid = pad_batch(a, b, bs)
                        a, b = _compress(a, b)
                    yield kind, a, b, n_valid
                    continue
                if use_cache:
                    # index generator: already (rows, corners, n_valid)
                    yield ("idx", *next(gen))
                    continue
                x, y = next(gen)
                x, y, n_valid = pad_batch(x, y, bs)
                x, y = _compress(x, y)
                yield "host", x, y, n_valid
        return prefetch(producer(), size=2,
                        device_put=lambda b: (b[0], *put(b[1:3]), b[3]))

    stop = False
    dice_history: list = []
    collapse_warned = False
    for epoch in range(start_epoch, n_epochs):
        # ---- train ----
        rng = jax.random.fold_in(base_rng, epoch)
        meter.reset()
        t0 = time.perf_counter()
        train_metrics, weights = [], []
        for kind, a, b, n_valid in _batches(training_generator,
                                            steps_per_epoch, batch_size):
            rng, k = jax.random.split(rng)
            fn = (host_train_step if (partial_cache and kind == "host")
                  else train_step)
            state, metrics = fn(state, a, b, k, n_valid)
            train_metrics.append(metrics)
            weights.append(n_valid)
            meter.add(n_valid)
        # forced host readback: on some remote runtimes block_until_ready
        # returns before execution completes, which would inflate the
        # logged throughput columns (measured round 3; docs/PERF.md)
        if train_metrics:
            float(train_metrics[-1]["loss"])
        else:
            jax.block_until_ready(state.params)
        train_time = time.perf_counter() - t0
        # capture throughput BEFORE validation runs: the meter counts only
        # training patches, so including validation wall time in the
        # denominator would deflate the BASELINE throughput columns
        rates = meter.rates()

        # ---- validate ----
        val_metrics, vweights = [], []
        if has_validation:
            for kind, a, b, n_valid in _batches(validation_generator,
                                                validation_steps,
                                                val_batch_size):
                fn = (host_eval_step if (partial_cache and kind == "host")
                      else eval_step)
                val_metrics.append(fn(state, a, b, n_valid))
                vweights.append(n_valid)

        def agg(metric_dicts, ws, key):
            return _weighted_mean([float(m[key]) for m in metric_dicts], ws)

        keys = list(train_metrics[0].keys()) if train_metrics else []
        row = {}
        for key in keys:
            name = "dice_coefficient" if key == "dice" else key
            row[name] = agg(train_metrics, weights, key)
            if has_validation:
                row[f"val_{name}"] = agg(val_metrics, vweights, key)
        row.update({
            "lr": state.learning_rate,
            **rates,
            "epoch_time_sec": train_time,
        })
        csv.log(epoch, row)
        if verbose:
            val_part = (f"val_loss={row['val_loss']:.4f} "
                        if has_validation else "")
            print(f"epoch {epoch}: loss={row['loss']:.4f} "
                  f"{val_part}lr={row['lr']:.2e} "
                  f"{row['patches_per_sec']:.1f} patches/s")

        dice_history.append(row.get("dice_coefficient", 1.0))
        if not collapse_warned and detect_dice_collapse(dice_history):
            collapse_warned = True
            print(f"[warning] training dice < 0.01 for the last 3 "
                  f"epochs — the sigmoid has likely "
                  f"saturated and the soft-Dice gradient vanished. Lower "
                  f"initial_learning_rate (current "
                  f"{config.initial_learning_rate:g}; default 5e-4 "
                  f"converges where 5e-3 collapses) and restart with "
                  f"--overwrite.")

        # ---- callbacks (reference: get_callbacks) ----
        # without validation the monitored quantity falls back to the
        # training loss (see the warning at loop start)
        val_loss = row["val_loss"] if has_validation else row["loss"]
        improved = val_loss < best_val
        if improved:
            best_val = val_loss

        if config.learning_rate_epochs:
            new_lr = step_decay(epoch, config.initial_learning_rate,
                                config.learning_rate_drop,
                                config.learning_rate_epochs)
        else:
            new_lr = plateau.update(val_loss)
        if abs(new_lr - state.learning_rate) > 1e-12:
            state = state.set_learning_rate(new_lr)

        if config.early_stop and early.update(val_loss):
            if verbose:
                print(f"[early stop] epoch {epoch}")
            stop = True

        # checkpoint AFTER the scheduler updates so the persisted patience
        # counters (and a coincident LR drop) reflect this epoch's final
        # scheduler state — exact resume. Note: a checkpoint improvement
        # (strict <) is not always a plateau improvement (min_delta), so
        # the counters at a best-epoch are NOT necessarily zero.
        if improved:
            # record the run's data-order mode so a resume reproduces the
            # exact batch boundaries (partial-cache grouping depends on
            # WHICH cases are resident — see CheckpointIO.peek_data_order)
            data_order = (
                {"mode": "partial",
                 "resident": sorted(getattr(device_cache, "resident_cases",
                                            None) or [])}
                if partial_cache else {"mode": "lockstep"})
            ckpt.save(state, epoch=epoch + 1, best_val=best_val,
                      sched={"plateau_best": plateau.best,
                             "plateau_wait": plateau.wait,
                             "early_best": early.best,
                             "early_wait": early.wait},
                      data_order=data_order)
        if stop:
            break

    return state
