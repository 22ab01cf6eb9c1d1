"""Data-parallel training over a 1-D device mesh (gradient all-reduce).

The reference has NO parallelism — one Python process, one device
(SURVEY.md section 2 parallelism rows). This module is the net-new
counterpart required by BASELINE config #5:

- ``Mesh(devices, ("data",))`` — batch sharded over the mesh, params and
  optimizer state replicated;
- the jitted train step runs under ``jax.shard_map``; gradients (and
  BatchNorm stats) are ``pmean``-reduced over the ``data`` axis — XLA hands
  the all-reduce to NCCL, over NVLink between the GPUs of one host
  (`jax.distributed.initialize()` extends the same code path multi-host).
  No hand-written transport, per the scaling-book recipe:
  annotate shardings, let XLA insert collectives.
- the SAME step function serves 1..N devices; N=1 compiles the collective
  away.

Per-shard RNG: the step folds the mesh position into the augmentation key so
each shard augments its sub-batch differently — bitwise-reproducible for a
fixed (key, mesh) regardless of N.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fetal_mri_segmentation_tpu.training.train_step import (
    make_eval_step, make_train_step)


def make_mesh(num_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D data-parallel mesh over the first `num_devices` visible devices."""
    devices = list(devices if devices is not None else jax.devices())
    if num_devices is not None:
        if len(devices) < num_devices:
            # slicing would silently run on fewer devices than the user
            # asked for (e.g. predict.py --num-devices 8 on a 1-chip host)
            raise ValueError(f"requested {num_devices} devices, have "
                             f"{len(devices)}")
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), ("data",))


def shard_batch(mesh: Mesh, *arrays):
    """Place host arrays with batch-axis sharding over the mesh."""
    n = len(mesh.devices.flat)
    for a in arrays:
        if a.shape[0] % n != 0:
            raise ValueError(
                f"global batch size {a.shape[0]} is not divisible by the "
                f"{n}-device data mesh — pick batch_size as a multiple of "
                f"the device count")
    sharding = NamedSharding(mesh, P("data"))
    out = tuple(jax.device_put(a, sharding) for a in arrays)
    return out if len(out) > 1 else out[0]


def replicate_state(mesh: Mesh, state):
    """Replicate the train state over the mesh (params/opt on every chip)."""
    sharding = NamedSharding(mesh, P())
    return jax.device_put(state, sharding)


def unreplicate(x):
    """Fetch one logical copy to host (replicated arrays are singletons)."""
    return jax.device_get(x)


def _shardwise(inner: Callable) -> Callable:
    """Wrap a per-shard step: fold mesh position into the RNG and localize
    the valid-sample count for final-partial-batch masking."""

    def shard_fn(state, x, y, rng, n_valid):
        i = jax.lax.axis_index("data")
        rng = jax.random.fold_in(rng, i)
        local_b = x.shape[0]
        local_valid = jnp.clip(n_valid - i * local_b, 0, local_b)
        return inner(state, x, y, rng, local_valid)

    return shard_fn


def make_dp_train_step(model, config, mesh: Mesh, *,
                       debug_return_batch: bool = False) -> Callable:
    """``step(state, x, y, rng, n_valid) -> (state, metrics)`` over the mesh.

    Inputs: `state` replicated, `x`/`y` globally-shaped with batch sharded on
    "data" (use `shard_batch`), `rng` a single key, `n_valid` the number of
    real samples in the global batch.

    BatchNorm under DP is SYNC-BN: the model is rebuilt with
    ``bn_axis_name="data"`` so the norm moments are computed over the GLOBAL
    batch (XLA all-reduce inside the step) — bitwise-matching the
    single-device step on the same global batch, not per-shard statistics.

    ``debug_return_batch``: step additionally returns the sharded
    post-augment ``(x, y)`` (test hook for per-shard RNG divergence).
    """
    if getattr(config, "batch_normalization", False):
        from fetal_mri_segmentation_tpu.models import build_model
        model = build_model(config, bn_axis_name="data")
    inner = make_train_step(model, config, axis_name="data", jit=False,
                            debug_return_batch=debug_return_batch)
    shard_fn = _shardwise(inner)

    out_specs = (P(), P(), P("data")) if debug_return_batch else (P(), P())
    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P("data"), P("data"), P(), P()),
        out_specs=out_specs)
    return jax.jit(mapped, donate_argnums=(0,))


def make_dp_eval_step(model, config, mesh: Mesh) -> Callable:
    """Mesh-parallel eval step; metrics pmean'd over shards."""
    inner = make_eval_step(model, config, jit=False)

    def shard_fn(state, x, y, n_valid):
        i = jax.lax.axis_index("data")
        local_b = x.shape[0]
        local_valid = jnp.clip(n_valid - i * local_b, 0, local_b)
        # axis_name="data": the loss/dice psum their partial sums internally,
        # so every shard returns the identical GLOBAL metric values.
        return inner(state, x, y, local_valid, axis_name="data")

    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P("data"), P("data"), P()),
        out_specs=P())
    return jax.jit(mapped)
