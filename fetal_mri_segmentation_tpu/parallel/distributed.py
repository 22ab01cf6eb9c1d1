"""Multi-host initialization + sharded inference over the patch grid.

Reference: ABSENT (single process, single device — SURVEY.md section 5.8).
Equivalents here:

- ``initialize_distributed()``: thin wrapper over
  ``jax.distributed.initialize`` — each process passes the coordinator
  address (``host:port``), the process count and its own id; afterwards
  ``jax.devices()`` spans every process's GPUs and the SAME Mesh/shard_map
  code paths (parallel/data_parallel.py) run multi-host, with XLA handing
  the gradient all-reduce to NCCL (NVLink within a host, the network
  between hosts).
- ``predict_volume_sharded``: sliding-window inference with the PATCH GRID
  sharded over the mesh — embarrassingly parallel (each device predicts a
  contiguous chunk of patch batches and overlap-adds into its own
  accumulator; one psum at the end merges the partial volumes). This is the
  "spatial sharding" analogue for a CNN named in SURVEY.md section 5.7.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Initialize multi-host JAX (no-op on a single process).

    Pass all three arguments: nothing on a plain GPU host tells JAX of a
    cluster.
    """
    if num_processes is not None and num_processes <= 1:
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def make_sharded_predictor(predictor, mesh: Mesh):
    """Wrap a SlidingWindowPredictor so its patch-grid scan is sharded.

    The predictor's (n_batches, P, 3) corner array is split over the mesh's
    "data" axis; every device runs the scan on its slice of the grid into
    local accumulators, and a single psum merges the (weighted-sum, weight)
    pair — identical math to the single-device scan (overlap-add is
    order-independent addition).
    """
    from jax import shard_map

    n_batches = predictor.corners.shape[0]
    n_dev = len(mesh.devices.flat)
    pad = (-n_batches) % n_dev
    corners = predictor.corners
    valid = predictor.valid
    use_tiled = getattr(predictor, "use_tiled", False)
    seg_ids = predictor._seg_ids if use_tiled else jnp.zeros(
        (n_batches, 1), jnp.int32)  # placeholder, unused
    if pad:
        corners = jnp.concatenate(
            [corners, jnp.repeat(corners[-1:], pad, axis=0)])
        valid = jnp.concatenate(
            [valid, jnp.zeros((pad,) + valid.shape[1:], valid.dtype)])
        seg_ids = jnp.concatenate(
            [seg_ids, jnp.repeat(seg_ids[-1:], pad, axis=0)])

    def shard_fn(variables, vol, corners_l, valid_l, seg_l):
        # accumulators start shard-varying (each shard owns a partial sum);
        # pcast marks the invariant zeros accordingly for shard_map's
        # varying-manual-axes typing.
        L = predictor.n_labels
        if use_tiled:
            # tiled (segment-sum) overlap-add per shard, one psum of the
            # TILE tensor (smaller than the padded volume), weight field
            # precomputed on host — same win as the single-device path
            # (docs/PERF.md round-2 addendum 5).
            t0, t1, t2 = predictor._tile
            init = jax.lax.pcast(
                jnp.zeros((predictor._n_tiles, t0, t1, t2, L), jnp.float32),
                ("data",), to="varying")
            tiles = predictor.tiled_accumulate(variables, vol, corners_l,
                                               valid_l, seg_l, init=init)
            tiles = jax.lax.psum(tiles, "data")
            return (predictor.tiles_to_padded(tiles)
                    / jnp.asarray(predictor._wsum_np)[..., None])
        init = tuple(
            jax.lax.pcast(z, ("data",), to="varying") for z in (
                jnp.zeros(predictor.padded_shape + (L,), jnp.float32),
                jnp.zeros(predictor.padded_shape, jnp.float32)))
        acc, wsum = predictor.scan_accumulate(variables, vol,
                                              corners_l, valid_l, init=init)
        acc = jax.lax.psum(acc, "data")
        wsum = jax.lax.psum(wsum, "data")
        return acc / jnp.maximum(wsum, 1e-8)[..., None]

    mapped = shard_map(shard_fn, mesh=mesh,
                       in_specs=(P(), P(), P("data"), P("data"), P("data")),
                       out_specs=P())
    jitted = jax.jit(mapped)

    def predict(variables, data_cdhw) -> np.ndarray:
        data = jnp.asarray(np.asarray(data_cdhw, np.float32))
        vol = jnp.transpose(data, (1, 2, 3, 0))
        pb = predictor.pad_before
        total = [p - i for p, i in
                 zip(predictor.padded_shape, predictor.image_shape)]
        padspec = [(int(pb[d]), int(total[d] - pb[d])) for d in range(3)]
        vol = jnp.pad(vol, padspec + [(0, 0)])
        sharded = NamedSharding(mesh, P("data"))
        out = jitted(variables, vol,
                     jax.device_put(corners, sharded),
                     jax.device_put(valid, sharded),
                     jax.device_put(seg_ids, sharded))
        sl = tuple(slice(int(pb[d]), int(pb[d] + predictor.image_shape[d]))
                   for d in range(3))
        return np.transpose(np.asarray(out[sl]), (3, 0, 1, 2))

    return predict
