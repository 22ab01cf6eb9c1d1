"""Device-resident case cache: patches are GATHERED on device, not uploaded.

The per-step H2D of fresh patches is the real-epoch bottleneck on thin
device links (docs/PERF.md round-3 addendum 9): even with compressed
staging (bf16 x + uint8 one-hot y) a B=8 64-cube step uploads ~4.25 MB,
and the measured epoch rate sat at ~35 patches/s against a 77/s
device-step ceiling. This module is the logical endpoint of that
progression: every training/validation case is uploaded to HBM ONCE
(data in the model's compute dtype, truth as uint8, zero-padded by the
exact worst-case grid margins), and each step's input shrinks to
``(case_row[B] int32, patch_corner[B,3] int32)`` — ~100 bytes. Patch
extraction (`lax.dynamic_slice` under vmap), label conversion
(binarize / one-hot) and augmentation all run inside the jitted step.

Bit-parity with the host staging path (training/loop.py::_compress):

- data rides bf16 for bf16 models — identical rounding, because the
  model's first device op is the same cast; zero padding is exact in
  either dtype;
- truth rides uint8 — one-hot/binary labels are integral by the
  reference generator contract (generator.py::get_multi_class_labels);
- padding margins are computed from the exact reference grid math
  (ops/patches.py::compute_patch_indices centered negative-start
  corners + the per-epoch random negative training offset), so the
  device gather reproduces ``get_patch_from_3d_data``'s zero-padded
  out-of-bounds reads without any masking;
- the index stream consumes the SAME numpy rng sequence as
  pipeline/generator.py::data_generator (same epoch grids, same
  shuffle, same blank-skip, same partial-batch boundaries), so for a
  given seed the cached step trains on bitwise-identical batches in the
  identical order. tests/test_device_cache.py pins all of this.

Reference: the reference has no analogue — its generator re-read and
re-sliced every patch on host (SURVEY.md section 3.1 hot loop); this is
the device-side replacement the survey's build plan step 5 points at.
"""

from __future__ import annotations

import collections
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from fetal_mri_segmentation_tpu.ops.patches import (
    compute_patch_indices, get_patch_from_3d_data)

# jax imported lazily inside functions so host-only tooling can import the
# module (matches the package convention elsewhere).


# ---------------------------------------------------------------------------
# Exact worst-case grid margins
# ---------------------------------------------------------------------------

def plan_margins(image_shape: Sequence[int], patch_shape: Sequence[int],
                 validation_patch_overlap: int = 0,
                 training_patch_start_offset: Optional[Sequence[int]] = None
                 ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Per-axis zero-pad margins covering EVERY corner either generator can
    emit: the centered validation grid (negative-start overflow) and all
    training grids (random start offset in [-offset, 0], inclusive).

    Returns ``(margin_lo, margin_hi)`` such that for any emitted corner c:
    ``0 <= c + margin_lo`` and ``c + patch <= shape + margin_hi``.

    The corners come from ``ops/patches.py::compute_patch_indices`` itself
    (the function the generators actually call), not a re-derivation of its
    grid math — so any change to the reference grid contract propagates
    here automatically instead of silently diverging from the emitted
    corners. The grids are separable (column a of the corner array is the
    axis-a arange), so enumerating scalar offsets 0..max (each axis clamped
    to its own maximum) covers every per-axis offset combination.
    """
    image_shape = tuple(int(v) for v in image_shape)
    patch_shape = tuple(int(v) for v in patch_shape)
    grids = [
        # validation: centered grid at validation_patch_overlap
        compute_patch_indices(image_shape, patch_shape,
                              validation_patch_overlap)]
    if training_patch_start_offset is not None:
        # training: start = -offset, offset[a] in [0, max_offset[a]]
        max_off = [int(v) for v in training_patch_start_offset]
        for off in range(max(max_off) + 1):
            start = tuple(-min(off, m) for m in max_off)
            grids.append(compute_patch_indices(image_shape, patch_shape, 0,
                                               start=start))
    else:
        # training without offset: the centered overlap-0 grid
        grids.append(compute_patch_indices(image_shape, patch_shape, 0))
    corners = np.concatenate(grids, axis=0)
    min_corner = np.minimum(corners.min(axis=0), 0)
    max_end = np.maximum(corners.max(axis=0) + np.asarray(patch_shape),
                         image_shape)
    lo = tuple(int(-c) for c in min_corner)
    hi = tuple(int(e - s) for e, s in zip(max_end, image_shape))
    return lo, hi


# ---------------------------------------------------------------------------
# The cache itself
# ---------------------------------------------------------------------------

class DeviceCaseCache:
    """HBM-resident, zero-padded stacks of every case the run touches.

    ``data_stack``: (n_cases, n_channels, D+lo+hi, ...) in ``dtype``;
    ``truth_stack``: (n_cases, 1, same spatial) uint8;
    ``row_of``: original HDF5 case index -> stack row.
    """

    def __init__(self, data_stack, truth_stack, row_of, margin_lo,
                 patch_shape):
        self.data_stack = data_stack
        self.truth_stack = truth_stack
        self.row_of = dict(row_of)
        self.margin_lo = tuple(int(m) for m in margin_lo)
        self.patch_shape = tuple(int(p) for p in patch_shape)
        self.host_truth = None  # optional {case_idx: uint8 array}, see build
        self.partial = False    # True when only a subset is resident
        self.n_total_cases = len(self.row_of)

    @property
    def nbytes(self) -> int:
        return self.data_stack.nbytes + self.truth_stack.nbytes

    @classmethod
    def build(cls, data_file, case_indices: Sequence[int], *,
              patch_shape: Sequence[int],
              margin_lo: Sequence[int], margin_hi: Sequence[int],
              dtype=None, device=None,
              keep_host_truth: bool = False) -> "DeviceCaseCache":
        """``device`` may be a Device or a Sharding (e.g. a replicated
        NamedSharding for DP training — building straight into the final
        placement avoids a second full copy living on device 0).
        ``keep_host_truth`` retains the unpadded uint8 truth volumes in
        ``self.host_truth`` so blank-skip generators can share them instead
        of re-reading the HDF5 file."""
        import jax
        import jax.numpy as jnp
        import ml_dtypes

        dtype = dtype or jnp.bfloat16
        np_dtype = (ml_dtypes.bfloat16 if dtype == jnp.bfloat16
                    else np.dtype(dtype))
        case_indices = [int(i) for i in case_indices]
        c = int(data_file.root.data.shape[1])
        spatial = tuple(int(s) for s in data_file.root.data.shape[-3:])
        padded = tuple(s + lo + hi for s, lo, hi
                       in zip(spatial, margin_lo, margin_hi))
        n = len(case_indices)
        data = np.zeros((n, c) + padded, dtype=np_dtype)
        truth = np.zeros((n, 1) + padded, dtype=np.uint8)
        host_truth = {}
        sl = tuple(slice(lo, lo + s) for lo, s in zip(margin_lo, spatial))
        for row, idx in enumerate(case_indices):
            data[(row, slice(None)) + sl] = np.asarray(
                data_file.root.data[idx]).astype(np_dtype)
            t = np.asarray(data_file.root.truth[idx])
            t8 = t.astype(np.uint8)
            if not np.array_equal(t, t8):
                raise ValueError(
                    f"case {idx}: truth values are not integral uint8 "
                    "(reference truth_dtype contract) — device case cache "
                    "cannot represent them; use the host pipeline")
            truth[(row, slice(None)) + sl] = t8.reshape((1,) + spatial)
            if keep_host_truth:
                host_truth[idx] = t8.reshape((1,) + spatial)
        out = cls(jax.device_put(data, device), jax.device_put(truth, device),
                  {idx: row for row, idx in enumerate(case_indices)},
                  margin_lo, patch_shape)
        out.host_truth = host_truth if keep_host_truth else None
        return out


def estimate_cache_bytes(data_file, n_cases: int, margin_lo, margin_hi,
                         dtype_bytes: int = 2) -> int:
    c = int(data_file.root.data.shape[1])
    spatial = tuple(int(s) for s in data_file.root.data.shape[-3:])
    padded_voxels = int(np.prod([s + lo + hi for s, lo, hi
                                 in zip(spatial, margin_lo, margin_hi)]))
    return n_cases * padded_voxels * (c * dtype_bytes + 1)


# ---------------------------------------------------------------------------
# Device-side patch gather + label conversion
# ---------------------------------------------------------------------------

def make_gather(patch_shape: Sequence[int], margin_lo: Sequence[int]):
    """(stack, rows[B], corners[B,3]) -> (B, C, *patch_shape) patches.

    One ``dynamic_slice`` per batch element (vmapped -> a single XLA gather
    of contiguous blocks); margins make every slice in-bounds, reproducing
    the host path's zero-padded out-of-bounds reads.
    """
    import jax
    import jax.numpy as jnp

    patch = tuple(int(p) for p in patch_shape)
    m = tuple(int(v) for v in margin_lo)

    def gather(stack, rows, corners):
        sizes = (1, stack.shape[1]) + patch

        def one(row, c):
            start = (row, 0, c[0] + m[0], c[1] + m[1], c[2] + m[2])
            return jax.lax.dynamic_slice(stack, start, sizes)[0]

        return jax.vmap(one)(rows.astype(jnp.int32),
                             corners.astype(jnp.int32))

    return gather


def convert_labels_device(truth, n_labels: int,
                          labels: Optional[Sequence[int]] = None):
    """(B, 1, *patch) integer truth -> float32 binary / one-hot target.

    Device twin of generator.py::convert_data + get_multi_class_labels
    (reference: unet3d/generator.py) — exact: labels are integral.
    """
    import jax.numpy as jnp

    if n_labels == 1:
        return (truth > 0).astype(jnp.float32)
    labs = (tuple(labels) if labels is not None
            else tuple(range(1, n_labels + 1)))
    return jnp.concatenate(
        [(truth == lab).astype(jnp.float32) for lab in labs], axis=1)


# ---------------------------------------------------------------------------
# Cached train / eval steps
# ---------------------------------------------------------------------------

def _make_gather_convert(config, margin_lo):
    """(stacks, rows, corners, n_valid) -> (x, y) exactly as the host
    staging path would deliver them: gathered patches with padded batch
    slots ZEROED (the host path zero-pads before upload — parity matters
    beyond the masked loss, e.g. BatchNorm batch statistics see the
    padding)."""
    import jax.numpy as jnp

    gather = make_gather(config.patch_shape, margin_lo)
    n_labels, labels = config.n_labels, config.labels

    def gather_convert(data_stack, truth_stack, rows, corners, n_valid):
        x = gather(data_stack, rows, corners)
        y = convert_labels_device(gather(truth_stack, rows, corners),
                                  n_labels, labels)
        if n_valid is not None:
            m = (jnp.arange(x.shape[0]) < n_valid).reshape(
                (-1,) + (1,) * (x.ndim - 1))
            x = x * m.astype(x.dtype)
            y = y * m.astype(y.dtype)
        return x, y

    return gather_convert


def make_cached_train_step(model, config, margin_lo):
    """``step(state, data_stack, truth_stack, rows, corners, rng, n_valid)``
    — the full train step (training/train_step.py) with the patch gather,
    label conversion and augmentation fused into the same XLA program.
    Stacks are passed as (non-donated) arguments, not closure constants, so
    they stay device-resident across steps without bloating the jaxpr."""
    import jax

    from fetal_mri_segmentation_tpu.training.train_step import make_train_step

    base = make_train_step(model, config, jit=False)
    gather_convert = _make_gather_convert(config, margin_lo)

    def step(state, data_stack, truth_stack, rows, corners, rng,
             n_valid=None):
        x, y = gather_convert(data_stack, truth_stack, rows, corners, n_valid)
        return base(state, x, y, rng, n_valid)

    return jax.jit(step, donate_argnums=(0,))


def make_cached_eval_step(model, config, margin_lo):
    import jax

    from fetal_mri_segmentation_tpu.training.train_step import make_eval_step

    base = make_eval_step(model, config, jit=False)
    gather_convert = _make_gather_convert(config, margin_lo)

    def step(state, data_stack, truth_stack, rows, corners, n_valid=None):
        x, y = gather_convert(data_stack, truth_stack, rows, corners, n_valid)
        return base(state, x, y, n_valid)

    return jax.jit(step)


def make_cached_dp_train_step(model, config, mesh, margin_lo):
    """Data-parallel cached step: stacks replicated over the mesh, index
    arrays sharded on "data" — the per-shard gather reads only its own
    sub-batch's patches. Exact twin of parallel/data_parallel.py::
    make_dp_train_step (same per-shard RNG fold, same local-valid math,
    sync-BN rebuild)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from fetal_mri_segmentation_tpu.training.train_step import make_train_step

    if getattr(config, "batch_normalization", False):
        from fetal_mri_segmentation_tpu.models import build_model
        model = build_model(config, bn_axis_name="data")
    inner = make_train_step(model, config, axis_name="data", jit=False)
    gather_convert = _make_gather_convert(config, margin_lo)

    def shard_fn(state, data_stack, truth_stack, rows, corners, rng, n_valid):
        i = jax.lax.axis_index("data")
        rng = jax.random.fold_in(rng, i)
        local_b = rows.shape[0]
        local_valid = jnp.clip(n_valid - i * local_b, 0, local_b)
        x, y = gather_convert(data_stack, truth_stack, rows, corners,
                              local_valid)
        return inner(state, x, y, rng, local_valid)

    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P("data"), P("data"), P(), P()),
        out_specs=(P(), P()))
    return jax.jit(mapped, donate_argnums=(0,))


def make_cached_dp_eval_step(model, config, mesh, margin_lo):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from fetal_mri_segmentation_tpu.training.train_step import make_eval_step

    inner = make_eval_step(model, config, jit=False)
    gather_convert = _make_gather_convert(config, margin_lo)

    def shard_fn(state, data_stack, truth_stack, rows, corners, n_valid):
        i = jax.lax.axis_index("data")
        local_b = rows.shape[0]
        local_valid = jnp.clip(n_valid - i * local_b, 0, local_b)
        x, y = gather_convert(data_stack, truth_stack, rows, corners,
                              local_valid)
        return inner(state, x, y, local_valid, axis_name="data")

    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P("data"), P("data"), P()),
        out_specs=P())
    return jax.jit(mapped)


# ---------------------------------------------------------------------------
# Host index stream (rng-parity twin of generator.py::data_generator)
# ---------------------------------------------------------------------------

class _DictTruth:
    """Truth lookup over the host copies retained by ``DeviceCaseCache.build``
    (shared by the train and validation generators — no HDF5 re-reads)."""

    def __init__(self, host_truth):
        self._d = host_truth

    def get(self, index: int) -> np.ndarray:
        return self._d[index]


def index_batch_generator(data_file, index_list, row_of, batch_size: int = 1,
                          patch_shape=None, patch_overlap: int = 0,
                          patch_start_offset=None,
                          shuffle_index_list: bool = True,
                          skip_blank: bool = True,
                          seed: Optional[int] = None,
                          cache_cases: int = 64,
                          truth_cache=None,
                          skip_batches: int = 0
                          ) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
    """Infinite generator of ``(rows[B] int32, corners[B,3] int32, n_valid)``.

    Mirrors generator.py::data_generator line for line — same rng
    construction and consumption order (per-epoch ``default_rng((seed, k))``
    derivation incl. the batch-level ``skip_batches`` fast-forward for
    data-order exact resume, epoch grid offsets, shuffle), same blank-skip
    decisions (truth sliced on host from an LRU), same partial-batch
    boundaries — so the cached pipeline trains on the exact sequence the
    host pipeline would. Partial batches are padded by repeating the first
    entry; ``n_valid`` masks the padding in the step.

    ``truth_cache``: optional shared ``.get(case_idx) -> truth array``
    lookup (e.g. ``DeviceCaseCache.host_truth`` wrapped) so several
    generators avoid re-reading the HDF5 truth already loaded at build.
    """
    from fetal_mri_segmentation_tpu.pipeline.generator import (
        BatchSkipper, TruthCache, create_patch_index_list)

    if patch_shape is None:
        raise ValueError("device case cache requires patch_shape training")
    skipper = BatchSkipper(skip_batches)
    cache = truth_cache or TruthCache(data_file, max_cases=cache_cases)
    base_list = list(index_list)
    image_shape = tuple(data_file.root.data.shape[-3:])
    epoch = 0

    def emit(pairs):
        n_valid = len(pairs)
        while len(pairs) < batch_size:
            pairs.append(pairs[0])
        rows = np.asarray([row_of[c] for c, _ in pairs], dtype=np.int32)
        corners = np.asarray([corner for _, corner in pairs],
                             dtype=np.int32).reshape(batch_size, 3)
        return rows, corners, n_valid

    while True:
        rng = np.random.default_rng(
            None if seed is None else (seed, epoch))
        epoch += 1
        pairs: List[Tuple[int, np.ndarray]] = []
        skipper.reset_epoch()
        epoch_list = create_patch_index_list(
            base_list, image_shape, patch_shape, patch_overlap,
            patch_start_offset, rng)
        if shuffle_index_list:
            rng.shuffle(epoch_list)
        yielded = False
        while epoch_list:
            if skipper and not skip_blank:
                if skipper.arith_skip_epoch(epoch_list, batch_size):
                    yielded = True
                    break
                continue
            case_index, corner = epoch_list.pop()
            kept = True
            if skip_blank:
                truth = cache.get(case_index)
                y = get_patch_from_3d_data(truth, patch_shape, corner)
                kept = bool(np.any(y))
            if skipper:
                # fast-forward: same batch boundaries, nothing emitted
                if skipper.note_patch(kept, batch_size, not epoch_list):
                    yielded = True
                continue
            if kept:
                pairs.append((case_index, corner))
            # emit check after EVERY pop (same trailing-partial semantics
            # as generator.py::data_generator — must stay in lockstep)
            if pairs and (len(pairs) == batch_size or not epoch_list):
                yield emit(pairs)
                yielded = True
                pairs = []
        if not yielded:
            raise RuntimeError(
                "index_batch_generator produced no batches for an entire "
                f"epoch (skip_blank={skip_blank}, {len(base_list)} cases) — "
                "truth volumes appear to be empty")


def partial_index_batch_generator(data_file, index_list, row_of,
                                  batch_size: int = 1,
                                  patch_shape=None, patch_overlap: int = 0,
                                  patch_start_offset=None,
                                  shuffle_index_list: bool = True,
                                  skip_blank: bool = True,
                                  seed: Optional[int] = None,
                                  cache_cases: int = 64,
                                  truth_cache=None,
                                  skip_batches: int = 0,
                                  n_labels: int = 1, labels=None
                                  ) -> Iterator[tuple]:
    """Tagged twin of `index_batch_generator` for a PARTIALLY resident cache.

    Emits either ``("idx", rows, corners, n_valid)`` (all cases resident —
    the ~100-byte step input) or ``("host", x, y, n_valid)`` (host-gathered
    float32 patches + converted labels, exactly what the host staging path
    would upload). Each epoch derives the SAME rng stream as the host/full
    generators (same epoch grids, same shuffle, same blank-skip decisions),
    then routes each kept patch by residency, filling the two batch kinds
    independently — so the epoch's PATCH MULTISET is identical to the host
    pipeline's while the batch grouping differs (a documented deviation of
    partial mode: resident and non-resident patches share a batch only in
    the merged trailing flush below). Trailing partials flush at epoch end
    (padded to the static batch size — idx batches by duplicating the first
    row in ``emit_idx``, host batches downstream in ``loop.py::pad_batch`` —
    and masked by n_valid like everything else); when both kinds
    have remainders that fit one batch they merge into a single host batch
    so the per-epoch emission count exactly equals the host generator's
    ``ceil(kept/batch_size)`` — the loop consumes that many per epoch.

    ``skip_batches`` fast-forward replays the full routing deterministically
    and suppresses the first N emissions (exact resume, same guarantee as
    the full-cache generator; slower per skipped batch because it re-reads
    truth for blank checks).
    """
    from fetal_mri_segmentation_tpu.pipeline.generator import (
        CaseCache, TruthCache, convert_data, create_patch_index_list)

    if patch_shape is None:
        raise ValueError("device case cache requires patch_shape training")
    tcache = truth_cache or TruthCache(data_file, max_cases=64)
    dcache = CaseCache(data_file, max_cases=cache_cases)
    base_list = list(index_list)
    image_shape = tuple(data_file.root.data.shape[-3:])
    epoch = 0
    to_skip = int(skip_batches)

    def emit_idx(pairs):
        n_valid = len(pairs)
        while len(pairs) < batch_size:
            pairs.append(pairs[0])
        rows = np.asarray([row_of[c] for c, _ in pairs], dtype=np.int32)
        corners = np.asarray([corner for _, corner in pairs],
                             dtype=np.int32).reshape(batch_size, 3)
        return "idx", rows, corners, n_valid

    def emit_host(pairs):
        xs, ys = [], []
        for case_index, corner in pairs:
            data, truth = dcache.get(case_index)
            xs.append(get_patch_from_3d_data(data, patch_shape, corner))
            ys.append(get_patch_from_3d_data(truth, patch_shape, corner))
        x, y = convert_data(xs, ys, n_labels=n_labels, labels=labels)
        return "host", x, y, len(pairs)

    while True:
        rng = np.random.default_rng(
            None if seed is None else (seed, epoch))
        epoch += 1
        epoch_list = create_patch_index_list(
            base_list, image_shape, patch_shape, patch_overlap,
            patch_start_offset, rng)
        if shuffle_index_list:
            rng.shuffle(epoch_list)
        res: List[Tuple[int, np.ndarray]] = []
        mis: List[Tuple[int, np.ndarray]] = []
        yielded = False

        def boundary(pairs, emit):
            """One batch boundary: skip (fast-forward) or build + emit."""
            nonlocal to_skip, yielded
            yielded = True
            if to_skip > 0:
                to_skip -= 1
                return None
            return emit(list(pairs))

        while epoch_list:
            case_index, corner = epoch_list.pop()
            if skip_blank:
                truth = tcache.get(case_index)
                if not np.any(get_patch_from_3d_data(truth, patch_shape,
                                                     corner)):
                    continue
            bucket = res if case_index in row_of else mis
            bucket.append((case_index, corner))
            if len(res) == batch_size:
                out = boundary(res, emit_idx)
                res = []
                if out is not None:
                    yield out
            if len(mis) == batch_size:
                out = boundary(mis, emit_host)
                mis = []
                if out is not None:
                    yield out
        # flush trailing partials. The host generator emits exactly
        # ceil(kept/batch_size) batches per epoch and the training loop
        # consumes exactly that many (train.py passes it as steps/epoch);
        # flushing the two streams' remainders independently would emit
        # ONE EXTRA batch whenever both have remainders that fit a single
        # batch, drifting trained-epoch boundaries from generator epochs
        # by one batch per epoch. Merge such remainders into one host
        # batch (resident cases live in the data file too), which makes
        # the per-epoch emission count equal the host generator's in
        # every case; when the remainders overflow one batch, two flushes
        # match the host's two trailing batches. Resident-first order
        # keeps the replayed routing (skip_batches resume) deterministic.
        if res and mis and len(res) + len(mis) <= batch_size:
            out = boundary(res + mis, emit_host)
            res, mis = [], []
            if out is not None:
                yield out
        for pairs, emit in ((res, emit_idx), (mis, emit_host)):
            if pairs:
                out = boundary(pairs, emit)
                if out is not None:
                    yield out
        if not yielded:
            raise RuntimeError(
                "partial_index_batch_generator produced no batches for an "
                f"entire epoch (skip_blank={skip_blank}, {len(base_list)} "
                "cases) — truth volumes appear to be empty")


# ---------------------------------------------------------------------------
# The auto decision
# ---------------------------------------------------------------------------

#: budget for backends that report no memory stats (the CPU backend):
#: host RAM stands in for device memory there, so keep it modest.
AUTO_BUDGET_BYTES = 4 << 30

#: fraction of the device's reported free memory the cache may claim — the
#: remainder absorbs fragmentation and estimate error.
HBM_SAFETY_FRACTION = 0.8

#: share of the device's memory limit (``bytes_limit`` — on a GPU the pool
#: JAX preallocated, 75% of the card by default) reserved for the
#: train-step working set (activations, gradients, XLA scratch), none of
#: which exists yet at cache-build time, so "free" memory measured here
#: overstates what the cache may take. Without a reserve a dataset that
#: fills the free memory goes fully resident and the FIRST train step runs
#: out of memory (the upload-failure fallback only guards the cache
#: upload, not the later step). A quarter of the pool covers the measured
#: peak of the flagship B=6 64^3 depth-4 step with room to spare
#: (docs/PERF.md, "H100 bring-up"); module-level so tests (and unusual
#: models) can patch it.
HBM_STEP_RESERVE_FRACTION = 0.25


def hbm_budget_bytes(device=None, safety: float = HBM_SAFETY_FRACTION,
                     fallback: Optional[int] = None,
                     reserve: Optional[int] = None) -> int:
    """Cache budget from the device's ACTUAL free memory.

    ``safety * (bytes_limit - bytes_in_use) - reserve`` via
    ``device.memory_stats()``, where ``reserve`` defaults to
    ``HBM_STEP_RESERVE_FRACTION * bytes_limit``; backends that report
    nothing (CPU) get the static ``fallback`` (module-level
    AUTO_BUDGET_BYTES when None, read at call time so tests can patch it —
    the fallback is already conservative, no reserve is subtracted from
    it).
    """
    import jax

    if fallback is None:
        fallback = AUTO_BUDGET_BYTES
    try:
        device = device or jax.local_devices()[0]
        stats = device.memory_stats()
        limit = int(stats["bytes_limit"])
        in_use = int(stats.get("bytes_in_use", 0))
    except (RuntimeError, KeyError, TypeError, AttributeError, IndexError):
        return fallback
    if reserve is None:
        reserve = int(HBM_STEP_RESERVE_FRACTION * limit)
    return max(0, int(safety * (limit - in_use)) - int(reserve))


def maybe_build_device_cache(data_file, config, *, mesh=None, seed=0,
                             train_skip_batches: int = 0,
                             val_skip_batches: int = 0,
                             budget_bytes: Optional[int] = None,
                             resume_data_order: Optional[dict] = None,
                             verbose: bool = False):
    """Returns ``(cache, train_index_gen, val_index_gen)`` when the device
    case cache applies, else None (host staging path).

    Applies when: config.device_case_cache != "off", patch training, a
    single device or a pure data-parallel mesh (stacks built directly into
    the replicated sharding; the spatial/hybrid paths keep host staging),
    the split pickles exist, the truth is integral uint8, and ("auto") the
    padded stacks fit the HBM budget — derived from the device's ACTUAL
    free memory (`hbm_budget_bytes`; ``budget_bytes`` overrides for tests).
    "on" raises instead of falling back for everything except the mesh
    check, and skips the budget check.

    PARTIAL mode (single device, "auto"): when the full dataset exceeds
    the budget but at least two cases fit, the K hottest cases are cached
    (training cases first — they are revisited every epoch; then
    validation) and the rest host-stage per batch. The generators then
    emit TAGGED batches (`partial_index_batch_generator`) and
    ``cache.partial`` is True; the epoch's patch multiset is identical to
    the host pipeline's, but resident and non-resident patches fill
    separate batches (grouping deviation, documented).

    ``resume_data_order``: the interrupted run's recorded mode
    (CheckpointIO.peek_data_order) when this call is a resume with
    nonzero skip_batches. Because partial-mode batch GROUPING depends on
    which cases were resident — and the auto decision otherwise reads
    LIVE free device memory, which can differ between the crashed run and the
    resume — the recorded mode is pinned: ``{"mode": "lockstep"}``
    suppresses partial (full cache or host staging share the host batch
    boundaries, either preserves the order); ``{"mode": "partial",
    "resident": [...]}`` forces exactly that resident set and RAISES if
    it cannot be reproduced (a silent fallback would replay the wrong
    batch sequence). None (fresh run / legacy sidecar) keeps the free
    auto decision.
    """
    import os

    import jax.numpy as jnp

    from fetal_mri_segmentation_tpu.utils.io_utils import pickle_load

    knob = getattr(config, "device_case_cache", "auto")
    if knob not in ("auto", "on", "off"):
        raise ValueError(
            f"device_case_cache={knob!r} — must be 'auto', 'on' or 'off'")

    forced_partial = (resume_data_order is not None
                      and resume_data_order.get("mode") == "partial")

    def _resume_break(why):
        return RuntimeError(
            "exact-resume violation: the interrupted run trained with a "
            "PARTIAL device case cache (batch grouping depends on the "
            f"resident case set), but {why} — resuming differently would "
            "silently replay a different batch sequence than the "
            "interrupted run consumed. Reproduce the original environment "
            "(free device memory / same config), or delete the 'data_order' field "
            "from the checkpoint's .meta.json to accept an inexact resume.")

    if knob == "off":
        if forced_partial:
            raise _resume_break("device_case_cache is now 'off'")
        return None
    if forced_partial and knob == "on":
        raise _resume_break("device_case_cache='on' forces a FULL cache, "
                            "whose batch grouping differs from partial")

    def skip(reason):
        if knob == "on":
            raise ValueError(f"device_case_cache='on' but {reason}")
        if forced_partial:
            raise _resume_break(reason)
        if verbose:
            print(f"[device-cache] {reason} — keeping host staging")
        return None

    if config.patch_shape is None:
        # 'on' must raise here like every other ineligibility (whole-volume
        # training has no patch gather to cache for), not silently fall back
        return skip("patch_shape is None (whole-volume training)")

    dp_mesh = mesh is not None and len(mesh.devices.flat) > 1
    if dp_mesh and "spatial" in mesh.axis_names:
        # patch gathers are per-sample; a depth-sharded volume axis would
        # need halo-aware gathers — host staging stays correct there
        if forced_partial:
            raise _resume_break("a spatial/hybrid mesh is now active "
                                "(partial mode is single-device)")
        if verbose:
            print("[device-cache] spatial/hybrid mesh — keeping host staging")
        return None
    if not (os.path.exists(config.training_file)
            and os.path.exists(config.validation_file)):
        return skip("split pickles not found (build the generators first)")
    training_list = [int(i) for i in pickle_load(config.training_file)]
    validation_list = [int(i) for i in pickle_load(config.validation_file)]
    all_cases = sorted(set(training_list) | set(validation_list))
    margin_lo, margin_hi = plan_margins(
        tuple(data_file.root.data.shape[-3:]), config.patch_shape,
        config.validation_patch_overlap, config.training_patch_start_offset)
    dtype = (jnp.bfloat16 if config.compute_dtype == "bfloat16"
             else jnp.float32)
    est = estimate_cache_bytes(data_file, len(all_cases), margin_lo,
                               margin_hi,
                               dtype_bytes=2 if dtype == jnp.bfloat16 else 4)
    budget = (int(budget_bytes) if budget_bytes is not None
              else hbm_budget_bytes())
    resident = all_cases
    if forced_partial:
        # reproduce the interrupted run's resident set EXACTLY — grouping
        # (and therefore skip_batches fast-forward) depends on membership
        recorded = [int(c) for c in (resume_data_order.get("resident")
                                     or [])]
        missing = sorted(set(recorded) - set(all_cases))
        if len(recorded) < 2 or missing:
            raise _resume_break(
                "the recorded resident set is "
                + (f"not in the current splits (cases {missing[:5]})"
                   if missing else "empty/invalid"))
        if dp_mesh:
            raise _resume_break("a multi-device mesh is now active "
                                "(partial mode is single-device)")
        resident = recorded
    elif knob == "auto" and est > budget:
        if resume_data_order is not None:
            # the interrupted run used lockstep batch boundaries (host
            # staging or full cache); engaging partial now would regroup —
            # host staging preserves the exact sequence
            if verbose:
                print("[device-cache] resumed run recorded lockstep data "
                      "order — partial mode suppressed, keeping host "
                      "staging")
            return None
        # partial mode: cache what fits (single-device only — a partially
        # resident stack replicated over a mesh would need per-shard
        # host routing; host staging stays correct there)
        case_bytes = max(1, est // max(1, len(all_cases)))
        k = int(budget // case_bytes)
        if dp_mesh or k < 2:
            if verbose:
                why = ("data-parallel mesh" if dp_mesh
                       else f"only {k} case(s) fit")
                print(f"[device-cache] dataset needs {est / 2**30:.2f} GiB "
                      f"HBM (> {budget / 2**30:.2f} GiB budget) and partial "
                      f"mode is unavailable ({why}) — keeping host staging")
            return None
        # hottest first: training cases are revisited every epoch at full
        # grid weight; validation cases only at validation time
        ordered = list(dict.fromkeys(list(training_list)
                                     + list(validation_list)))
        resident = ordered[:k]
    device = None
    if dp_mesh:
        # build straight into the replicated placement — a plain device_put
        # then replicate would leave a dead full copy on device 0
        from jax.sharding import NamedSharding, PartitionSpec as P
        device = NamedSharding(mesh, P())
    partial = len(resident) < len(all_cases)
    try:
        cache = DeviceCaseCache.build(
            data_file, resident, patch_shape=config.patch_shape,
            margin_lo=margin_lo, margin_hi=margin_hi, dtype=dtype,
            device=device,
            keep_host_truth=config.skip_blank and not partial)
    except ValueError as e:
        # non-integral truth etc. — a representation problem, not a bug
        return skip(str(e))
    except (RuntimeError, MemoryError) as e:
        # the budget is an estimate: a device whose HBM is already busy
        # can still fail the upload (XlaRuntimeError is a RuntimeError).
        # The documented auto contract is host-staging fallback, not a
        # crash.
        return skip(f"cache upload failed ({type(e).__name__}: {e})")
    cache.partial = partial
    cache.n_total_cases = len(all_cases)
    cache.resident_cases = sorted(int(c) for c in resident)
    if verbose:
        frac = len(resident) / max(1, len(all_cases))
        part = (f"{len(resident)}/{len(all_cases)} cases "
                f"({frac:.0%}) resident — PARTIAL cache, non-resident "
                "patches host-stage" if partial
                else f"{len(all_cases)} cases resident on device")
        print(f"[device-cache] {part} ({cache.nbytes / 2**20:.0f} MiB"
              f"{' per device, replicated' if dp_mesh else ''}); "
              "steps feed int32 indices")
    if partial:
        # ONE truth cache across both generators — they blank-check the
        # same HDF5 file, and the full-cache path below shares its
        # truth_lookup for the same reason (no duplicate truth RAM or
        # repeated decompression)
        from fetal_mri_segmentation_tpu.pipeline.generator import TruthCache
        shared_truth = TruthCache(data_file, max_cases=64)
        train_gen = partial_index_batch_generator(
            data_file, training_list, cache.row_of,
            batch_size=config.batch_size, patch_shape=config.patch_shape,
            patch_overlap=0,
            patch_start_offset=config.training_patch_start_offset,
            skip_blank=config.skip_blank, seed=seed,
            truth_cache=shared_truth, skip_batches=train_skip_batches,
            n_labels=config.n_labels, labels=config.labels)
        val_gen = partial_index_batch_generator(
            data_file, validation_list, cache.row_of,
            batch_size=config.validation_batch_size or config.batch_size,
            patch_shape=config.patch_shape,
            patch_overlap=config.validation_patch_overlap,
            shuffle_index_list=False, skip_blank=config.skip_blank,
            seed=seed, truth_cache=shared_truth,
            skip_batches=val_skip_batches,
            n_labels=config.n_labels, labels=config.labels)
        return cache, train_gen, val_gen
    truth_lookup = (_DictTruth(cache.host_truth)
                    if cache.host_truth is not None else None)
    train_gen = index_batch_generator(
        data_file, training_list, cache.row_of,
        batch_size=config.batch_size, patch_shape=config.patch_shape,
        patch_overlap=0,
        patch_start_offset=config.training_patch_start_offset,
        skip_blank=config.skip_blank, seed=seed, truth_cache=truth_lookup,
        skip_batches=train_skip_batches)
    val_gen = index_batch_generator(
        data_file, validation_list, cache.row_of,
        batch_size=config.validation_batch_size or config.batch_size,
        patch_shape=config.patch_shape,
        patch_overlap=config.validation_patch_overlap,
        shuffle_index_list=False, skip_blank=config.skip_blank, seed=seed,
        truth_cache=truth_lookup, skip_batches=val_skip_batches)
    return cache, train_gen, val_gen
