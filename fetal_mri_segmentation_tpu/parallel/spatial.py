"""Spatial sharding (the sequence-parallel analogue for 3D CNNs) via GSPMD.

Reference: ABSENT — the reference is single-device; SURVEY.md section 5.7
names spatial sharding of whole-volume convs (halo exchange between
devices; NCCL over NVLink on a GPU host) as the analogue of
sequence/context parallelism for this workload.

Unlike `parallel/data_parallel.py` (shard_map = per-shard code), this module
uses the GLOBAL-VIEW path: ``jax.jit`` with `NamedSharding` annotations on a
``jax.sharding.Mesh``. XLA's SPMD partitioner then inserts the collectives
itself — halo exchanges (`ppermute`) at shard boundaries for every 3³ SAME
conv / pool / upsample along the sharded depth axis, and all-reduces for the
global loss/metric reductions — exactly the scaling-book recipe: pick a
mesh, annotate shardings, let XLA insert collectives.

Two axes compose:
- ``data``   — batch dimension (classic DP; gradients all-reduced),
- ``spatial``— the volume depth axis (activations sharded; memory per device
               for whole-volume training drops by the spatial factor).

The SAME jitted step serves any mesh shape, including 1x1 (collectives
compile away). Equivalence vs the single-device step is tested on the
virtual 8-device CPU mesh (tests/test_spatial.py).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fetal_mri_segmentation_tpu.utils.residency import ResidentParamsMixin
from fetal_mri_segmentation_tpu.training.train_step import (
    make_eval_step, make_train_step)


def make_hybrid_mesh(n_data: int, n_spatial: int,
                     devices=None) -> Mesh:
    """2-D ``Mesh(("data", "spatial"))`` over the first n_data*n_spatial
    visible devices."""
    devices = list(devices if devices is not None else jax.devices())
    need = n_data * n_spatial
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return Mesh(np.asarray(devices[:need]).reshape(n_data, n_spatial),
                ("data", "spatial"))


def _batch_spec(mesh: Mesh) -> P:
    """(B, C, D, H, W) partition spec: batch on "data" (if present), volume
    depth on "spatial" (if present)."""
    data = "data" if "data" in mesh.axis_names else None
    spatial = "spatial" if "spatial" in mesh.axis_names else None
    return P(data, None, spatial, None, None)


def make_gspmd_train_step(model, config, mesh: Mesh) -> Callable:
    """``step(state, x, y, rng, n_valid) -> (state, metrics)`` — global-view
    jit over the mesh.

    ``x``/``y`` are GLOBAL ``(B, C, D, H, W)`` arrays with the batch axis
    sharded over "data" and the depth axis over "spatial" (use
    `shard_batch_spatial`); ``state`` is replicated. The loss here is the
    plain global-batch loss (no axis_name / per-shard partials needed —
    GSPMD's reductions ARE global), so gradients and metrics match the
    single-device step up to fp reduction order.
    """
    inner = make_train_step(model, config, jit=False)
    repl = NamedSharding(mesh, P())
    batch = NamedSharding(mesh, _batch_spec(mesh))
    step = jax.jit(
        inner,
        in_shardings=(repl, batch, batch, repl, repl),
        out_shardings=(repl, repl),
        donate_argnums=(0,))

    # The fixed-length in_shardings tuple makes every positional argument
    # mandatory at the pjit boundary; keep n_valid optional here (like the
    # single-device and shard_map step variants) by defaulting it to the
    # full batch — omitting it must not raise an obscure tree-prefix error.
    def gspmd_step(state, x, y, rng, n_valid=None):
        if n_valid is None:
            n_valid = jax.numpy.asarray(x.shape[0])
        return step(state, x, y, rng, n_valid)

    return gspmd_step


def make_gspmd_eval_step(model, config, mesh: Mesh) -> Callable:
    inner = make_eval_step(model, config, jit=False)
    repl = NamedSharding(mesh, P())
    batch = NamedSharding(mesh, _batch_spec(mesh))
    step = jax.jit(inner,
                   in_shardings=(repl, batch, batch, repl),
                   out_shardings=repl,
                   static_argnames=("axis_name",))

    def gspmd_eval_step(state, x, y, n_valid=None):
        if n_valid is None:  # see make_gspmd_train_step
            n_valid = jax.numpy.asarray(x.shape[0])
        return step(state, x, y, n_valid)

    return gspmd_eval_step


def shard_batch_spatial(mesh: Mesh, *arrays):
    """Place (B, C, D, H, W) host arrays with batch/"data" + depth/"spatial"
    sharding; validates divisibility with a clear error."""
    spec = _batch_spec(mesh)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    out = []
    for a in arrays:
        for dim, axis in ((0, spec[0]), (2, spec[2])):
            n = sizes.get(axis, 1)
            if a.shape[dim] % n != 0:
                raise ValueError(
                    f"array dim {dim} (size {a.shape[dim]}) not divisible "
                    f"by mesh axis {axis!r} ({n} shards)")
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return tuple(out) if len(out) > 1 else out[0]


class AsyncLabels:
    """Async label-map handle: the on-device (packed) result bound to the
    volume shape it was dispatched for — so pipelining volumes of differing
    shapes cannot unpack against the wrong geometry."""

    __slots__ = ("device_array", "shape")

    def __init__(self, device_array, shape):
        self.device_array = device_array
        self.shape = tuple(shape)


class SpatialPredictor(ResidentParamsMixin):
    """Whole-volume predictor: ONE forward pass over the full volume, depth
    axis sharded over the mesh — activation memory per chip drops by the
    spatial factor (lets volumes that exceed one chip's HBM run without
    patching). On a 1-device mesh the collectives compile away and this IS
    the single-chip DIRECT inference mode: measured ~2x less device time
    than the (tiled) sliding-window path on 128^3 (57 vs 115 ms, docs/PERF.md) —
    the patch grid recomputes every overlap region, the direct pass doesn't.

    Duck-types `SlidingWindowPredictor`'s full serving surface — ``__call__``
    (probability map), ``predict_labels`` / ``predict_labels_async`` +
    ``unpack_labels`` (pipelined streams), device-resident params, bf16 host
    staging, and BIT-PACKED binary label D2H — so `run_validation_cases`
    pipelines it identically."""

    def __init__(self, model, config, mesh: Mesh, tta=False,
                 tta_chunk: Optional[int] = None):
        import jax.numpy as jnp

        self.model = model
        self.config = config
        self.n_labels = config.n_labels
        # Volume-level TTA (beyond-parity): the reference's predict(permute=
        # True) averages PATCH-level symmetries inside the sliding window;
        # here the whole volume is one forward, so the symmetry group acts on
        # the full volume instead. Same estimator family (nnU-Net-style
        # mirroring generalized to the cube group), ~2x less device time than
        # patch-level TTA because the direct pass never recomputes overlap
        # regions (docs/PERF.md addendum 15). False | "flips" (8-way, any
        # shape) | True/"permute" (48 symmetries, cubic volumes only).
        from fetal_mri_segmentation_tpu.utils.residency import (
            normalize_tta_mode)

        self.tta_mode = normalize_tta_mode(tta)
        # TTA members are independent forwards — so the symmetry group runs
        # in BATCHED chunks: the permutes/flips themselves are STATIC (free
        # data-movement ops XLA fuses; a vmapped lax.switch would compute
        # all 48 branches per member), only the forward is scanned over
        # chunks of `tta_chunk` members. The per-mode defaults (permute 8,
        # flips 2: flips has only 8 members, so big chunks trade batch
        # efficiency for device memory with little to amortize) have not
        # been re-swept on the GPU (ROADMAP A8).
        if tta_chunk is None:
            tta_chunk = 8 if self.tta_mode == "permute" else 2
        if tta_chunk < 1 or 48 % tta_chunk:
            raise ValueError(f"tta_chunk={tta_chunk} must divide 48")
        self.tta_chunk = tta_chunk
        repl = NamedSharding(mesh, P())
        spatial = ("spatial" if "spatial" in mesh.axis_names
                   else mesh.axis_names[0])
        self._n_spatial = dict(zip(mesh.axis_names,
                                   mesh.devices.shape)).get(spatial, 1)
        self._vol_spec = NamedSharding(mesh, P(None, spatial, None, None))
        # params go device-resident REPLICATED over the mesh (mixin honors
        # _resident_sharding), so jit's in_shardings=repl needs no reshard
        self._resident_sharding = repl
        self._last_shape = None

        tta_mode = self.tta_mode

        def _forward(variables, x):
            return model.apply(variables, x)  # (1, D, H, W, L)

        def _probs(variables, vol_cdhw):
            x = jnp.transpose(vol_cdhw, (1, 2, 3, 0))[None]  # (1, D, H, W, C)
            if tta_mode is None:
                y = _forward(variables, x)
            elif tta_mode == "flips":
                # 8-way axis-flip average (flips are involutions), BATCHED:
                # the 8 flipped copies are static `jnp.flip`s stacked into
                # chunks of tta_chunk, the forward runs once per chunk.
                # Valid for any volume shape. Same math as
                # SlidingWindowPredictor._tta_flips_apply, volume-level.
                def flipped(idx, arr):
                    bits = [(idx >> 2) & 1, (idx >> 1) & 1, idx & 1]
                    for ax, b in zip((1, 2, 3), bits):
                        if b:
                            arr = jnp.flip(arr, axis=ax)
                    return arr

                fchunk = min(self.tta_chunk, 8)
                if 8 % fchunk:
                    fchunk = 4 if fchunk >= 4 else 2 if fchunk >= 2 else 1
                xs = jnp.concatenate([flipped(i, x) for i in range(8)])
                xs = xs.reshape((8 // fchunk, fchunk) + x.shape[1:])

                def body(_, xc):
                    return None, _forward(variables, xc).astype(jnp.float32)

                _, ys = jax.lax.scan(body, None, xs)
                ys = ys.reshape((8,) + ys.shape[2:])  # (8, D, H, W, L)
                y = jnp.mean(jnp.stack(
                    [flipped(i, ys[i][None])[0] for i in range(8)]),
                    axis=0)[None]
            else:  # "permute": all 48 cube symmetries (cubic volumes only)
                from fetal_mri_segmentation_tpu.ops.augment import (
                    INVERSE_KEY_INDEX, PERMUTATION_KEYS, _permute_jnp)

                chunk = self.tta_chunk
                xs = jnp.stack([
                    jnp.transpose(_permute_jnp(vol_cdhw, PERMUTATION_KEYS[i]),
                                  (1, 2, 3, 0))
                    for i in range(48)])                 # (48, D, H, W, C)
                xs = xs.reshape((48 // chunk, chunk) + xs.shape[1:])

                def body(_, xc):
                    return None, _forward(variables, xc).astype(jnp.float32)

                _, ys = jax.lax.scan(body, None, xs)
                ys = ys.reshape((48,) + ys.shape[2:])    # (48, D, H, W, L)
                inv = [_permute_jnp(jnp.transpose(ys[i], (3, 0, 1, 2)),
                                    PERMUTATION_KEYS[INVERSE_KEY_INDEX[i]])
                       for i in range(48)]
                return jnp.mean(jnp.stack(inv), axis=0)
            return jnp.transpose(y[0], (3, 0, 1, 2)).astype(jnp.float32)

        def _labels(variables, vol_cdhw, threshold):
            # shared label-map semantics with SlidingWindowPredictor
            # (bit-packed binary / argmax->labels[i] multi-class) — one
            # implementation, utils/packing.py::device_label_map
            from fetal_mri_segmentation_tpu.utils.packing import (
                device_label_map)
            prob = _probs(variables, vol_cdhw)
            return device_label_map(prob, threshold, config.n_labels,
                                    config.labels)

        # pure program functions, exposed for utils/export.py (direct-mode
        # StableHLO artifacts serialize _labels_fn with weights baked in)
        self._probs_fn = _probs
        self._labels_fn = _labels
        self._jitted = jax.jit(_probs, in_shardings=(repl, self._vol_spec),
                               out_shardings=repl)
        self._jitted_labels = jax.jit(_labels,
                                      in_shardings=(repl, self._vol_spec),
                                      out_shardings=repl,
                                      static_argnames=("threshold",))
        # reduced-precision probability transfer twins (same rationale as
        # SlidingWindowPredictor._jitted_prob_q: fp16 halves the D2H bytes
        # at ~4.9e-4 on [0,1]; fixed-point uint8/uint16 quarter/halve them
        # at 2.0e-3 / 7.6e-6; lazy jit — unused variants cost nothing)
        from fetal_mri_segmentation_tpu.utils.residency import quantize_prob
        self._jitted_prob_q = {
            "float16": jax.jit(
                lambda v, d: _probs(v, d).astype(jnp.float16),
                in_shardings=(repl, self._vol_spec), out_shardings=repl),
            "uint8": jax.jit(
                lambda v, d: quantize_prob(_probs(v, d), "uint8"),
                in_shardings=(repl, self._vol_spec), out_shardings=repl),
            "uint16": jax.jit(
                lambda v, d: quantize_prob(_probs(v, d), "uint16"),
                in_shardings=(repl, self._vol_spec), out_shardings=repl),
        }
        self._jitted_prob16 = self._jitted_prob_q["float16"]

    def _check_volume(self, full_shape):
        """Curated error for a mis-shaped input: must be (C, D, H, W) with
        the config's channel count — a missing channel axis would otherwise
        surface as a raw transpose/conv tracer error deep inside jit."""
        n_ch = self.config.nb_channels
        if len(full_shape) != 4 or full_shape[0] != n_ch:
            raise ValueError(
                f"expected a (C={n_ch}, D, H, W) volume "
                f"(training_modalities="
                f"{tuple(self.config.training_modalities)}); got shape "
                f"{tuple(full_shape)} — stack the case's modalities on "
                "axis 0 (as preprocess_case does)")
        self._check_shape(full_shape[1:])

    def _check_shape(self, shape):
        """Fail loudly when the whole-volume forward cannot run: spatial
        dims must survive depth-1 halvings, and the depth axis must split
        evenly over the mesh's spatial shards."""
        depth = getattr(self.config, "depth", None)
        if depth is None:
            # a getattr default of 1 would silently DISABLE this guard for
            # duck-typed configs and let bad geometries fail deep inside
            # XLA instead of here with the curated message
            raise ValueError(
                "config.depth is required for whole-volume inference — the "
                "divisibility guard needs the model's pooling depth")
        d_div = 2 ** (int(depth) - 1)
        for i, s in enumerate(shape):
            if s % d_div != 0:
                raise ValueError(
                    f"whole-volume inference needs every spatial dim "
                    f"divisible by 2^(depth-1)={d_div}; volume shape "
                    f"{tuple(shape)} dim {i} is {s}. Use the sliding-window "
                    f"predictor (patching) for this geometry.")
        if shape[0] % self._n_spatial != 0:
            raise ValueError(
                f"volume depth {shape[0]} not divisible by the mesh's "
                f"{self._n_spatial} spatial shards")
        if self.tta_mode == "permute" and len(set(shape)) != 1:
            raise ValueError(
                f"48-symmetry TTA (permute) on the whole-volume predictor "
                f"requires a CUBIC volume, got {tuple(shape)} — use "
                f"tta='flips' (the 8-way flip subgroup works for any shape)")

    def _stage(self, data_cdhw):
        """Host→device staging; rounds to bf16 ON HOST for bf16 models —
        half the H2D bytes, bit-identical results (the model's first op is
        the same cast; see SlidingWindowPredictor._stage_volume). A device
        array (ops/resample.py device-preprocess path) skips the host hop
        and is only re-laid-out onto the mesh sharding."""
        if isinstance(data_cdhw, jax.Array):
            self._check_volume(data_cdhw.shape)
            self._last_shape = tuple(data_cdhw.shape[1:])
            return jax.device_put(data_cdhw, self._vol_spec)
        arr = np.asarray(data_cdhw, np.float32)
        self._check_volume(arr.shape)
        self._last_shape = tuple(arr.shape[1:])
        from fetal_mri_segmentation_tpu.utils.residency import (
            host_round_for_model)
        arr = host_round_for_model(arr, self.model)
        return jax.device_put(arr, self._vol_spec)

    def __call__(self, variables, data_cdhw) -> np.ndarray:
        variables = self.device_variables(variables)
        return np.asarray(self._jitted(variables, self._stage(data_cdhw)))

    def predict_labels_async(self, variables, data_cdhw,
                             threshold: float = 0.5) -> AsyncLabels:
        """Dispatch without blocking; finish with ``unpack_labels`` — lets
        `run_validation_cases` overlap volume i's D2H/NIfTI write with
        volume i+1's compute. The returned handle carries the volume's
        shape, so mixed-shape pipelines unpack correctly."""
        variables = self.device_variables(variables)
        staged = self._stage(data_cdhw)
        return AsyncLabels(
            self._jitted_labels(variables, staged, threshold),
            self._last_shape)

    def unpack_labels(self, out, shape=None) -> np.ndarray:
        """Materialize an async result (an `AsyncLabels` handle, or a raw
        device array plus an explicit ``shape``)."""
        if isinstance(out, AsyncLabels):
            shape = out.shape
            out = out.device_array
        if self.n_labels == 1:
            from fetal_mri_segmentation_tpu.utils.packing import (
                unpack_bit_mask)

            return unpack_bit_mask(
                out, tuple(shape) if shape is not None else self._last_shape)
        return np.asarray(out)

    def predict_labels(self, variables, data_cdhw,
                       threshold: float = 0.5) -> np.ndarray:
        return self.unpack_labels(
            self.predict_labels_async(variables, data_cdhw, threshold))

    def predict_prob_async(self, variables, data_cdhw,
                           transfer_dtype: str = "float32"):
        """Dispatch the probability program without blocking (async twin of
        `predict_labels_async`, duck-typing SlidingWindowPredictor's prob
        surface so `--direct --prob-map` batches ride the same two-stage
        pipeline); finish with ``unpack_prob``. ``transfer_dtype``:
        "float16" halves the D2H bytes (~4.9e-4 on [0,1]), "uint8"/"uint16"
        fixed-point quarters/halves them (2.0e-3 / 7.6e-6)."""
        from fetal_mri_segmentation_tpu.utils.residency import (
            resolve_prob_transfer)

        variables = self.device_variables(variables)
        staged = self._stage(data_cdhw)
        kind = resolve_prob_transfer(transfer_dtype)
        if kind != "float32":
            return self._jitted_prob_q[kind](variables, staged)
        return self._jitted(variables, staged)

    def unpack_prob(self, out) -> np.ndarray:
        """Materialize an async probability result as float32 (L, D, H, W)."""
        from fetal_mri_segmentation_tpu.utils.residency import unpack_prob_f32

        return unpack_prob_f32(out)


def make_direct_predictor(model, config, tta=False,
                          tta_chunk: Optional[int] = None
                          ) -> SpatialPredictor:
    """Single-device DIRECT whole-volume predictor (beyond-parity serving
    mode): the fully-convolutional net runs once over the whole volume —
    no patch grid, no overlap recompute, no seams (about half the
    convolution work of the 27-patch sliding window on 128^3). Requires
    volume dims
    divisible by 2^(depth-1); numerics near former patch borders differ
    from the Gaussian overlap-add average (tested close on trained models).

    ``tta``: False | "flips" | "permute"/True — VOLUME-level test-time
    augmentation (the symmetry group acts on the whole volume rather than
    on patches, so it is ~2x cheaper than the sliding-window's patch-level
    TTA: the direct pass never recomputes overlap regions).
    """
    return SpatialPredictor(
        model, config, Mesh(np.asarray(jax.devices()[:1]), ("spatial",)),
        tta=tta, tta_chunk=tta_chunk)


def make_spatial_predictor(model, config, mesh: Mesh, tta=False,
                           tta_chunk: Optional[int] = None
                           ) -> SpatialPredictor:
    """See `SpatialPredictor`."""
    return SpatialPredictor(model, config, mesh, tta=tta,
                            tta_chunk=tta_chunk)
