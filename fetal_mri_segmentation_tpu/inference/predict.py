"""Per-case validation inference: NIfTI outputs + label-map conversion.

Reference: unet3d/prediction.py::run_validation_cases, run_validation_case,
prediction_to_image, get_prediction_labels, multi_class_prediction.

Output tree parity: one directory per case (``validation_case_<idx>`` or the
subject id) containing ``data_<modality>.nii.gz``, ``truth.nii.gz`` and
``prediction.nii.gz``, with the case affine from the HDF5 ``affine`` array.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from fetal_mri_segmentation_tpu.inference.sliding_window import (
    SlidingWindowPredictor)
from fetal_mri_segmentation_tpu.utils.io_utils import pickle_load
from fetal_mri_segmentation_tpu.utils.nifti import NiftiImage, save_nifti


# conversion semantics live in the numpy-only labelmaps module (host
# tooling imports them without the jax stack); re-exported here so every
# established import path keeps working
from fetal_mri_segmentation_tpu.inference.labelmaps import (  # noqa: F401
    get_prediction_labels, label_map_dtype, prediction_to_image)


def _write_probability(probability, config, out_dir: str, affine,
                       submit, scl_slope: float = 1.0) -> np.ndarray:
    """ONE probability-write implementation for both serving surfaces
    (run_validation_case and predict_case) — same no-drift rule as
    _write_prediction.

    ``scl_slope != 1``: the array is a fixed-point quantized map stored
    as-is (uint8/uint16) with NIfTI value scaling — 4x/2x smaller files
    AND gzip time than float32, while every scl-aware reader (our loader,
    nibabel) still returns the same [0,1] floats the float32 write would
    hold."""
    image = prediction_to_image(probability, affine, label_map=False,
                                labels=config.labels)
    path = os.path.join(out_dir, "prediction.nii.gz")
    submit(path, save_nifti, image, path, scl_slope=scl_slope)
    return probability


def _load_case(case_index, out_dir, data_file, config, submit,
               save_inputs: bool):
    """Read one case from HDF5; queue the reference's input/truth NIfTIs."""
    os.makedirs(out_dir, exist_ok=True)
    affine = np.asarray(data_file.root.affine[case_index])
    data = np.asarray(data_file.root.data[case_index], np.float32)
    if save_inputs:
        for i, modality in enumerate(config.training_modalities):
            path = os.path.join(out_dir, f"data_{modality}.nii.gz")
            submit(path, save_nifti, data[i], path, affine=affine)
        truth = np.asarray(data_file.root.truth[case_index][0])
        path = os.path.join(out_dir, "truth.nii.gz")
        submit(path, save_nifti, truth.astype(np.uint8), path, affine=affine)
    return data, affine


def _scale_binary_label(label_map, config):
    """Binary maps carry the configured label value (reference:
    prediction_to_image — data>threshold → labels[0])."""
    if config.n_labels == 1 and config.labels:
        # widen before scaling: labels[0] > 255 must not wrap modulo 256
        dt = label_map_dtype([config.labels[0]])
        return label_map.astype(dt) * dt.type(config.labels[0])
    return label_map


def run_validation_case(case_index: int, out_dir: str, model, variables,
                        data_file, config, predictor: SlidingWindowPredictor,
                        output_label_map: bool = True, threshold: float = 0.5,
                        save_inputs: bool = True,
                        io_submit=None) -> np.ndarray:
    """Predict one stored case; writes the reference's per-case output tree.

    Reference: prediction.py::run_validation_case.

    ``io_submit``: optional ``submit(target, fn, *args, **kwargs)`` — NIfTI
    writes are queued on it so gzip+disk IO of case *i* overlaps the device
    predict of case *i+1*. ``target`` is the write's destination path,
    passed explicitly so the caller can attribute a failed future to its
    artifact (serve.py keys lost-prediction accounting on it).
    """
    submit = io_submit if io_submit is not None else (
        lambda target, fn, *a, **kw: fn(*a, **kw))
    data, affine = _load_case(case_index, out_dir, data_file, config,
                              submit, save_inputs)

    if output_label_map:
        # label map computed on device (reference: prediction_to_image
        # threshold/argmax) — only uint8/packed bits cross the device link.
        label_map = predictor.predict_labels(variables, data,
                                             threshold=threshold)
        return _write_prediction(label_map, config, out_dir, affine, submit)
    probability = predictor(variables, data)
    return _write_probability(probability, config, out_dir, affine, submit)


def load_serving_model(config):
    """Shared CLI plumbing: build the model, restore the checkpoint
    (compile-free abstract template), assemble the ``variables`` dict.
    Used by predict.py and serve.py so the two serving entry points cannot
    diverge."""
    import jax

    from fetal_mri_segmentation_tpu.models import build_model
    from fetal_mri_segmentation_tpu.training.checkpoint import load_old_model

    model = build_model(config)
    state, _, _ = load_old_model(config.model_file, model, config)
    variables = {"params": state.params}
    if jax.tree_util.tree_leaves(state.batch_stats):
        variables["batch_stats"] = state.batch_stats
    return model, variables


def make_device_preprocessor(model, config, moments=None):
    """Shared CLI plumbing: the serving-ingest DevicePreprocessor
    (zoom + normalize on device) configured for ``model``'s compute dtype —
    one factory for serve.py and predict.py --input so the staging-dtype
    logic cannot drift between the two surfaces.

    bf16 raw-volume staging halves the H2D bytes (the win on thin links;
    measured serve 0.52 -> 0.28 s/case on croppable volumes, docs/PERF.md
    round-3 addendum 8); f32 for f32 models keeps fp-level parity with the
    host path. compute_dtype matches the model so the preprocessor's output
    enters the predictor pre-cast — otherwise a bf16 model's label program
    compiles a SECOND signature for the f32 input and every case pays an
    extra on-device cast program.
    """
    import jax.numpy as jnp

    from fetal_mri_segmentation_tpu.ops.resample import DevicePreprocessor

    transfer = (jnp.bfloat16 if getattr(model, "dtype", None) == jnp.bfloat16
                else jnp.float32)
    return DevicePreprocessor(
        config.image_shape, config.normalization,
        moments=(moments if moments is not None
                 else load_global_moments(config.data_file)
                 if config.normalization == "global" else None),
        compute_dtype=transfer, transfer_dtype=transfer)


def resolve_tta(tta: bool, tta_mode):
    """Shared CLI plumbing: combine ``--tta`` / ``--tta-mode`` into the
    predictor's tta argument (False | "permute" | "flips").

    ``--tta-mode`` alone IMPLIES ``--tta`` — a user who asked for a specific
    TTA mode must never silently get no TTA at all; bare ``--tta`` defaults
    to the full 48-symmetry average.
    """
    return tta_mode or ("permute" if tta else False)


def build_serving_predictor(model, config, *, direct: bool = False,
                            tta=False, overlap: int = 16,
                            patch_batch_size: int = 8):
    """Shared CLI plumbing: one predictor factory for both serving entry
    points (sliding-window parity path or direct whole-volume mode).

    ``--direct --tta`` composes: the direct predictor averages the symmetry
    group over the WHOLE volume (one compiled scan of direct forwards) —
    ~2x less device time than the sliding window's patch-level TTA because
    overlap regions are never recomputed. 48-symmetry ("permute") needs a
    cubic volume; "flips" works for any direct-compatible geometry.

    ``tta``: False | True/"permute" | "flips" (see ``resolve_tta``).

    Direct-mode geometry (divisibility by 2^(depth-1), cubic volume for
    permute TTA) is validated HERE against ``config.image_shape`` — every
    served case is preprocessed to that shape, so a bad combination must
    fail at predictor construction (server startup / CLI launch), not
    surface per-case inside serve.py's quarantine loop where a permanently
    misconfigured server would look healthy while predicting nothing."""
    if direct:
        from fetal_mri_segmentation_tpu.parallel.spatial import (
            make_direct_predictor)

        predictor = make_direct_predictor(model, config, tta=tta)
        predictor._check_shape(tuple(config.image_shape))
        return predictor
    return SlidingWindowPredictor(
        model, config, image_shape=config.image_shape, overlap=overlap,
        patch_batch_size=patch_batch_size, tta_permute=tta)


def resolve_case_files(path: str, config) -> tuple:
    """Resolve an ad-hoc input for `predict_case`.

    A directory is resolved to ``<dir>/<modality>.nii[.gz]`` per
    ``config.training_modalities`` (the train-time data layout), plus
    ``truth.nii[.gz]`` when present. A single NIfTI file is a one-modality
    case. Returns ``(modality_files, truth_file_or_None)``.
    """
    if os.path.isdir(path):
        files = []
        for m in config.training_modalities:
            for ext in (".nii.gz", ".nii"):
                p = os.path.join(path, m + ext)
                if os.path.exists(p):
                    files.append(p)
                    break
            else:
                raise FileNotFoundError(
                    f"{path}: missing modality file {m}.nii[.gz] "
                    f"(training_modalities={config.training_modalities})")
        truth = None
        for ext in (".nii.gz", ".nii"):
            p = os.path.join(path, "truth" + ext)
            if os.path.exists(p):
                truth = p
                break
        return files, truth
    if len(config.training_modalities) != 1:
        raise ValueError(
            f"{path}: a bare NIfTI file only works for single-modality "
            f"configs; this config trains on "
            f"{config.training_modalities} — pass the case DIRECTORY")
    return [path], None


def load_global_moments(data_file_path: str):
    """Training-distribution (mean, std) persisted by the dataset builder
    (data/build.py stores h5 attrs ``norm_mean``/``norm_std`` for
    ``normalization="global"``); None when unavailable."""
    import h5py

    if not os.path.exists(data_file_path):
        return None
    with h5py.File(data_file_path, "r") as h5:
        if "norm_mean" in h5.attrs:
            return (np.asarray(h5.attrs["norm_mean"]),
                    np.asarray(h5.attrs["norm_std"]))
    return None


def preprocess_case(input_path: str, config, *, crop: bool = True,
                    global_moments=None, device_pre=None):
    """Builder-identical preprocessing of an ad-hoc NIfTI case.

    Runs the SAME pipeline the dataset builder applies (shared background
    crop — including truth when present, matching
    data.py::write_data_to_file — resample to ``config.image_shape``, the
    configured normalization). Returns ``(data, affine, truth_image)`` with
    ``data`` the normalized (C, D, H, W) float32 stack, ``affine`` the
    build-adjusted affine and ``truth_image`` a NiftiImage or None.

    Split out of `predict_case` so a streaming server can pipeline: case
    *i+1*'s host preprocessing runs while case *i*'s device predict is in
    flight (serve.py::watch_and_predict).

    ``device_pre`` (an ops/resample.py::DevicePreprocessor) moves the zoom
    + normalization onto the device: the host only reads + crops, and the
    returned ``data`` is a DEVICE array the predictor consumes without a
    host round-trip (fp-level, not bit-level, parity with the host path —
    both are pinned to the scipy oracle in tests). Truth resampling stays
    host-side (order-0 is cheap and keeps evaluate-path bytes identical).
    """
    from fetal_mri_segmentation_tpu.data.normalize import normalize_case
    from fetal_mri_segmentation_tpu.utils.geometry import (
        process_case_images, zoomed_affine)
    from fetal_mri_segmentation_tpu.utils.nifti import load_nifti

    files, truth_file = resolve_case_files(input_path, config)
    all_files = files + ([truth_file] if truth_file else [])
    # single-read preprocessing (each gzipped file decompressed once);
    # label_indices MUST be explicit: without a truth file the default
    # ("last file is the label") would nearest-neighbor-resample the last
    # MODALITY, silently breaking ingest parity.
    label_indices = [len(all_files) - 1] if truth_file else []
    loaded = [load_nifti(f) for f in all_files]

    if device_pre is not None:
        from fetal_mri_segmentation_tpu.utils.geometry import (
            resample_to_shape)

        # the device path normalizes with device_pre's OWN settings — a
        # mismatch with the config would silently return data normalized
        # into a different distribution than training
        if device_pre.normalization != config.normalization:
            raise ValueError(
                f"device_pre was built with normalization="
                f"{device_pre.normalization!r} but config.normalization="
                f"{config.normalization!r} — predictions would be shifted "
                "into a different intensity distribution than training")
        # validate against the preprocessor's HOST-side copies: reading
        # back the device arrays here would force a blocking D2H sync per
        # case inside the pipelined serving hot loop
        host_moments = getattr(device_pre, "_host_moments", None)
        if (global_moments is not None
                and host_moments is not None
                and not (np.allclose(global_moments[0], host_moments[0])
                         and np.allclose(global_moments[1],
                                         host_moments[1]))):
            raise ValueError(
                "device_pre's global normalization moments differ from the "
                "global_moments passed to preprocess_case — build the "
                "DevicePreprocessor with the same training moments")
        # host: crop only (image_shape=None skips the host zoom)
        cropped = process_case_images(loaded, image_shape=None, crop=crop,
                                      label_indices=label_indices)
        old_shape = tuple(cropped[0].shape[:3])
        affine = (zoomed_affine(cropped[0].affine, old_shape,
                                config.image_shape)
                  if old_shape != tuple(config.image_shape)
                  else cropped[0].affine)
        data = device_pre([img.get_fdata(dtype=np.float32)
                           for img in cropped[:len(files)]])
        truth_image = None
        if truth_file:
            truth_image = cropped[-1]
            if tuple(truth_image.shape[:3]) != tuple(config.image_shape):
                truth_image = resample_to_shape(
                    truth_image, config.image_shape, "nearest")
        return data, affine, truth_image

    images = process_case_images(
        loaded, image_shape=config.image_shape, crop=crop,
        label_indices=label_indices)
    affine = images[0].affine
    data = np.stack([img.get_fdata(dtype=np.float32)
                     for img in images[:len(files)]], axis=0)

    if config.normalization == "global" and global_moments is None:
        global_moments = load_global_moments(config.data_file)
    mean, std = global_moments if global_moments else (None, None)
    data = normalize_case(data, config.normalization, mean=mean, std=std)
    return data, affine, (images[-1] if truth_file else None)


def _save_modality_f32(arr, path, affine):
    """Write one modality as float32 — converts INSIDE the IO worker so a
    device array (device-preprocess path) pays its D2H off the hot loop."""
    save_nifti(np.asarray(arr, dtype=np.float32), path, affine=affine)


def queue_input_writes(data, truth_image, config, out_dir, affine, submit):
    """Queue the per-case ``data_<modality>`` / ``truth`` NIfTI writes —
    shared by the per-case API and the pipelined stream so the output tree
    cannot diverge between them."""
    for i, modality in enumerate(config.training_modalities):
        path = os.path.join(out_dir, f"data_{modality}.nii.gz")
        submit(path, _save_modality_f32, data[i], path, affine)
    if truth_image is not None:
        path = os.path.join(out_dir, "truth.nii.gz")
        submit(path, save_nifti,
               truth_image.get_fdata(dtype=np.float32).astype(np.uint8),
               path, affine=affine)


def predict_case(input_path: str, out_dir: str, model, variables, config,
                 predictor: Optional[SlidingWindowPredictor] = None,
                 overlap: int = 16, threshold: float = 0.5,
                 permute: bool = False, patch_batch_size: int = 8,
                 save_inputs: bool = True, crop: bool = True,
                 global_moments=None, io_submit=None,
                 device_pre=None, output_label_map: bool = True) -> np.ndarray:
    """Predict a case straight from NIfTI files — no HDF5 ingest required.

    The reference can only predict cases already written into its HDF5
    dataset (prediction.py::run_validation_cases reads the hdf5_file); a new
    scan required a rebuild. This runs builder-identical preprocessing
    (`preprocess_case`) and predicts with the same compiled predictor, so a
    case ingested-then-predicted and a case predicted ad-hoc produce
    identical label maps (regression-tested).

    Writes the usual per-case tree under ``out_dir`` (``data_<modality>``,
    optional ``truth``, ``prediction.nii.gz``, affine = the build-adjusted
    affine). Returns the label map. ``io_submit``: optional
    ``submit(target, fn, *args, **kwargs)`` — NIfTI gzip+disk writes are
    queued on it so a caller serving a stream can overlap case *i*'s writes
    with case *i+1*'s compute; ``target`` is the destination path, passed
    explicitly for failure attribution (see serve.py::watch_and_predict).
    """
    data, affine, truth_image = preprocess_case(
        input_path, config, crop=crop, global_moments=global_moments,
        device_pre=device_pre)

    os.makedirs(out_dir, exist_ok=True)
    submit = io_submit if io_submit is not None else (
        lambda target, fn, *a, **kw: fn(*a, **kw))
    if save_inputs:
        queue_input_writes(data, truth_image, config, out_dir, affine,
                           submit)

    if predictor is None:
        predictor = SlidingWindowPredictor(
            model, config, image_shape=config.image_shape, overlap=overlap,
            patch_batch_size=patch_batch_size, tta_permute=permute)
    if not output_label_map:
        # probability map instead of the thresholded/argmaxed labels
        # (reference: run_validation_case with output_label_map=False)
        probability = predictor(variables, data)
        return _write_probability(probability, config, out_dir, affine,
                                  submit)
    label_map = predictor.predict_labels(variables, data,
                                         threshold=threshold)
    return _write_prediction(label_map, config, out_dir, affine, submit)


def _drive_pipeline(case_stream, dispatch, finalize) -> int:
    """The two-stage overlap skeleton shared by the label and probability
    pipelines (serve.py has its own copy because its quarantine semantics
    differ per stage).

    ``case_stream`` yields ``(data, affine, out_dir, done_msg_or_None)``
    per case, doing its own host preprocessing as it is pulled — that is
    what overlaps the previous case's device compute. Each case's device
    program is dispatched immediately; case *i* is finalized (D2H +
    conversion + queued NIfTI write) after case *i+1*'s dispatch is in
    flight.

    The LAST dispatched case is guaranteed to be finalized even when a
    later case's preprocessing raises (a completed prediction must not be
    dropped because a DIFFERENT case is corrupt); in that path the
    original exception propagates, never masked by a secondary finalize
    failure. Returns the number of cases dispatched+finalized.
    """
    n = 0
    pending = None  # (out_dev, out_dir, affine, done_msg)
    try:
        for data, affine, out_dir, msg in case_stream:
            out_dev = dispatch(data)
            if pending is not None:
                finalize(pending)
            pending = (out_dev, out_dir, affine, msg)
            n += 1
    except BaseException:
        if pending is not None:
            try:
                finalize(pending)
            except Exception:
                pass  # best-effort — never mask the original error
        raise
    if pending is not None:
        finalize(pending)
    return n


def _msg_submit(submit, msg):
    """Wrap a submit so ``msg`` prints from the IO worker AFTER that case's
    prediction write has actually executed — never before (a success line
    must not precede a write that can still fail)."""
    if msg is None:
        return submit

    def write_submit(target, fn, *a, _msg=msg, **kw):
        def run():
            fn(*a, **kw)
            print(_msg, flush=True)
        submit(target, run)
    return write_submit


def _drive_label_pipeline(case_stream, predictor, variables, config,
                          threshold, submit) -> int:
    """Label-map pipeline: packed-bit D2H, threshold/argmax on device."""
    def finalize(p):
        out_dev, out_dir, affine, msg = p
        label_map = predictor.unpack_labels(out_dev)
        _write_prediction(label_map, config, out_dir, affine,
                          _msg_submit(submit, msg))

    return _drive_pipeline(
        case_stream,
        lambda data: predictor.predict_labels_async(variables, data,
                                                    threshold=threshold),
        finalize)


def _drive_prob_pipeline(case_stream, predictor, variables, config,
                         submit, transfer_dtype: str = "float32") -> int:
    """Probability pipeline: same overlap core for `--prob-map` surfaces
    (ensembling workflows move L x volume floats per case — the async
    dispatch + IO-worker overlap the label path gets, plus reduced-
    precision D2H: fp16-packed halves the transfer at <=4.9e-4, and the
    fixed-point uint8/uint16 transfers stay integer ALL the way to disk
    via NIfTI scl_slope scaling, so the gzip write shrinks 4x/2x too —
    measured the write, not the D2H, as the quiet-host bottleneck
    (docs/PERF.md addendum 17))."""
    from fetal_mri_segmentation_tpu.utils.residency import (
        _QUANT_SCALE, resolve_prob_transfer)

    kind = resolve_prob_transfer(transfer_dtype)

    def finalize(p):
        out_dev, out_dir, affine, msg = p
        if kind in _QUANT_SCALE:
            # keep the integer volume: the NIfTI stores it with
            # scl_slope=1/scale; every scl-aware reader dequantizes to the
            # floats the f32 write would hold (within 1 ulp — the loader
            # computes stored * float32(1/scale), unpack_prob divides)
            _write_probability(np.asarray(out_dev), config, out_dir, affine,
                               _msg_submit(submit, msg),
                               scl_slope=1.0 / _QUANT_SCALE[kind])
            return
        probability = predictor.unpack_prob(out_dev)
        _write_probability(probability, config, out_dir, affine,
                           _msg_submit(submit, msg))

    return _drive_pipeline(
        case_stream,
        lambda data: predictor.predict_prob_async(
            variables, data, transfer_dtype=transfer_dtype),
        finalize)


def predict_cases_pipelined(cases, model, variables, config, predictor,
                            *, threshold: float = 0.5, global_moments=None,
                            save_inputs: bool = True, device_pre=None,
                            verbose: bool = True,
                            output_label_map: bool = True,
                            prob_dtype: str = "float32") -> int:
    """Predict a SEQUENCE of ad-hoc NIfTI cases with the two-stage pipeline.

    ``cases``: iterable of ``(input_path, out_dir)``. Same artifacts as
    calling :func:`predict_case` per case (regression-tested identical),
    but case *i*'s host preprocessing + H2D overlaps case *i-1*'s device
    compute + D2H, and all NIfTI writes run on a worker thread — the same
    overlap `run_validation_cases` and serve.py use, for the
    ``predict.py --input`` surface. Unlike serve.py, errors PROPAGATE
    (a CLI batch should fail loudly, not quarantine) — but cases already
    predicted before the failing one keep their artifacts. Returns the
    number of cases predicted.

    ``output_label_map=False`` rides the same pipeline with the async
    probability surface; ``prob_dtype="float16"`` additionally halves the
    probability D2H (<=4.9e-4 quantization on [0,1] — opt-in; the written
    NIfTI stays float32-typed).
    """
    from concurrent.futures import ThreadPoolExecutor

    label_async = (hasattr(predictor, "predict_labels_async")
                   and hasattr(predictor, "unpack_labels"))
    prob_async = hasattr(predictor, "predict_prob_async")
    pipelined = label_async if output_label_map else prob_async
    if not pipelined:
        # predictor without the async surface runs serially
        n = 0
        for path, out_dir in cases:
            predict_case(path, out_dir, model, variables, config,
                         predictor=predictor, threshold=threshold,
                         global_moments=global_moments,
                         save_inputs=save_inputs, device_pre=device_pre,
                         output_label_map=output_label_map)
            if verbose:
                print(f"{path} -> {out_dir}/prediction.nii.gz")
            n += 1
        return n

    futures = []
    with ThreadPoolExecutor(max_workers=2) as pool:
        def submit(target, fn, *a, **kw):
            futures.append(pool.submit(fn, *a, **kw))

        def stream():
            for path, out_dir in cases:
                data, affine, truth_image = preprocess_case(
                    path, config, global_moments=global_moments,
                    device_pre=device_pre)
                os.makedirs(out_dir, exist_ok=True)
                if save_inputs:
                    queue_input_writes(data, truth_image, config, out_dir,
                                       affine, submit)
                yield (data, affine, out_dir,
                       f"{path} -> {out_dir}/prediction.nii.gz"
                       if verbose else None)

        if output_label_map:
            n = _drive_label_pipeline(stream(), predictor, variables,
                                      config, threshold, submit)
        else:
            n = _drive_prob_pipeline(stream(), predictor, variables, config,
                                     submit, transfer_dtype=prob_dtype)
    for f in futures:  # surface any write error after all IO drained
        f.result()
    return n


class _FnAdapter:
    """Duck-types the predictor interface around a probability-map function
    (mesh-sharded or spatial whole-volume predict): label maps are derived
    on host with the reference's threshold/argmax semantics."""

    def __init__(self, predict_fn, config):
        self._fn = predict_fn
        self._config = config

    def __call__(self, variables, data):
        return self._fn(variables, data)

    def predict_labels(self, variables, data, threshold=0.5):
        prob = self._fn(variables, data)
        if self._config.n_labels == 1:
            return (prob[0] > threshold).astype(np.uint8)
        return get_prediction_labels(prob, threshold=threshold,
                                     labels=self._config.labels)


def _write_prediction(label_map, config, case_dir, affine, submit):
    """The single place the per-case prediction artifact is produced
    (binary label scaling + NIfTI write) — used by both the per-case API
    and the pipelined stream so they cannot diverge."""
    label_map = _scale_binary_label(label_map, config).astype(
        label_map_dtype(config.labels or range(1, config.n_labels + 1)))
    path = os.path.join(case_dir, "prediction.nii.gz")
    submit(path, save_nifti, label_map, path, affine=affine)
    return label_map


def run_validation_cases(validation_keys_file: str, model, variables,
                         data_file, config, output_dir: str = "prediction",
                         overlap: int = 16, threshold: float = 0.5,
                         output_label_map: bool = True,
                         permute=False,
                         patch_batch_size: int = 8,
                         mesh=None, spatial_mesh=None,
                         prob_dtype: str = "float32") -> None:
    """Predict every validation case into ``output_dir/validation_case_<i>``.

    Reference: prediction.py::run_validation_cases (same output layout; the
    predictor executable is built once and reused across cases — all volumes
    share the dataset's uniform image_shape).

    ``permute``: False | True/"permute" (48-symmetry TTA, the reference's
    ``predict(permute=True)``) | "flips" (8-way subgroup) — the normalized
    value from ``resolve_tta``, not just a bool.
    ``mesh``: optional multi-device ``jax.sharding.Mesh`` — the patch grid is
    sharded across devices (net-new; parallel/distributed.py).
    ``spatial_mesh``: alternative inference mode — ONE whole-volume forward
    with the depth axis sharded over the mesh (XLA halo exchange; no
    patching, no overlap seams; parallel/spatial.py). Volume dims must be
    divisible by 2^(depth-1) and the mesh's spatial factor.
    """
    validation_indices = pickle_load(validation_keys_file)
    image_shape = tuple(data_file.root.data.shape[-3:])
    if spatial_mesh is not None:
        if mesh is not None and len(mesh.devices.flat) > 1:
            raise ValueError(
                "spatial_mesh and patch-grid mesh are mutually exclusive "
                "inference modes — pass one of --spatial-devices / "
                "--num-devices")
        from fetal_mri_segmentation_tpu.parallel import make_spatial_predictor

        # SpatialPredictor duck-types the serving surface directly
        # (device-side label maps, resident params). ``permute`` here means
        # VOLUME-level TTA (the symmetry group acts on the whole volume —
        # ~2x cheaper than patch-level TTA; 48-symmetry needs cubic volumes,
        # which the predictor checks with a curated error).
        predictor = make_spatial_predictor(model, config, spatial_mesh,
                                           tta=permute)
    else:
        predictor = SlidingWindowPredictor(
            model, config, image_shape=image_shape, overlap=overlap,
            patch_batch_size=patch_batch_size, tta_permute=permute)
        if mesh is not None and len(mesh.devices.flat) > 1:
            from fetal_mri_segmentation_tpu.parallel.distributed import (
                make_sharded_predictor)

            predictor = _FnAdapter(make_sharded_predictor(predictor, mesh),
                                   config)

    subject_ids = None
    if "subject_ids" in data_file._h5:
        subject_ids = [s.decode() if isinstance(s, bytes) else str(s)
                       for s in data_file.root.subject_ids[:]]

    from concurrent.futures import ThreadPoolExecutor

    # Two-stage pipeline: the device predict of case i+1 is dispatched
    # before case i's result is pulled to host (jax async dispatch hides the
    # dispatch/D2H overhead), and all NIfTI gzip+disk writes run on a worker
    # pool overlapping both. The overlap core is shared with
    # predict_cases_pipelined (_drive_label_pipeline).
    pipelined = (hasattr(predictor, "predict_labels_async")
                 if output_label_map
                 else hasattr(predictor, "predict_prob_async"))
    futures = []
    with ThreadPoolExecutor(max_workers=2) as pool:
        def submit(target, fn, *a, **kw):
            # target (the write's destination path) is unused here — errors
            # surface collectively at the end; serve.py's submit uses it
            futures.append(pool.submit(fn, *a, **kw))

        def case_dir_of(index):
            name = (subject_ids[index] if subject_ids
                    else f"validation_case_{index}")
            return os.path.join(output_dir, name)

        if not pipelined:
            for index in validation_indices:
                run_validation_case(index, case_dir_of(index), model,
                                    variables, data_file, config, predictor,
                                    threshold=threshold,
                                    output_label_map=output_label_map,
                                    io_submit=submit)
        else:
            def stream():
                for index in validation_indices:
                    case_dir = case_dir_of(index)
                    data, affine = _load_case(index, case_dir, data_file,
                                              config, submit,
                                              save_inputs=True)
                    yield data, affine, case_dir, None
            if output_label_map:
                _drive_label_pipeline(stream(), predictor, variables,
                                      config, threshold, submit)
            else:
                _drive_prob_pipeline(stream(), predictor, variables, config,
                                     submit, transfer_dtype=prob_dtype)
    for f in futures:  # surface any write error after all IO drained
        f.result()
