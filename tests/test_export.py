"""Portable StableHLO export: the artifact must reproduce the live
predictor bit-for-bit and load with no model-code dependency."""

import jax
import numpy as np

from fetal_mri_segmentation_tpu.config import Config
from fetal_mri_segmentation_tpu.inference import SlidingWindowPredictor
from fetal_mri_segmentation_tpu.models import build_model
from fetal_mri_segmentation_tpu.utils.export import (export_predictor,
                                                     load_predictor)


def test_export_roundtrip_matches_live_predictor(tmp_path):
    cfg = Config(model_name="unet", depth=2, n_base_filters=2,
                 patch_shape=(8, 8, 8), image_shape=(16, 16, 16),
                 compute_dtype="float32")
    model = build_model(cfg)
    variables = model.init(jax.random.PRNGKey(0),
                           np.zeros((1, 8, 8, 8, 1), np.float32))
    live = SlidingWindowPredictor(model, cfg, (16, 16, 16), (8, 8, 8),
                                  overlap=4, patch_batch_size=4)
    p = str(tmp_path / "model.fetal")
    export_predictor(model, cfg, variables, (16, 16, 16), p, overlap=4,
                     patch_batch_size=4)

    predict = load_predictor(p)
    assert predict.meta["n_labels"] == 1
    vol = np.random.default_rng(3).normal(
        0, 1, (1, 16, 16, 16)).astype(np.float32)
    got = predict(vol)
    want = live.predict_labels(variables, vol)
    assert got.shape == (16, 16, 16)
    assert np.array_equal(got, want)


def test_export_rejects_bad_magic(tmp_path):
    import pytest

    p = str(tmp_path / "junk.fetal")
    with open(p, "wb") as f:
        f.write(b"NOTANEXPORT")
    with pytest.raises(ValueError, match="not a fetal-segmentation export"):
        load_predictor(p)


def test_export_is_multiplatform_and_corruption_safe(tmp_path):
    """The artifact must carry (cuda, cpu) lowerings — a single-platform
    export refuses to run anywhere but the producer's backend, defeating
    the module's portability purpose. Truncation behind a valid magic
    must surface as the documented ValueError."""
    import json
    import struct

    import pytest
    from jax import export as jexport

    cfg = Config(model_name="unet", depth=2, n_base_filters=2,
                 patch_shape=(8, 8, 8), image_shape=(16, 16, 16),
                 compute_dtype="float32")
    model = build_model(cfg)
    variables = model.init(jax.random.PRNGKey(0),
                           np.zeros((1, 8, 8, 8, 1), np.float32))
    p = str(tmp_path / "model.fetal")
    export_predictor(model, cfg, variables, (16, 16, 16), p, overlap=4,
                     patch_batch_size=4)

    with open(p, "rb") as f:
        raw = f.read()
    meta_len = struct.unpack_from("<I", raw, 9)[0]
    meta = json.loads(raw[13:13 + meta_len])
    assert meta["labels"] == [1]  # effective labels, never []
    exported = jexport.deserialize(raw[13 + meta_len:])
    assert set(exported.platforms) == {"cuda", "cpu"}

    # truncated artifact with a valid magic -> documented ValueError
    for cut in (9, 11, 13 + meta_len // 2, 13 + meta_len + 10):
        bad = str(tmp_path / f"trunc_{cut}.fetal")
        with open(bad, "wb") as f:
            f.write(raw[:cut])
        with pytest.raises(ValueError, match="truncated or corrupt"):
            load_predictor(bad)


def test_export_pins_portable_decoder_form(tmp_path, monkeypatch):
    """An artifact bakes the input-dilated decoder form only when every
    target platform's gate takes it: with the gate open for the GPU alone,
    the default (cuda + cpu) export pins the parity form and a cuda-only
    export keeps the batch heuristic's dilated form — whatever the tracing
    host's own backend is."""
    import struct

    from jax import export as jexport

    from fetal_mri_segmentation_tpu.models import layers as layers_mod
    from fetal_mri_segmentation_tpu.utils.export import _MAGIC

    monkeypatch.setattr(layers_mod, "DILATED_BACKENDS", frozenset({"gpu"}))

    cfg = Config(model_name="unet", depth=2, n_base_filters=2,
                 patch_shape=(8, 8, 8), image_shape=(16, 16, 16),
                 compute_dtype="float32")
    model = build_model(cfg)
    variables = model.init(jax.random.PRNGKey(0),
                           np.zeros((1, 8, 8, 8, 1), np.float32))

    def exported_mlir(path):
        with open(path, "rb") as f:
            assert f.read(len(_MAGIC)) == _MAGIC
            (n,) = struct.unpack("<I", f.read(4))
            f.read(n)
            return jexport.deserialize(f.read()).mlir_module()

    # patch_batch_size > 1 is exactly where the heuristic picks dilated
    portable = str(tmp_path / "portable.fetal")
    export_predictor(model, cfg, variables, (16, 16, 16), portable,
                     overlap=4, patch_batch_size=4)   # default cuda+cpu
    assert "lhs_dilate" not in exported_mlir(portable)

    gpu_only = str(tmp_path / "gpu.fetal")
    export_predictor(model, cfg, variables, (16, 16, 16), gpu_only,
                     overlap=4, patch_batch_size=4, platforms=["cuda"])
    assert "lhs_dilate" in exported_mlir(gpu_only)

    # the override restored cleanly: the live CPU path still traces
    assert layers_mod._TRACE_PLATFORMS is None


def test_export_direct_roundtrip_matches_live_direct_predictor(tmp_path):
    """--export --direct serializes the whole-volume forward: the artifact
    must reproduce the live direct predictor exactly, carry direct=True in
    its meta, and reject undivisible geometries at EXPORT time."""
    import pytest

    from fetal_mri_segmentation_tpu.parallel import make_direct_predictor

    cfg = Config(model_name="unet", depth=2, n_base_filters=2,
                 patch_shape=(8, 8, 8), image_shape=(16, 16, 16),
                 compute_dtype="float32")
    model = build_model(cfg)
    variables = model.init(jax.random.PRNGKey(0),
                           np.zeros((1, 8, 8, 8, 1), np.float32))
    live = make_direct_predictor(model, cfg)
    p = str(tmp_path / "direct.fetal")
    export_predictor(model, cfg, variables, (16, 16, 16), p, direct=True)

    predict = load_predictor(p)
    assert predict.meta["direct"] is True
    vol = np.random.default_rng(5).normal(
        0, 1, (1, 16, 16, 16)).astype(np.float32)
    got = predict(vol)
    want = live.predict_labels(variables, vol)
    assert got.shape == (16, 16, 16)
    assert np.array_equal(got, want)

    # volume-level TTA bakes into the artifact too
    p2 = str(tmp_path / "direct_tta.fetal")
    export_predictor(model, cfg, variables, (16, 16, 16), p2, direct=True,
                     tta="flips")
    predict2 = load_predictor(p2)
    want2 = make_direct_predictor(model, cfg, tta="flips").predict_labels(
        variables, vol)
    assert np.array_equal(predict2(vol), want2)
    assert predict2.meta["tta"] == "flips"

    # bad geometry fails at export time with the curated error
    cfg_bad = Config(model_name="unet", depth=3, n_base_filters=2,
                     patch_shape=(8, 8, 8), image_shape=(18, 16, 16),
                     compute_dtype="float32")
    model_bad = build_model(cfg_bad)
    with pytest.raises(ValueError, match="divisible"):
        export_predictor(model_bad, cfg_bad, variables, (18, 16, 16),
                         str(tmp_path / "bad.fetal"), direct=True)
