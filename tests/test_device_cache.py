"""Device-resident case cache: exact parity with the host staging path.

The cached pipeline (pipeline/device_cache.py) must train on bitwise the
same batches in the same order as the host pipeline (generator.py +
training/loop.py::_compress) — these tests pin every link of that claim:
grid margins, the device gather's zero-pad semantics, label conversion,
the rng-parity index stream, and full-step equality (f32 and bf16).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fetal_mri_segmentation_tpu.config import Config
from fetal_mri_segmentation_tpu.data import open_data_file, write_data_to_file
from fetal_mri_segmentation_tpu.ops.patches import (
    compute_patch_indices, get_patch_from_3d_data)
from fetal_mri_segmentation_tpu.pipeline import data_generator
from fetal_mri_segmentation_tpu.pipeline.device_cache import (
    DeviceCaseCache, convert_labels_device, estimate_cache_bytes,
    index_batch_generator, make_cached_eval_step, make_cached_train_step,
    make_gather, maybe_build_device_cache, plan_margins)
from fetal_mri_segmentation_tpu.pipeline.generator import (
    convert_data, create_patch_index_list, get_validation_split)
from tests.synthetic import write_synthetic_dataset


@pytest.fixture(scope="module")
def data_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("devcache")
    files = write_synthetic_dataset(str(d / "nii"), n_cases=5,
                                    shape=(20, 20, 20))
    out = str(d / "data.h5")
    write_data_to_file(files, out, image_shape=(16, 16, 16),
                       normalize="per_volume", crop=False)
    f = open_data_file(out)
    yield f
    f.close()


# ---------------------------------------------------------------------------
# Margins
# ---------------------------------------------------------------------------

def test_margins_cover_all_grids():
    rng = np.random.default_rng(0)
    for _ in range(25):
        shape = tuple(int(rng.integers(9, 40)) for _ in range(3))
        patch = tuple(int(rng.integers(4, min(12, min(shape)))) for _ in range(3))
        overlap = int(rng.integers(0, min(patch) - 1))
        offset = tuple(int(rng.integers(0, p)) for p in patch)
        lo, hi = plan_margins(shape, patch, overlap, offset)
        # validation grid
        corners = [compute_patch_indices(shape, patch, overlap=overlap)]
        # training grids across many random offsets
        r = np.random.default_rng(1)
        for _ in range(20):
            idx = create_patch_index_list([0], shape, patch, 0, offset, r)
            corners.append(np.array([c for _, c in idx]))
        corners = np.concatenate(corners)
        assert (corners + lo >= 0).all(), (shape, patch, overlap, offset)
        ends = corners + np.array(patch)
        assert (ends <= np.array(shape) + hi).all()


def test_margins_no_offset_uses_centered_grid():
    lo, hi = plan_margins((15, 15, 15), (8, 8, 8), 0, None)
    # centered training grid: overflow 1 -> start -1
    assert all(l >= 1 for l in lo)


# ---------------------------------------------------------------------------
# Gather + label conversion
# ---------------------------------------------------------------------------

def test_gather_matches_host_patch_extraction():
    rng = np.random.default_rng(3)
    vol = rng.normal(size=(2, 1, 10, 12, 9)).astype(np.float32)
    patch = (6, 6, 6)
    lo, hi = (6, 6, 6), (6, 6, 6)
    padded = np.pad(vol, [(0, 0), (0, 0)] + [(l, h) for l, h in zip(lo, hi)])
    stack = jnp.asarray(padded)
    gather = make_gather(patch, lo)
    corners = np.array([[-3, 0, 2], [0, 8, -1], [5, 7, 4], [-6, -6, -6]],
                       dtype=np.int32)
    rows = np.array([0, 1, 1, 0], dtype=np.int32)
    got = np.asarray(gather(stack, jnp.asarray(rows), jnp.asarray(corners)))
    for b in range(len(rows)):
        want = get_patch_from_3d_data(vol[rows[b]], patch, corners[b])
        np.testing.assert_array_equal(got[b], want)


def test_convert_labels_device_matches_host():
    rng = np.random.default_rng(4)
    truth = rng.integers(0, 6, size=(3, 1, 4, 4, 4)).astype(np.uint8)
    # binary
    y_dev = np.asarray(convert_labels_device(jnp.asarray(truth), 1, None))
    _, y_host = convert_data([np.zeros_like(truth[0], np.float32)] * 3,
                             [t.astype(np.float32) for t in truth], n_labels=1)
    np.testing.assert_array_equal(y_dev, y_host)
    # multi-class with explicit labels
    labels = (2, 5, 1)
    y_dev = np.asarray(convert_labels_device(jnp.asarray(truth), 3, labels))
    _, y_host = convert_data([np.zeros_like(truth[0], np.float32)] * 3,
                             [t.astype(np.float32) for t in truth],
                             n_labels=3, labels=labels)
    np.testing.assert_array_equal(y_dev, y_host)


# ---------------------------------------------------------------------------
# Index stream parity with data_generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shuffle,offset,overlap", [
    (True, (4, 4, 4), 0),   # training shape
    (False, None, 2),       # validation shape
])
def test_index_stream_matches_data_generator(data_file, shuffle, offset,
                                             overlap):
    ids = [0, 1, 2, 3]
    row_of = {i: r for r, i in enumerate(ids)}
    cases = {i: (np.asarray(data_file.root.data[i], np.float32),
                 np.asarray(data_file.root.truth[i], np.float32))
             for i in ids}
    kw = dict(batch_size=3, patch_shape=(8, 8, 8), patch_overlap=overlap,
              patch_start_offset=offset, shuffle_index_list=shuffle,
              skip_blank=True, seed=7)
    host = data_generator(data_file, ids, n_labels=1, **kw)
    idx = index_batch_generator(data_file, ids, row_of, **kw)
    inv = {r: i for i, r in row_of.items()}
    for _ in range(9):  # crosses epoch boundaries incl. partial batches
        xh, yh = next(host)
        rows, corners, n_valid = next(idx)
        assert n_valid == xh.shape[0]
        for b in range(n_valid):
            case = inv[int(rows[b])]
            x = get_patch_from_3d_data(cases[case][0], (8, 8, 8), corners[b])
            y = get_patch_from_3d_data(cases[case][1], (8, 8, 8), corners[b])
            np.testing.assert_array_equal(xh[b], x)
            np.testing.assert_array_equal(yh[b], (y > 0).astype(np.float32))


def test_index_stream_all_blank_raises(data_file):
    # a synthetic data_file whose truth is all zeros must raise, not hang
    class _Root:
        pass

    class _File:
        root = _Root()

    f = _File()
    f.root.data = np.zeros((2, 1, 8, 8, 8), np.float32)
    f.root.truth = np.zeros((2, 1, 8, 8, 8), np.uint8)
    gen = index_batch_generator(f, [0, 1], {0: 0, 1: 1}, batch_size=2,
                                patch_shape=(4, 4, 4), skip_blank=True)
    with pytest.raises(RuntimeError, match="no batches"):
        next(gen)


# ---------------------------------------------------------------------------
# Full-step equality vs the host staging path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_cached_step_equals_host_step(data_file, tmp_path, compute_dtype):
    import ml_dtypes

    from fetal_mri_segmentation_tpu.models import build_model
    from fetal_mri_segmentation_tpu.training import create_train_state
    from fetal_mri_segmentation_tpu.training.train_step import (
        make_eval_step, make_train_step, pad_batch)

    config = Config(model_name="unet", depth=2, n_base_filters=2,
                    image_shape=(16, 16, 16), patch_shape=(8, 8, 8),
                    batch_size=3, compute_dtype=compute_dtype,
                    training_patch_start_offset=(4, 4, 4),
                    augment=True, flip=True, permute=True, contrast=0.1)
    model = build_model(config)
    state_h = create_train_state(model, config, jax.random.PRNGKey(0))
    state_c = create_train_state(model, config, jax.random.PRNGKey(0))

    ids = [0, 1, 2]
    row_of = {i: r for r, i in enumerate(ids)}
    lo, hi = plan_margins((16, 16, 16), (8, 8, 8), 0, (4, 4, 4))
    dtype = jnp.bfloat16 if compute_dtype == "bfloat16" else jnp.float32
    cache = DeviceCaseCache.build(data_file, ids, patch_shape=(8, 8, 8),
                                  margin_lo=lo, margin_hi=hi, dtype=dtype)

    kw = dict(batch_size=3, patch_shape=(8, 8, 8), patch_overlap=0,
              patch_start_offset=(4, 4, 4), shuffle_index_list=True,
              skip_blank=True, seed=11)
    host = data_generator(data_file, ids, n_labels=1, **kw)
    idx = index_batch_generator(data_file, ids, row_of, **kw)

    step_h = make_train_step(model, config)
    step_c = make_cached_train_step(model, config, cache.margin_lo)
    rng = jax.random.PRNGKey(5)
    for _ in range(3):
        rng, k = jax.random.split(rng)
        x, y = next(host)
        x, y, n_valid = pad_batch(x, y, 3)
        if compute_dtype == "bfloat16":
            x = x.astype(ml_dtypes.bfloat16)  # loop.py::_compress parity
        y = y.astype(np.uint8)
        state_h, mh = step_h(state_h, jnp.asarray(x), jnp.asarray(y), k,
                             n_valid)
        rows, corners, n_valid_c = next(idx)
        assert n_valid_c == n_valid
        state_c, mc = step_c(state_c, cache.data_stack, cache.truth_stack,
                             jnp.asarray(rows), jnp.asarray(corners), k,
                             n_valid_c)
        assert float(mh["loss"]) == float(mc["loss"])
    for lh, lc in zip(jax.tree_util.tree_leaves(state_h.params),
                      jax.tree_util.tree_leaves(state_c.params)):
        np.testing.assert_array_equal(np.asarray(lh), np.asarray(lc))

    # eval step parity too
    ev_h = make_eval_step(model, config)
    ev_c = make_cached_eval_step(model, config, cache.margin_lo)
    x, y = next(host)
    x, y, n_valid = pad_batch(x, y, 3)
    rows, corners, n_valid_c = next(idx)
    mh = ev_h(state_h, jnp.asarray(x), jnp.asarray(y), n_valid)
    mc = ev_c(state_c, cache.data_stack, cache.truth_stack,
              jnp.asarray(rows), jnp.asarray(corners), n_valid_c)
    assert float(mh["loss"]) == pytest.approx(float(mc["loss"]), rel=1e-6)


# ---------------------------------------------------------------------------
# The auto decision + end-to-end loop
# ---------------------------------------------------------------------------

def _cfg(data_file, tmp_path, **kw):
    base = dict(model_name="unet", depth=2, n_base_filters=2,
                image_shape=(16, 16, 16), patch_shape=(8, 8, 8),
                batch_size=3, validation_batch_size=3, n_epochs=1,
                compute_dtype="float32",
                training_patch_start_offset=(4, 4, 4),
                validation_patch_overlap=2,
                training_file=str(tmp_path / "t.pkl"),
                validation_file=str(tmp_path / "v.pkl"),
                model_file=str(tmp_path / "model.ckpt"),
                training_log=str(tmp_path / "training.log"))
    base.update(kw)
    return Config(**base)


def test_maybe_build_gating(data_file, tmp_path, monkeypatch):
    config = _cfg(data_file, tmp_path)
    get_validation_split(data_file, config.training_file,
                         config.validation_file, overwrite=True, seed=0)
    # off knob
    config.device_case_cache = "off"
    assert maybe_build_device_cache(data_file, config) is None
    # spatial/hybrid mesh -> host staging (DP meshes DO use the cache)
    config.device_case_cache = "auto"
    from fetal_mri_segmentation_tpu.parallel import make_hybrid_mesh
    mesh = make_hybrid_mesh(2, 4)
    assert maybe_build_device_cache(data_file, config, mesh=mesh) is None
    # budget exceeded in auto -> None
    import fetal_mri_segmentation_tpu.pipeline.device_cache as dc_mod
    monkeypatch.setattr(dc_mod, "AUTO_BUDGET_BYTES", 10)
    assert maybe_build_device_cache(data_file, config) is None
    monkeypatch.undo()
    # normal auto -> builds
    out = maybe_build_device_cache(data_file, config, verbose=True)
    assert out is not None
    cache, tg, vg = out
    assert estimate_cache_bytes(data_file, 5, cache.margin_lo,
                                (0, 0, 0), 4) > 0
    rows, corners, n_valid = next(tg)
    assert rows.shape == (3,) and corners.shape == (3, 3)


def test_train_model_with_device_cache(data_file, tmp_path):
    """End-to-end epoch through training/loop.py with the cached pipeline
    equals the host-pipeline epoch exactly (same seed, same final params)."""
    from fetal_mri_segmentation_tpu.models import build_model
    from fetal_mri_segmentation_tpu.pipeline import (
        get_training_and_validation_generators)
    from fetal_mri_segmentation_tpu.training import (create_train_state,
                                                     train_model)

    results = {}
    for mode in ("host", "cache"):
        sub = tmp_path / mode
        sub.mkdir()
        config = _cfg(data_file, sub, n_epochs=2)
        tg, n_t, vg, n_v = get_training_and_validation_generators(
            data_file, batch_size=config.batch_size, n_labels=1,
            training_keys_file=config.training_file,
            validation_keys_file=config.validation_file,
            data_split=0.8, overwrite=True,
            patch_shape=config.patch_shape,
            validation_batch_size=config.validation_batch_size,
            validation_patch_overlap=config.validation_patch_overlap,
            training_patch_start_offset=config.training_patch_start_offset,
            skip_blank=True, seed=3)
        model = build_model(config)
        state = create_train_state(model, config, jax.random.PRNGKey(0))
        device_cache = None
        if mode == "cache":
            device_cache, tg, vg = maybe_build_device_cache(
                data_file, config, seed=3)
        state = train_model(model, state, config, tg, vg, n_t, n_v,
                            seed=3, device_cache=device_cache, verbose=False)
        results[mode] = jax.tree_util.tree_leaves(state.params)
        assert (sub / "training.log").exists()
    for lh, lc in zip(results["host"], results["cache"]):
        np.testing.assert_array_equal(np.asarray(lh), np.asarray(lc))


def test_cached_step_multiclass_parity(tmp_path):
    """n_labels=3 with explicit non-contiguous labels: the on-device one-hot
    must match the host get_multi_class_labels path through a full step."""
    from fetal_mri_segmentation_tpu.models import build_model
    from fetal_mri_segmentation_tpu.training import create_train_state
    from fetal_mri_segmentation_tpu.training.train_step import (
        make_train_step, pad_batch)

    class _Root:
        pass

    class _File:
        root = _Root()

    rng = np.random.default_rng(8)
    f = _File()
    f.root.data = rng.normal(size=(3, 1, 16, 16, 16)).astype(np.float32)
    f.root.truth = rng.choice([0, 2, 5, 7], size=(3, 1, 16, 16, 16),
                              p=[0.7, 0.1, 0.1, 0.1]).astype(np.uint8)

    config = Config(model_name="unet", depth=2, n_base_filters=2,
                    image_shape=(16, 16, 16), patch_shape=(8, 8, 8),
                    batch_size=3, compute_dtype="float32",
                    n_labels=3, labels=(2, 5, 7), activation_name="softmax",
                    training_patch_start_offset=(4, 4, 4),
                    include_label_wise_dice_coefficients=True,
                    augment=True, flip=True, permute=True, contrast=0.1)
    model = build_model(config)
    state_h = create_train_state(model, config, jax.random.PRNGKey(0))
    state_c = create_train_state(model, config, jax.random.PRNGKey(0))

    ids = [0, 1, 2]
    row_of = {i: r for r, i in enumerate(ids)}
    lo, hi = plan_margins((16, 16, 16), (8, 8, 8), 0, (4, 4, 4))
    cache = DeviceCaseCache.build(f, ids, patch_shape=(8, 8, 8),
                                  margin_lo=lo, margin_hi=hi,
                                  dtype=jnp.float32)
    kw = dict(batch_size=3, patch_shape=(8, 8, 8), patch_overlap=0,
              patch_start_offset=(4, 4, 4), shuffle_index_list=True,
              skip_blank=True, seed=2)
    host = data_generator(f, ids, n_labels=3, labels=(2, 5, 7), **kw)
    idx = index_batch_generator(f, ids, row_of, **kw)

    step_h = make_train_step(model, config)
    step_c = make_cached_train_step(model, config, cache.margin_lo)
    rng_j = jax.random.PRNGKey(5)
    for _ in range(2):
        rng_j, k = jax.random.split(rng_j)
        x, y = next(host)
        x, y, n_valid = pad_batch(x, y, 3)
        state_h, mh = step_h(state_h, jnp.asarray(x), jnp.asarray(y), k,
                             n_valid)
        rows, corners, n_valid_c = next(idx)
        assert n_valid_c == n_valid
        state_c, mc = step_c(state_c, cache.data_stack, cache.truth_stack,
                             jnp.asarray(rows), jnp.asarray(corners), k,
                             n_valid_c)
        assert float(mh["loss"]) == float(mc["loss"])
        for key in mh:
            assert float(mh[key]) == pytest.approx(float(mc[key]), rel=1e-6)
    for lh, lc in zip(jax.tree_util.tree_leaves(state_h.params),
                      jax.tree_util.tree_leaves(state_c.params)):
        np.testing.assert_array_equal(np.asarray(lh), np.asarray(lc))


def test_cached_dp_step_equals_host_dp_step(data_file):
    """8-shard CPU mesh: the cached DP step (replicated stacks, sharded
    index arrays) must match the host DP step bitwise — incl. a padded
    partial batch and BatchNorm's sync-BN statistics."""
    import ml_dtypes

    from fetal_mri_segmentation_tpu.models import build_model
    from fetal_mri_segmentation_tpu.parallel import make_mesh
    from fetal_mri_segmentation_tpu.parallel.data_parallel import (
        make_dp_eval_step, make_dp_train_step, replicate_state, shard_batch)
    from fetal_mri_segmentation_tpu.pipeline.device_cache import (
        make_cached_dp_eval_step, make_cached_dp_train_step)
    from fetal_mri_segmentation_tpu.training import create_train_state
    from fetal_mri_segmentation_tpu.training.train_step import pad_batch

    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = make_mesh(8)
    config = Config(model_name="unet", depth=2, n_base_filters=2,
                    image_shape=(16, 16, 16), patch_shape=(8, 8, 8),
                    batch_size=8, compute_dtype="bfloat16",
                    batch_normalization=True,
                    training_patch_start_offset=(4, 4, 4),
                    augment=True, flip=True, permute=True, contrast=0.1)
    model = build_model(config)
    state_h = replicate_state(mesh, create_train_state(
        model, config, jax.random.PRNGKey(0)))
    state_c = replicate_state(mesh, create_train_state(
        model, config, jax.random.PRNGKey(0)))

    ids = [0, 1, 2, 3]
    row_of = {i: r for r, i in enumerate(ids)}
    lo, hi = plan_margins((16, 16, 16), (8, 8, 8), 0, (4, 4, 4))
    cache = DeviceCaseCache.build(data_file, ids, patch_shape=(8, 8, 8),
                                  margin_lo=lo, margin_hi=hi,
                                  dtype=jnp.bfloat16)
    repl = NamedSharding(mesh, P())
    ds = jax.device_put(cache.data_stack, repl)
    ts = jax.device_put(cache.truth_stack, repl)

    kw = dict(batch_size=8, patch_shape=(8, 8, 8), patch_overlap=0,
              patch_start_offset=(4, 4, 4), shuffle_index_list=True,
              skip_blank=True, seed=13)
    host = data_generator(data_file, ids, n_labels=1, **kw)
    idx = index_batch_generator(data_file, ids, row_of, **kw)

    step_h = make_dp_train_step(model, config, mesh)
    step_c = make_cached_dp_train_step(model, config, mesh, cache.margin_lo)
    rng = jax.random.PRNGKey(5)
    for _ in range(4):
        rng, k = jax.random.split(rng)
        x, y = next(host)
        x, y, n_valid = pad_batch(x, y, 8)
        x = x.astype(ml_dtypes.bfloat16)
        y = y.astype(np.uint8)
        xs, ys = shard_batch(mesh, jnp.asarray(x), jnp.asarray(y))
        state_h, mh = step_h(state_h, xs, ys, k, n_valid)
        rows, corners, n_valid_c = next(idx)
        assert n_valid_c == n_valid
        rs, cs = shard_batch(mesh, jnp.asarray(rows), jnp.asarray(corners))
        state_c, mc = step_c(state_c, ds, ts, rs, cs, k, n_valid_c)
        assert float(mh["loss"]) == float(mc["loss"])

    # hand-crafted PARTIAL batch (n_valid=5 of 8): exercises the zero-pad
    # parity — host pads x/y with zeros, the cached step must zero the
    # repeated-index padding slots before BN sees them
    pairs = [(0, (-2, 0, 3)), (1, (4, 4, 4)), (2, (0, 0, 0)),
             (3, (5, -1, 2)), (0, (8, 8, 8))]
    xs_np, ys_np = [], []
    for case, corner in pairs:
        d = np.asarray(data_file.root.data[case], np.float32)
        t = np.asarray(data_file.root.truth[case], np.float32)
        xs_np.append(get_patch_from_3d_data(d, (8, 8, 8), np.array(corner)))
        ys_np.append(get_patch_from_3d_data(t, (8, 8, 8), np.array(corner)))
    x, y = convert_data(xs_np, ys_np, n_labels=1)
    x, y, n_valid = pad_batch(x, y, 8)
    rng, k = jax.random.split(rng)
    xs, ys = shard_batch(mesh, jnp.asarray(x.astype(ml_dtypes.bfloat16)),
                         jnp.asarray(y.astype(np.uint8)))
    state_h, mh = step_h(state_h, xs, ys, k, n_valid)
    rows = np.asarray([row_of[c] for c, _ in pairs]
                      + [row_of[pairs[0][0]]] * 3, np.int32)
    corners = np.asarray([c for _, c in pairs]
                         + [pairs[0][1]] * 3, np.int32)
    rs, cs = shard_batch(mesh, jnp.asarray(rows), jnp.asarray(corners))
    state_c, mc = step_c(state_c, ds, ts, rs, cs, k, n_valid)
    assert float(mh["loss"]) == float(mc["loss"])
    for lh, lc in zip(jax.tree_util.tree_leaves(state_h.params)
                      + jax.tree_util.tree_leaves(state_h.batch_stats),
                      jax.tree_util.tree_leaves(state_c.params)
                      + jax.tree_util.tree_leaves(state_c.batch_stats)):
        np.testing.assert_array_equal(np.asarray(lh), np.asarray(lc))

    ev_h = make_dp_eval_step(model, config, mesh)
    ev_c = make_cached_dp_eval_step(model, config, mesh, cache.margin_lo)
    x, y = next(host)
    x, y, n_valid = pad_batch(x, y, 8)
    rows, corners, n_valid_c = next(idx)
    xs, ys = shard_batch(mesh, jnp.asarray(x.astype(ml_dtypes.bfloat16)),
                         jnp.asarray(y.astype(np.uint8)))
    rs, cs = shard_batch(mesh, jnp.asarray(rows), jnp.asarray(corners))
    mh = ev_h(state_h, xs, ys, n_valid)
    mc = ev_c(state_c, ds, ts, rs, cs, n_valid_c)
    assert float(mh["loss"]) == pytest.approx(float(mc["loss"]), rel=1e-6)


def test_train_model_dp_with_device_cache(data_file, tmp_path):
    """Loop-level DP: train_model on the 8-device mesh with the cached
    pipeline equals the host-pipeline DP run exactly."""
    from fetal_mri_segmentation_tpu.models import build_model
    from fetal_mri_segmentation_tpu.parallel import make_mesh
    from fetal_mri_segmentation_tpu.pipeline import (
        get_training_and_validation_generators)
    from fetal_mri_segmentation_tpu.training import (create_train_state,
                                                     train_model)

    mesh = make_mesh(8)
    results = {}
    for mode in ("host", "cache"):
        sub = tmp_path / mode
        sub.mkdir()
        config = _cfg(data_file, sub, batch_size=8, validation_batch_size=8)
        tg, n_t, vg, n_v = get_training_and_validation_generators(
            data_file, batch_size=config.batch_size, n_labels=1,
            training_keys_file=config.training_file,
            validation_keys_file=config.validation_file,
            data_split=0.8, overwrite=True,
            patch_shape=config.patch_shape,
            validation_batch_size=config.validation_batch_size,
            validation_patch_overlap=config.validation_patch_overlap,
            training_patch_start_offset=config.training_patch_start_offset,
            skip_blank=True, seed=3)
        model = build_model(config)
        state = create_train_state(model, config, jax.random.PRNGKey(0))
        device_cache = None
        if mode == "cache":
            device_cache, tg, vg = maybe_build_device_cache(
                data_file, config, mesh=mesh, seed=3)
            assert device_cache is not None
        state = train_model(model, state, config, tg, vg, n_t, n_v,
                            mesh=mesh, seed=3, device_cache=device_cache,
                            verbose=False)
        results[mode] = jax.tree_util.tree_leaves(state.params)
    for lh, lc in zip(results["host"], results["cache"]):
        np.testing.assert_array_equal(np.asarray(lh), np.asarray(lc))


def test_knob_validation_and_skip_reasons(data_file, tmp_path):
    # bad knob value rejected at config construction
    with pytest.raises(ValueError, match="device_case_cache"):
        _cfg(data_file, tmp_path, device_case_cache="On")
    # missing split pickles: auto -> None, on -> clear error
    config = _cfg(data_file, tmp_path)
    assert not os.path.exists(config.training_file)
    assert maybe_build_device_cache(data_file, config) is None
    config.device_case_cache = "on"
    with pytest.raises(ValueError, match="split pickles"):
        maybe_build_device_cache(data_file, config)
    # upload/build failure in auto mode falls back instead of crashing
    config = _cfg(data_file, tmp_path)
    get_validation_split(data_file, config.training_file,
                         config.validation_file, overwrite=True, seed=0)
    import fetal_mri_segmentation_tpu.pipeline.device_cache as dc_mod

    class _Boom(dc_mod.DeviceCaseCache):
        @classmethod
        def build(cls, *a, **kw):
            raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")

    orig = dc_mod.DeviceCaseCache
    dc_mod.DeviceCaseCache = _Boom
    try:
        assert maybe_build_device_cache(data_file, config) is None
        config.device_case_cache = "on"
        with pytest.raises(ValueError, match="RESOURCE_EXHAUSTED"):
            maybe_build_device_cache(data_file, config)
    finally:
        dc_mod.DeviceCaseCache = orig


def test_spatial_mesh_with_cache_raises(data_file, tmp_path):
    from fetal_mri_segmentation_tpu.models import build_model
    from fetal_mri_segmentation_tpu.parallel import make_hybrid_mesh
    from fetal_mri_segmentation_tpu.training import (create_train_state,
                                                     train_model)

    config = _cfg(data_file, tmp_path)
    get_validation_split(data_file, config.training_file,
                         config.validation_file, overwrite=True, seed=0)
    cache_tuple = maybe_build_device_cache(data_file, config, seed=0)
    assert cache_tuple is not None
    cache, tg, vg = cache_tuple
    model = build_model(config)
    state = create_train_state(model, config, jax.random.PRNGKey(0))
    mesh = make_hybrid_mesh(2, 4)
    with pytest.raises(ValueError, match="spatial"):
        train_model(model, state, config, tg, vg, 1, 1, mesh=mesh,
                    device_cache=cache, verbose=False)


def test_dp_build_replicates_without_extra_copy(data_file, tmp_path):
    """DP meshes build the stacks straight into the replicated sharding —
    no second full copy parked on device 0."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fetal_mri_segmentation_tpu.parallel import make_mesh

    config = _cfg(data_file, tmp_path, batch_size=8, validation_batch_size=8)
    get_validation_split(data_file, config.training_file,
                         config.validation_file, overwrite=True, seed=0)
    mesh = make_mesh(8)
    cache, tg, vg = maybe_build_device_cache(data_file, config, mesh=mesh,
                                             seed=0)
    assert cache.data_stack.sharding == NamedSharding(mesh, P())
    assert cache.truth_stack.sharding == NamedSharding(mesh, P())
    # shared truth lookup: generators reuse the build's host copies
    assert cache.host_truth is not None and len(cache.host_truth) == 5


def test_non_integral_truth_rejected():
    class _Root:
        pass

    class _File:
        root = _Root()

    f = _File()
    f.root.data = np.zeros((1, 1, 8, 8, 8), np.float32)
    f.root.truth = np.full((1, 1, 8, 8, 8), 0.5, np.float32)
    with pytest.raises(ValueError, match="integral"):
        DeviceCaseCache.build(f, [0], patch_shape=(4, 4, 4),
                              margin_lo=(2, 2, 2), margin_hi=(2, 2, 2))


def test_index_stream_skip_batches_lockstep(data_file):
    """The index generator's batch-level fast-forward must stay in
    lockstep with data_generator: at skip_batches=k both emit the
    sequences a fresh pair emits after k batches (data-order exact
    resume), including with skip_blank=True mid-epoch."""
    ids = [0, 1, 2, 3]
    row_of = {i: r for r, i in enumerate(ids)}
    cases = {i: (np.asarray(data_file.root.data[i], np.float32),
                 np.asarray(data_file.root.truth[i], np.float32))
             for i in ids}
    kw = dict(batch_size=3, patch_shape=(8, 8, 8), patch_overlap=0,
              patch_start_offset=(4, 4, 4), shuffle_index_list=True,
              skip_blank=True, seed=7)
    host = data_generator(data_file, ids, n_labels=1, skip_batches=13, **kw)
    idx = index_batch_generator(data_file, ids, row_of, skip_batches=13,
                                **kw)
    inv = {r: i for i, r in row_of.items()}
    for _ in range(6):
        xh, yh = next(host)
        rows, corners, n_valid = next(idx)
        assert n_valid == xh.shape[0]
        for b in range(n_valid):
            case = inv[int(rows[b])]
            x = get_patch_from_3d_data(cases[case][0], (8, 8, 8), corners[b])
            np.testing.assert_array_equal(xh[b], x)


def test_cached_resume_bitwise_identical(data_file, tmp_path):
    """Exact resume through the device-cache pipeline: interrupted at 1
    epoch and resumed to 3 (train.py wiring: peek_epoch -> epoch*steps
    skip_batches into maybe_build_device_cache), the metric log is
    bitwise identical to an uninterrupted cached 3-epoch run."""
    from fetal_mri_segmentation_tpu.models import build_model
    from fetal_mri_segmentation_tpu.pipeline import (
        get_training_and_validation_generators)
    from fetal_mri_segmentation_tpu.training import (CheckpointIO,
                                                     create_train_state,
                                                     train_model)

    def run(sub, n_epochs, resume=False):
        config = _cfg(data_file, sub, n_epochs=n_epochs, augment=True,
                      flip=True, contrast=0.1)
        start = (CheckpointIO(config.model_file).peek_epoch() or 0) \
            if resume else 0
        tg, n_t, vg, n_v = get_training_and_validation_generators(
            data_file, batch_size=config.batch_size, n_labels=1,
            training_keys_file=config.training_file,
            validation_keys_file=config.validation_file,
            data_split=0.8, overwrite=not resume,
            patch_shape=config.patch_shape,
            validation_batch_size=config.validation_batch_size,
            validation_patch_overlap=config.validation_patch_overlap,
            training_patch_start_offset=config.training_patch_start_offset,
            skip_blank=True, seed=3, start_epoch=start)
        model = build_model(config)
        state = create_train_state(model, config, jax.random.PRNGKey(0))
        device_cache, tg, vg = maybe_build_device_cache(
            data_file, config, seed=3,
            train_skip_batches=start * n_t, val_skip_batches=start * n_v)
        train_model(model, state, config, tg, vg, n_t, n_v, seed=3,
                    device_cache=device_cache, verbose=False)
        return config.training_log

    def metric_rows(path):
        out = {}
        with open(path) as f:
            hdr = f.readline().strip().split(",")
            cols = [hdr.index(c) for c in
                    ("epoch", "dice_coefficient", "val_dice_coefficient",
                     "loss", "val_loss", "lr")]
            for line in f:
                v = line.strip().split(",")
                out[v[cols[0]]] = [v[i] for i in cols[1:]]
        return out

    cont = tmp_path / "cont"
    cont.mkdir()
    log_c = run(cont, 3)
    res = tmp_path / "res"
    res.mkdir()
    run(res, 1)
    log_r = run(res, 3, resume=True)
    rows_c, rows_r = metric_rows(log_c), metric_rows(log_r)
    assert set(rows_c) == set(rows_r)
    for e in sorted(rows_c):
        assert rows_c[e] == rows_r[e], \
            f"epoch {e} diverged (cached resume): {rows_c[e]} != {rows_r[e]}"


def test_cache_on_with_whole_volume_config_raises(tmp_path):
    """device_case_cache='on' must raise for whole-volume configs
    (patch_shape=None) like every other ineligibility — not silently fall
    back to host staging."""
    import pytest

    from fetal_mri_segmentation_tpu.config import Config
    from fetal_mri_segmentation_tpu.pipeline.device_cache import (
        maybe_build_device_cache)

    cfg = Config(patch_shape=None, device_case_cache="on",
                 data_file=str(tmp_path / "none.h5"))
    with pytest.raises(ValueError, match="patch_shape"):
        maybe_build_device_cache(None, cfg)
    # 'auto' quietly keeps host staging for the same config
    cfg2 = Config(patch_shape=None, device_case_cache="auto",
                  data_file=str(tmp_path / "none.h5"))
    assert maybe_build_device_cache(None, cfg2) is None


# ---------------------------------------------------------------------------
# HBM budget + partial cache
# ---------------------------------------------------------------------------

def test_hbm_budget_bytes(monkeypatch):
    from fetal_mri_segmentation_tpu.pipeline.device_cache import (
        hbm_budget_bytes)

    class FakeDev:
        def memory_stats(self):
            return {"bytes_limit": 16 << 30, "bytes_in_use": 6 << 30}

    # default reserve: a quarter of the reported limit (16 GiB -> 4 GiB)
    assert hbm_budget_bytes(FakeDev()) == int(0.8 * (10 << 30)) - (4 << 30)
    # the step-working-set reserve is overridable (and patchable)
    assert hbm_budget_bytes(FakeDev(), reserve=0) == int(0.8 * (10 << 30))
    # a tiny device never goes negative
    assert hbm_budget_bytes(FakeDev(), reserve=100 << 30) == 0

    class NoStats:
        def memory_stats(self):
            return None

    assert hbm_budget_bytes(NoStats(), fallback=123) == 123
    # CPU backend reports None -> module fallback, patchable at call time
    import fetal_mri_segmentation_tpu.pipeline.device_cache as dc_mod
    monkeypatch.setattr(dc_mod, "AUTO_BUDGET_BYTES", 77)
    assert hbm_budget_bytes(NoStats()) == 77


def test_partial_cache_engages_and_covers_epoch(data_file, tmp_path):
    """Dataset ~1.5x over budget -> partial cache: majority of cases
    resident, uploaded patch slots cut by more than half, and the epoch's
    patch multiset identical to the full-cache (== host) pipeline's."""
    config = _cfg(data_file, tmp_path, skip_blank=False)
    get_validation_split(data_file, config.training_file,
                         config.validation_file, overwrite=True, seed=0,
                         data_split=0.8)
    # budget that fits ~2/3 of the 5 cases
    est = estimate_cache_bytes(
        data_file, 5, *plan_margins((16, 16, 16), (8, 8, 8), 2, (4, 4, 4)),
        dtype_bytes=4)
    out = maybe_build_device_cache(data_file, config,
                                   budget_bytes=int(est / 1.5), verbose=True)
    assert out is not None
    cache, tg, vg = out
    assert cache.partial
    n_res = len(cache.row_of)
    assert 2 <= n_res < 5
    assert cache.n_total_cases == 5

    # reference stream: the full-cache index generator (bitwise host parity
    # is already pinned for it) over the SAME training split + seed
    from fetal_mri_segmentation_tpu.utils.io_utils import pickle_load
    training_list = [int(i) for i in pickle_load(config.training_file)]
    full_row_of = {i: r for r, i in enumerate(sorted(training_list))}
    ref = index_batch_generator(
        data_file, training_list, full_row_of, batch_size=3,
        patch_shape=(8, 8, 8), patch_overlap=0,
        patch_start_offset=(4, 4, 4), skip_blank=False, seed=0)
    row_to_case = {r: c for c, r in full_row_of.items()}
    part_row_to_case = {r: c for c, r in cache.row_of.items()}

    # one epoch = ceil(n_patches / B) reference batches; count patches
    n_patches = 0
    ref_pairs = []
    while True:
        rows, corners, n_valid = next(ref)
        for rr, cc in zip(rows[:n_valid], corners[:n_valid]):
            ref_pairs.append((row_to_case[int(rr)], tuple(int(v) for v in cc)))
        n_patches += n_valid
        if n_valid < 3:  # trailing partial batch ends the epoch
            break

    got_pairs = []
    uploaded_slots = 0
    total = 0
    while total < n_patches:
        kind, a, b, n_valid = next(tg)
        total += n_valid
        if kind == "idx":
            for rr, cc in zip(a[:n_valid], b[:n_valid]):
                got_pairs.append((part_row_to_case[int(rr)],
                                  tuple(int(v) for v in cc)))
        else:
            uploaded_slots += n_valid
            assert a.shape[1:] == (1, 8, 8, 8)  # staged float32 patches
            assert b.shape[1:] == (1, 8, 8, 8)
            got_pairs.extend([(None, None)] * n_valid)
    assert total == n_patches
    # same multiset of resident patches as the reference epoch (the host
    # slots are opaque here; count them instead)
    ref_resident = sorted(p for p in ref_pairs if p[0] in cache.row_of)
    got_resident = sorted(p for p in got_pairs if p[0] is not None)
    assert got_resident == ref_resident
    # >50% upload reduction: non-resident share of the epoch
    assert uploaded_slots == n_patches - len(ref_resident)
    assert uploaded_slots < n_patches / 2, (uploaded_slots, n_patches)


def test_partial_cache_train_model_end_to_end(data_file, tmp_path):
    """train_model runs the tagged partial pipeline (both step kinds) and
    is deterministic across identical runs."""
    import shutil

    from fetal_mri_segmentation_tpu.models import build_model
    from fetal_mri_segmentation_tpu.pipeline.generator import (
        get_number_of_steps)
    from fetal_mri_segmentation_tpu.training import create_train_state
    from fetal_mri_segmentation_tpu.training.loop import train_model

    def run(tag):
        d = tmp_path / tag
        d.mkdir()
        config = _cfg(data_file, d, n_epochs=2, skip_blank=False,
                      training_file=str(d / "t.pkl"),
                      validation_file=str(d / "v.pkl"),
                      model_file=str(d / "model.ckpt"),
                      training_log=str(d / "training.log"))
        get_validation_split(data_file, config.training_file,
                             config.validation_file, overwrite=True, seed=0,
                             data_split=0.8)
        est = estimate_cache_bytes(
            data_file, 5,
            *plan_margins((16, 16, 16), (8, 8, 8), 2, (4, 4, 4)),
            dtype_bytes=4)
        out = maybe_build_device_cache(data_file, config,
                                       budget_bytes=int(est / 1.5))
        assert out is not None and out[0].partial
        cache, tg, vg = out
        model = build_model(config)
        state = create_train_state(model, config, jax.random.PRNGKey(0))
        # 4 cases x 8 patches / B=3 -> 11 steps; val 1 case x grid
        state = train_model(model, state, config, tg, vg, 11, 4,
                            seed=0, verbose=False, device_cache=cache)
        import csv
        with open(config.training_log) as f:
            rows = list(csv.DictReader(f))
        assert len(rows) == 2
        for r in rows:
            assert np.isfinite(float(r["loss"]))
            assert np.isfinite(float(r["val_loss"]))
        # the sidecar records PARTIAL + the resident set, so a resume can
        # reproduce the exact batch grouping (train.py pins the mode)
        from fetal_mri_segmentation_tpu.training.checkpoint import (
            CheckpointIO)
        order = CheckpointIO(config.model_file).peek_data_order()
        assert order == {"mode": "partial",
                         "resident": cache.resident_cases}
        return [r["loss"] for r in rows], state

    losses_a, state_a = run("a")
    losses_b, state_b = run("b")
    assert losses_a == losses_b  # deterministic given the seed
    for la, lb in zip(jax.tree_util.tree_leaves(state_a.params),
                      jax.tree_util.tree_leaves(state_b.params)):
        np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))


def test_partial_generator_skip_batches_resume(data_file, tmp_path):
    """skip_batches fast-forward: generator restarted with skip N yields
    exactly the stream an uninterrupted one yields after N batches."""
    config = _cfg(data_file, tmp_path, skip_blank=False)
    get_validation_split(data_file, config.training_file,
                         config.validation_file, overwrite=True, seed=0,
                         data_split=0.8)
    from fetal_mri_segmentation_tpu.pipeline.device_cache import (
        partial_index_batch_generator)
    from fetal_mri_segmentation_tpu.utils.io_utils import pickle_load
    training_list = [int(i) for i in pickle_load(config.training_file)]
    row_of = {training_list[0]: 0, training_list[1]: 1}  # 2 of 4 resident
    kw = dict(batch_size=3, patch_shape=(8, 8, 8), patch_overlap=0,
              patch_start_offset=(4, 4, 4), skip_blank=False, seed=3)
    a = partial_index_batch_generator(data_file, training_list, row_of, **kw)
    for _ in range(7):
        next(a)
    b = partial_index_batch_generator(data_file, training_list, row_of,
                                      skip_batches=7, **kw)
    for _ in range(6):
        ka, *va = next(a)
        kb, *vb = next(b)
        assert ka == kb
        for x, y in zip(va, vb):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_resume_data_order_pins_cache_mode(data_file, tmp_path):
    """A resume must reproduce the interrupted run's batch boundaries even
    when live free HBM would pick a different cache mode: lockstep
    recordings suppress partial (host staging shares host boundaries);
    partial recordings force the EXACT resident set or raise."""
    config = _cfg(data_file, tmp_path, skip_blank=False)
    get_validation_split(data_file, config.training_file,
                         config.validation_file, overwrite=True, seed=0,
                         data_split=0.8)
    est = estimate_cache_bytes(
        data_file, 5, *plan_margins((16, 16, 16), (8, 8, 8), 2, (4, 4, 4)),
        dtype_bytes=4)
    tight = int(est / 1.5)

    # interrupted run trained host-staged/full (lockstep); resumed box has
    # less free HBM -> partial would regroup -> host staging instead
    assert maybe_build_device_cache(
        data_file, config, budget_bytes=tight,
        resume_data_order={"mode": "lockstep"}) is None

    # interrupted run was PARTIAL; the resume must reproduce that resident
    # set even when the whole dataset now fits (full cache would regroup)
    first = maybe_build_device_cache(data_file, config, budget_bytes=tight)
    assert first is not None and first[0].partial
    resident = first[0].resident_cases
    out = maybe_build_device_cache(
        data_file, config, budget_bytes=int(est * 10),
        resume_data_order={"mode": "partial", "resident": resident})
    assert out is not None and out[0].partial
    assert out[0].resident_cases == sorted(resident)

    # irreproducible partial resumes fail LOUDLY, never silently regroup
    import pytest
    with pytest.raises(RuntimeError, match="exact-resume violation"):
        maybe_build_device_cache(
            data_file, config, budget_bytes=tight,
            resume_data_order={"mode": "partial", "resident": [999, 1000]})
    config.device_case_cache = "off"
    with pytest.raises(RuntimeError, match="exact-resume violation"):
        maybe_build_device_cache(
            data_file, config,
            resume_data_order={"mode": "partial", "resident": resident})
    config.device_case_cache = "on"
    with pytest.raises(RuntimeError, match="exact-resume violation"):
        maybe_build_device_cache(
            data_file, config,
            resume_data_order={"mode": "partial", "resident": resident})
    config.device_case_cache = "auto"

    # fresh runs / legacy sidecars (None) keep the free auto decision
    free = maybe_build_device_cache(data_file, config, budget_bytes=tight,
                                    resume_data_order=None)
    assert free is not None and free[0].partial


def test_partial_cache_resume_bitwise_identical(data_file, tmp_path):
    """End-to-end: an interrupted-at-2-epochs PARTIAL-cache run resumed to
    4 epochs logs bitwise-identical metrics to an uninterrupted 4-epoch
    run — wired exactly as train.py does it (peek_epoch + peek_data_order
    -> skip_batches + resume_data_order). The resume is offered a budget
    that would fit the FULL cache, so only the data-order pin keeps the
    partial grouping (and therefore the replayed batch sequence) intact."""
    from fetal_mri_segmentation_tpu.models import build_model
    from fetal_mri_segmentation_tpu.training import create_train_state
    from fetal_mri_segmentation_tpu.training.checkpoint import CheckpointIO
    from fetal_mri_segmentation_tpu.training.loop import train_model

    est = estimate_cache_bytes(
        data_file, 5, *plan_margins((16, 16, 16), (8, 8, 8), 2, (4, 4, 4)),
        dtype_bytes=4)
    tight = int(est / 1.5)

    def metric_rows(path):
        out = {}
        with open(path) as f:
            hdr = f.readline().strip().split(",")
            cols = [hdr.index(c) for c in
                    ("epoch", "dice_coefficient", "val_dice_coefficient",
                     "loss", "val_loss", "lr")]
            for line in f:
                v = line.strip().split(",")
                out[v[cols[0]]] = [v[i] for i in cols[1:]]
        return out

    def run(tag, n_epochs, budget, resume=False):
        d = tmp_path / tag
        d.mkdir(exist_ok=True)
        config = _cfg(data_file, d, n_epochs=n_epochs, skip_blank=False,
                      training_file=str(tmp_path / "t.pkl"),
                      validation_file=str(tmp_path / "v.pkl"),
                      model_file=str(d / "model.ckpt"),
                      training_log=str(d / "training.log"))
        get_validation_split(data_file, config.training_file,
                             config.validation_file, overwrite=False,
                             seed=0, data_split=0.8)
        start, order = 0, None
        if resume:
            io = CheckpointIO(config.model_file)
            # best-only checkpointing: the resume epoch is the last
            # IMPROVED epoch (reference ModelCheckpoint semantics), so the
            # replayed epochs re-log — metric_rows is last-row-wins
            start = io.peek_epoch() or 0
            assert start > 0
            order = io.peek_data_order() or {"mode": "lockstep"}
            assert order["mode"] == "partial"
        out = maybe_build_device_cache(
            data_file, config, budget_bytes=budget,
            train_skip_batches=start * 11, val_skip_batches=start * 4,
            resume_data_order=order)
        assert out is not None and out[0].partial
        cache, tg, vg = out
        model = build_model(config)
        state = create_train_state(model, config, jax.random.PRNGKey(0))
        train_model(model, state, config, tg, vg, 11, 4, seed=0,
                    verbose=False, device_cache=cache)
        return config

    cfg_c = run("uninterrupted", 4, tight)
    cfg_r = run("interrupted", 2, tight)
    cfg_r4 = run("interrupted", 4, int(est * 10), resume=True)
    assert cfg_r4.model_file == cfg_r.model_file
    cont, res = metric_rows(cfg_c.training_log), \
        metric_rows(cfg_r4.training_log)
    assert set(cont) == set(res)
    for e in sorted(cont):
        assert cont[e] == res[e], \
            f"epoch {e} diverged: {cont[e]} != {res[e]}"


def test_partial_generator_epoch_emission_count_matches_host(data_file,
                                                             tmp_path):
    """Per-epoch emission count must equal the host generator's
    ceil(kept/batch_size) — the loop consumes EXACTLY that many batches
    per epoch (train.py passes it as steps/epoch), so an extra trailing
    batch would drift trained-epoch boundaries by one batch per epoch.

    Constructed to hit the old bug: resident kept = 8 (one case, 2^3
    centered grid), non-resident kept = 16, batch_size = 5 -> remainders
    3 and 1 fit one batch. Independent flushes emit 6/epoch; the host
    emits ceil(24/5) = 5. The merged trailing flush restores 5.
    """
    from fetal_mri_segmentation_tpu.pipeline.device_cache import (
        partial_index_batch_generator)

    training_list = [0, 1, 2]
    row_of = {0: 0}  # one resident case -> 8 resident, 16 host patches
    gen = partial_index_batch_generator(
        data_file, training_list, row_of, batch_size=5,
        patch_shape=(8, 8, 8), patch_overlap=0, patch_start_offset=None,
        skip_blank=False, seed=11)
    per_epoch = 24 // 5 + 1  # == host get_number_of_steps(24, 5)
    for _ in range(3):  # three epochs: boundaries must not drift
        seen = 0
        kinds = []
        while seen < 24:
            kind, a, b, n_valid = next(gen)
            kinds.append((kind, n_valid))
            seen += n_valid
        assert seen == 24, kinds
        assert len(kinds) == per_epoch, kinds
        # the merged trailing batch carries both remainders as ONE host
        # batch (3 resident + 1 non-resident patches)
        assert kinds[-1] == ("host", 4), kinds


def test_partial_generator_resume_across_merged_flush(data_file):
    """skip_batches fast-forward must count the merged trailing flush as
    exactly one emission — a resume landing just past an epoch boundary
    replays the same merge decision and continues bitwise identically."""
    from fetal_mri_segmentation_tpu.pipeline.device_cache import (
        partial_index_batch_generator)

    kw = dict(batch_size=5, patch_shape=(8, 8, 8), patch_overlap=0,
              patch_start_offset=None, skip_blank=False, seed=11)
    # same arithmetic as the emission-count test: 5 emissions per epoch,
    # the 5th is the merged trailing host batch. Skip 6 = one full epoch
    # + one batch: the replay must cross the merge boundary correctly.
    a = partial_index_batch_generator(data_file, [0, 1, 2], {0: 0}, **kw)
    for _ in range(6):
        next(a)
    b = partial_index_batch_generator(data_file, [0, 1, 2], {0: 0},
                                      skip_batches=6, **kw)
    for _ in range(5):  # rest of epoch 2 incl. its merged flush
        ka, *va = next(a)
        kb, *vb = next(b)
        assert ka == kb
        for x, y in zip(va, vb):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
