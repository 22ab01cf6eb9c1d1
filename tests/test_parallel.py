"""Data-parallel correctness on the virtual 8-device CPU mesh
(SURVEY.md section 4 multi-chip tests; BASELINE config #5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fetal_mri_segmentation_tpu.config import Config
from fetal_mri_segmentation_tpu.models import build_model
from fetal_mri_segmentation_tpu.parallel import (
    make_dp_eval_step, make_dp_train_step, make_mesh, replicate_state,
    shard_batch)
from fetal_mri_segmentation_tpu.training import (
    create_train_state, make_train_step)


def tiny_config(**kw):
    defaults = dict(model_name="unet", depth=2, n_base_filters=2,
                    patch_shape=(8, 8, 8), batch_size=8,
                    compute_dtype="float32", augment=False,
                    initial_learning_rate=1e-2)
    defaults.update(kw)
    return Config(**defaults)


def make_batch(b=8, seed=0):
    rng = np.random.default_rng(seed)
    shape = (b, 1, 8, 8, 8)
    y = np.zeros(shape, np.float32)
    y[:, :, 2:6, 2:6, 2:6] = 1.0
    x = (y * 2 + rng.normal(0, 0.3, shape)).astype(np.float32)
    return x, y


def test_eight_devices_available():
    assert jax.device_count() == 8  # conftest virtual CPU mesh


def test_dp_step_matches_single_device():
    """psum-grad equivalence: 8-shard DP step == single-device step on the
    same global batch (augment off).

    Uses plain SGD so the parameter delta is LINEAR in the gradient —
    comparing post-Adam params is ill-conditioned (first-step Adam is
    ~lr*sign(g); fp32 psum reduction-order noise flips signs of eps-grads).
    """
    import optax

    cfg = tiny_config()
    model = build_model(cfg)
    tx = optax.sgd(1.0)  # param delta == -grad exactly
    x, y = make_batch(8)
    rng = jax.random.PRNGKey(7)

    # single device
    state1 = create_train_state(model, cfg, jax.random.PRNGKey(0), tx=tx)
    step1 = make_train_step(model, cfg)
    new1, m1 = step1(state1, jnp.asarray(x), jnp.asarray(y), rng, 8)

    # 8-device DP
    mesh = make_mesh(8)
    state8 = create_train_state(model, cfg, jax.random.PRNGKey(0), tx=tx)
    state8 = replicate_state(mesh, state8)
    step8 = make_dp_train_step(model, cfg, mesh)
    xs, ys = shard_batch(mesh, x, y)
    new8, m8 = step8(state8, xs, ys, rng, jnp.asarray(8))

    assert np.allclose(float(m1["loss"]), float(m8["loss"]), atol=1e-6)
    assert np.allclose(float(m1["dice"]), float(m8["dice"]), atol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(new1.params),
                    jax.tree_util.tree_leaves(new8.params)):
        # grads equal up to fp32 psum reduction order
        assert np.allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_dp_partial_global_batch():
    """n_valid masking splits correctly across shards."""
    cfg = tiny_config()
    model = build_model(cfg)
    mesh = make_mesh(8)
    state = replicate_state(mesh, create_train_state(model, cfg,
                                                     jax.random.PRNGKey(0)))
    x, y = make_batch(8)
    # zero out the last 3 samples as padding
    x[5:] = 0
    y[5:] = 0
    step = make_dp_train_step(model, cfg, mesh)
    xs, ys = shard_batch(mesh, x, y)
    _, m = step(state, xs, ys, jax.random.PRNGKey(0), jnp.asarray(5))
    assert np.isfinite(float(m["loss"]))

    # equivalence vs single-device ragged batch
    step1 = make_train_step(model, cfg)
    s1 = create_train_state(model, cfg, jax.random.PRNGKey(0))
    _, m1 = step1(s1, jnp.asarray(x[:5]), jnp.asarray(y[:5]),
                  jax.random.PRNGKey(0), None)
    assert np.allclose(float(m1["loss"]), float(m["loss"]), atol=1e-5)


def test_dp_eval_step_runs():
    cfg = tiny_config()
    model = build_model(cfg)
    mesh = make_mesh(8)
    state = replicate_state(mesh, create_train_state(model, cfg,
                                                     jax.random.PRNGKey(0)))
    x, y = make_batch(8)
    es = make_dp_eval_step(model, cfg, mesh)
    m = es(state, *shard_batch(mesh, x, y), jnp.asarray(8))
    assert np.isfinite(float(m["loss"]))


def test_dp_augmented_shards_differ():
    """Per-shard RNG divergence: feed the SAME sample to every shard and
    assert the post-augment sub-batches differ pairwise — this fails if the
    `fold_in(axis_index)` in parallel/data_parallel.py::_shardwise is
    removed (all shards would then apply identical augmentation)."""
    cfg = tiny_config(augment=True, flip=True, permute=True, contrast=0.5)
    model = build_model(cfg)
    mesh = make_mesh(8)
    state = replicate_state(mesh, create_train_state(model, cfg,
                                                     jax.random.PRNGKey(0)))
    x1, y1 = make_batch(1)
    x = np.tile(x1, (8, 1, 1, 1, 1))  # identical sample on every shard
    y = np.tile(y1, (8, 1, 1, 1, 1))
    step = make_dp_train_step(model, cfg, mesh, debug_return_batch=True)
    new_state, m, (x_aug, y_aug) = step(state, *shard_batch(mesh, x, y),
                                        jax.random.PRNGKey(1), jnp.asarray(8))
    assert np.isfinite(float(m["loss"]))
    x_aug = np.asarray(x_aug)
    n_distinct = len({x_aug[i].tobytes() for i in range(8)})
    assert n_distinct >= 6, (
        f"only {n_distinct}/8 distinct augmented shards — per-shard RNG "
        f"fold_in is broken")


def test_dp_weighted_loss_matches_single_device():
    """Isensee/weighted-dice DP objective == single-device global objective."""
    import optax

    cfg = tiny_config(model_name="isensee", depth=2, n_segmentation_levels=1,
                      n_base_filters=2, dropout_rate=0.0)
    model = build_model(cfg)
    tx = optax.sgd(1.0)  # see test_dp_step_matches_single_device
    x, y = make_batch(8, seed=3)
    rng = jax.random.PRNGKey(11)

    s1 = create_train_state(model, cfg, jax.random.PRNGKey(0), tx=tx)
    new1, m1 = make_train_step(model, cfg)(s1, jnp.asarray(x), jnp.asarray(y),
                                           rng, 8)

    mesh = make_mesh(8)
    s8 = replicate_state(mesh, create_train_state(model, cfg,
                                                  jax.random.PRNGKey(0), tx=tx))
    step8 = make_dp_train_step(model, cfg, mesh)
    new8, m8 = step8(s8, *shard_batch(mesh, x, y), rng, jnp.asarray(8))

    assert np.allclose(float(m1["loss"]), float(m8["loss"]), atol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(new1.params),
                    jax.tree_util.tree_leaves(new8.params)):
        assert np.allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_sharded_predictor_matches_single_device():
    """Patch-grid-sharded inference == single-device scan (psum merge)."""
    from fetal_mri_segmentation_tpu.inference import SlidingWindowPredictor
    from fetal_mri_segmentation_tpu.parallel.distributed import (
        make_sharded_predictor)

    class IdentityModel:
        def apply(self, variables, x):
            return x

    cfg = tiny_config(patch_shape=(8, 8, 8))
    vol = np.random.default_rng(5).random((1, 20, 20, 20)).astype(np.float32)
    # overlap 4 -> tiled segment-sum path; overlap 5 -> gcd(3,8)=1 forces
    # the legacy scan_accumulate fallback — both must match single-device.
    for overlap in (4, 5):
        pred = SlidingWindowPredictor(IdentityModel(), cfg, (20, 20, 20),
                                      (8, 8, 8), overlap=overlap,
                                      patch_batch_size=2)
        assert pred.use_tiled == (overlap == 4)
        single = pred({}, vol)
        sharded = make_sharded_predictor(pred, make_mesh(8))({}, vol)
        assert np.allclose(single, sharded, atol=1e-5)


def test_dp_with_batchnorm_stats():
    """BatchNorm under DP: per-shard stats are pmean'd into replicated stats."""
    cfg = tiny_config(batch_normalization=True)
    model = build_model(cfg)
    mesh = make_mesh(8)
    state = replicate_state(mesh, create_train_state(model, cfg,
                                                     jax.random.PRNGKey(0)))
    before = [np.asarray(l) for l in jax.tree_util.tree_leaves(state.batch_stats)]
    assert before
    x, y = make_batch(8)
    step = make_dp_train_step(model, cfg, mesh)
    new_state, m = step(state, *shard_batch(mesh, x, y),
                        jax.random.PRNGKey(0), jnp.asarray(8))
    assert np.isfinite(float(m["loss"]))
    after = jax.tree_util.tree_leaves(new_state.batch_stats)
    assert any(not np.allclose(np.asarray(a), b)
               for a, b in zip(after, before))


def test_dp_batchnorm_matches_single_device():
    """Sync-BN equivalence: with bn_axis_name the DP step computes
    GLOBAL-batch moments, so params AND batch_stats after one step match the
    single-device step on the same global batch (shard means differ, so this
    fails with naive per-shard BN statistics)."""
    import optax

    cfg = tiny_config(batch_normalization=True)
    model = build_model(cfg)
    tx = optax.sgd(1.0)
    x, y = make_batch(8, seed=9)
    x += np.arange(8, dtype=np.float32).reshape(8, 1, 1, 1, 1)  # shard means differ
    rng = jax.random.PRNGKey(3)

    s1 = create_train_state(model, cfg, jax.random.PRNGKey(0), tx=tx)
    new1, m1 = make_train_step(model, cfg)(s1, jnp.asarray(x), jnp.asarray(y),
                                           rng, 8)

    mesh = make_mesh(8)
    s8 = replicate_state(mesh, create_train_state(model, cfg,
                                                  jax.random.PRNGKey(0), tx=tx))
    step8 = make_dp_train_step(model, cfg, mesh)
    new8, m8 = step8(s8, *shard_batch(mesh, x, y), rng, jnp.asarray(8))

    assert np.allclose(float(m1["loss"]), float(m8["loss"]), atol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(new1.batch_stats),
                    jax.tree_util.tree_leaves(new8.batch_stats)):
        assert np.allclose(np.asarray(a), np.asarray(b), atol=1e-5), \
            float(np.abs(np.asarray(a) - np.asarray(b)).max())
    for a, b in zip(jax.tree_util.tree_leaves(new1.params),
                    jax.tree_util.tree_leaves(new8.params)):
        assert np.allclose(np.asarray(a), np.asarray(b), atol=1e-4)


def test_initialize_distributed_two_process_smoke():
    """parallel/distributed.py::initialize_distributed across two REAL
    processes (CPU backend): both must see process_count==2 and the union of
    devices (the multi-host entry SURVEY section 5.8 requires)."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    script = (
        "import sys, jax\n"
        "from fetal_mri_segmentation_tpu.parallel.distributed import "
        "initialize_distributed\n"
        "initialize_distributed('127.0.0.1:%d', 2, int(sys.argv[1]))\n"
        "assert jax.process_count() == 2, jax.process_count()\n"
        "assert jax.device_count() == 2 * jax.local_device_count()\n"
        "print('proc', sys.argv[1], 'ok')\n" % port)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="")
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(__file__))
                         + ":" + env.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", script, str(i)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = [p.communicate(timeout=180)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        assert "ok" in out


def test_run_validation_cases_sharded_matches_single(tmp_path):
    """predict over a mesh writes the same prediction.nii.gz as one device."""
    from fetal_mri_segmentation_tpu.data import (open_data_file,
                                                 write_data_to_file)
    from fetal_mri_segmentation_tpu.inference import run_validation_cases
    from fetal_mri_segmentation_tpu.utils.io_utils import pickle_dump
    from fetal_mri_segmentation_tpu.utils.nifti import load_nifti
    from tests.synthetic import write_synthetic_dataset

    files = write_synthetic_dataset(str(tmp_path / "nii"), n_cases=2,
                                    shape=(20, 20, 20))
    h5p = str(tmp_path / "d.h5")
    write_data_to_file(files, h5p, image_shape=(16, 16, 16),
                       normalize="per_volume", crop=False)
    keys = str(tmp_path / "v.pkl")
    pickle_dump([0, 1], keys)

    cfg = tiny_config(patch_shape=(8, 8, 8), image_shape=(16, 16, 16))
    model = build_model(cfg)
    variables = {"params": create_train_state(
        model, cfg, jax.random.PRNGKey(0)).params}

    with open_data_file(h5p) as f:
        run_validation_cases(keys, model, variables, f, cfg,
                             output_dir=str(tmp_path / "p1"), overlap=2,
                             patch_batch_size=2)
        run_validation_cases(keys, model, variables, f, cfg,
                             output_dir=str(tmp_path / "p8"), overlap=2,
                             patch_batch_size=2, mesh=make_mesh(8))
    for case in ("validation_case_0", "validation_case_1"):
        a = load_nifti(str(tmp_path / "p1" / case / "prediction.nii.gz")).get_fdata()
        b = load_nifti(str(tmp_path / "p8" / case / "prediction.nii.gz")).get_fdata()
        assert np.mean(a == b) > 0.999  # identical up to fp reduction ties


def test_indivisible_batch_clear_error():
    mesh = make_mesh(8)
    x = np.zeros((6, 1, 4, 4, 4), np.float32)
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(mesh, x)


def test_make_mesh_rejects_overask():
    """Asking for more devices than exist must error, not silently run on
    fewer (predict.py --num-devices 8 on a 1-chip host used to degrade to
    single-device with no warning)."""
    with pytest.raises(ValueError, match="requested 9 devices"):
        make_mesh(9)
