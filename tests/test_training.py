"""Train step, checkpoint/resume, callbacks (SURVEY.md section 4/5)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fetal_mri_segmentation_tpu.config import Config
from fetal_mri_segmentation_tpu.models import build_model
from fetal_mri_segmentation_tpu.training import (
    CheckpointIO, create_train_state, load_old_model, make_eval_step,
    make_train_step)
from fetal_mri_segmentation_tpu.training.callbacks import (
    EarlyStopping, ReduceLROnPlateau, step_decay)
from fetal_mri_segmentation_tpu.training.train_step import pad_batch


def tiny_config(**kw):
    defaults = dict(model_name="unet", depth=2, n_base_filters=2,
                    patch_shape=(8, 8, 8), batch_size=2,
                    compute_dtype="float32", augment=True, flip=True,
                    permute=True, contrast=0.1, distort=None,
                    initial_learning_rate=1e-2)
    defaults.update(kw)
    return Config(**defaults)


def make_batch(cfg, b=2, seed=0):
    rng = np.random.default_rng(seed)
    shape = (b, 1) + cfg.patch_shape
    y = np.zeros(shape, np.float32)
    y[:, :, 2:6, 2:6, 2:6] = 1.0
    x = (y * 2 + rng.normal(0, 0.3, shape)).astype(np.float32)
    return jnp.asarray(x), jnp.asarray(y)


def test_overfit_one_patch_reaches_high_dice():
    """North-star config #1 smoke: loss (negative dice) -> below -0.9."""
    cfg = tiny_config(augment=False)
    model = build_model(cfg)
    state = create_train_state(model, cfg, jax.random.PRNGKey(0))
    step = make_train_step(model, cfg)
    x, y = make_batch(cfg)
    rng = jax.random.PRNGKey(1)
    loss = None
    for i in range(150):
        rng, k = jax.random.split(rng)
        state, metrics = step(state, x, y, k, None)
        loss = float(metrics["loss"])
    assert loss < -0.9, f"did not overfit: loss={loss}"


def test_train_step_with_augmentation_improves():
    cfg = tiny_config()
    model = build_model(cfg)
    state = create_train_state(model, cfg, jax.random.PRNGKey(0))
    step = make_train_step(model, cfg)
    x, y = make_batch(cfg)
    rng = jax.random.PRNGKey(2)
    first = None
    for i in range(60):
        rng, k = jax.random.split(rng)
        state, m = step(state, x, y, k, None)
        if first is None:
            first = float(m["loss"])
    assert float(m["loss"]) < first


def test_partial_batch_masking_exact():
    """Padded-batch loss must equal the ragged-batch loss exactly."""
    cfg = tiny_config(augment=False, batch_size=4)
    model = build_model(cfg)
    state = create_train_state(model, cfg, jax.random.PRNGKey(0))
    eval_step = make_eval_step(model, cfg)
    x3, y3 = make_batch(cfg, b=3)
    m_ragged = eval_step(state, x3, y3, None)
    xp, yp, n_valid = pad_batch(np.asarray(x3), np.asarray(y3), 4)
    assert n_valid == 3 and xp.shape[0] == 4
    m_padded = eval_step(state, jnp.asarray(xp), jnp.asarray(yp), n_valid)
    assert np.allclose(float(m_ragged["loss"]), float(m_padded["loss"]),
                       atol=1e-6)
    assert np.allclose(float(m_ragged["dice"]), float(m_padded["dice"]),
                       atol=1e-6)


def test_isensee_train_step_runs():
    cfg = tiny_config(model_name="isensee", depth=3, n_segmentation_levels=2,
                      dropout_rate=0.3)
    model = build_model(cfg)
    state = create_train_state(model, cfg, jax.random.PRNGKey(0))
    step = make_train_step(model, cfg)
    x, y = make_batch(cfg)
    state, m = step(state, x, y, jax.random.PRNGKey(3), None)
    assert np.isfinite(float(m["loss"]))


def test_batchnorm_stats_update():
    cfg = tiny_config(batch_normalization=True, augment=False)
    model = build_model(cfg)
    state = create_train_state(model, cfg, jax.random.PRNGKey(0))
    # materialize now: the train step donates its input state's buffers
    before = [np.asarray(l) for l in jax.tree_util.tree_leaves(state.batch_stats)]
    assert before  # BN present
    step = make_train_step(model, cfg)
    x, y = make_batch(cfg)
    state2, _ = step(state, x, y, jax.random.PRNGKey(0), None)
    after = jax.tree_util.tree_leaves(state2.batch_stats)
    assert any(not np.allclose(np.asarray(a), np.asarray(b))
               for a, b in zip(before, after))


def test_checkpoint_roundtrip_and_resume(tmp_path):
    cfg = tiny_config(model_file=str(tmp_path / "model.ckpt"), augment=False)
    model = build_model(cfg)
    state = create_train_state(model, cfg, jax.random.PRNGKey(0))
    step = make_train_step(model, cfg)
    x, y = make_batch(cfg)
    for i in range(3):
        state, _ = step(state, x, y, jax.random.PRNGKey(i), None)
    state = state.set_learning_rate(5e-3)

    io = CheckpointIO(cfg.model_file)
    io.save(state, epoch=7, best_val=-0.5)
    assert io.exists()

    restored, epoch, best = load_old_model(cfg.model_file, model, cfg)
    assert epoch == 7 and best == -0.5
    assert int(restored.step) == 3
    assert abs(restored.learning_rate - 5e-3) < 1e-9
    for a, b in zip(jax.tree_util.tree_leaves(state.params),
                    jax.tree_util.tree_leaves(restored.params)):
        assert np.allclose(np.asarray(a), np.asarray(b))
    # optimizer moments restored too (full resume)
    restored2, m2 = make_train_step(model, cfg)(restored, x, y,
                                                jax.random.PRNGKey(9), None)
    assert np.isfinite(float(m2["loss"]))


def test_step_decay_formula():
    # lr = init * drop^floor((1+epoch)/epochs_drop)
    assert step_decay(0, 1.0, 0.5, 10) == 1.0
    assert step_decay(9, 1.0, 0.5, 10) == 0.5
    assert step_decay(19, 1.0, 0.5, 10) == 0.25


def test_plateau_and_early_stopping():
    pl = ReduceLROnPlateau(1.0, factor=0.5, patience=2)
    assert pl.update(1.0) == 1.0     # improves (first)
    assert pl.update(1.1) == 1.0     # wait 1
    assert pl.update(1.2) == 0.5     # wait 2 -> drop
    es = EarlyStopping(patience=2)
    assert not es.update(1.0)
    assert not es.update(1.5)
    assert es.update(1.4)            # 2 epochs without improvement


def test_label_wise_metrics_in_train_step():
    """Reference: include_label_wise_dice_coefficients -> label_{i}_dice_coef
    metrics (unet.py::unet_model_3d metrics list)."""
    cfg = tiny_config(n_labels=2, labels=(1, 2),
                      include_label_wise_dice_coefficients=True,
                      activation_name="softmax", augment=False)
    model = build_model(cfg)
    state = create_train_state(model, cfg, jax.random.PRNGKey(0))
    step = make_train_step(model, cfg)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.random((2, 1, 8, 8, 8)), jnp.float32)
    y = np.zeros((2, 2, 8, 8, 8), np.float32)
    y[:, 0, :4] = 1.0
    y[:, 1, 4:] = 1.0
    _, m = step(state, x, jnp.asarray(y), jax.random.PRNGKey(1), None)
    assert "label_0_dice_coef" in m and "label_1_dice_coef" in m
    assert np.isfinite(float(m["label_0_dice_coef"]))


def test_remat_train_step_matches_plain():
    """config.remat trades FLOPs for memory without changing results."""
    base = tiny_config(augment=False)
    rcfg = tiny_config(augment=False, remat=True)
    model = build_model(base)
    x, y = make_batch(base)
    s1 = create_train_state(model, base, jax.random.PRNGKey(0))
    s2 = create_train_state(model, rcfg, jax.random.PRNGKey(0))
    n1, m1 = make_train_step(model, base)(s1, x, y, jax.random.PRNGKey(5), None)
    n2, m2 = make_train_step(model, rcfg)(s2, x, y, jax.random.PRNGKey(5), None)
    assert np.allclose(float(m1["loss"]), float(m2["loss"]), atol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(n1.params),
                    jax.tree_util.tree_leaves(n2.params)):
        assert np.allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_csv_logger_widens_header_on_resume(tmp_path):
    """A resumed run that logs NEW columns must widen the header (rewriting
    history with blanks) instead of silently dropping them; a run that drops
    columns keeps the header and leaves blanks."""
    import csv as _csv

    from fetal_mri_segmentation_tpu.training.callbacks import CSVLogger

    p = str(tmp_path / "training.log")
    CSVLogger(p).log(0, {"loss": 1.0})
    CSVLogger(p).log(1, {"loss": 0.5, "label_0_dice_coef": 0.9})  # resumed +col
    CSVLogger(p).log(2, {"loss": 0.4})                            # resumed -col
    with open(p) as f:
        rows = list(_csv.DictReader(f))
    assert rows[0]["label_0_dice_coef"] == ""
    assert rows[1]["label_0_dice_coef"] == "0.9"
    assert rows[2]["loss"] == "0.4" and rows[2]["label_0_dice_coef"] == ""
    assert [r["epoch"] for r in rows] == ["0", "1", "2"]


def test_restore_legacy_checkpoint_without_sched(tmp_path):
    """Checkpoints written before scheduler state was persisted (no 'sched'
    subtree) must still restore — with an empty sched dict (the loop then
    seeds schedulers from best_val as before)."""
    from fetal_mri_segmentation_tpu.training.checkpoint import (
        CheckpointIO, save_tree_npz)

    cfg = tiny_config(model_file=str(tmp_path / "legacy.ckpt"))
    model = build_model(cfg)
    state = create_train_state(model, cfg, jax.random.PRNGKey(0))
    # write the ROUND-2 payload layout directly (no "sched")
    payload = {
        "params": jax.device_get(state.params),
        "opt_state": jax.device_get(state.opt_state),
        "batch_stats": jax.device_get(state.batch_stats),
        "step": np.asarray(state.step),
        "epoch": np.asarray(7),
        "best_val": np.asarray(-0.5, np.float64),
    }
    os.makedirs(cfg.model_file)
    save_tree_npz(payload, os.path.join(cfg.model_file, "state.npz"))

    io = CheckpointIO(cfg.model_file)
    restored, epoch, best_val, sched = io.restore(state)
    assert epoch == 7 and best_val == -0.5 and sched == {}
    # and a NEW save/restore round-trips the scheduler state
    io.save(restored, epoch=8, best_val=-0.6,
            sched={"plateau_best": -0.55, "plateau_wait": 2,
                   "early_best": -0.6, "early_wait": 1})
    _, _, _, sched2 = io.restore(state)
    assert sched2 == {"plateau_best": -0.55, "plateau_wait": 2.0,
                      "early_best": -0.6, "early_wait": 1.0}


def test_train_state_is_a_registered_pytree():
    """TrainState flattens to its arrays (tx is static metadata) and
    rebuilds from them — what jit, donation and the checkpoint rely on."""
    cfg = tiny_config()
    state = create_train_state(build_model(cfg), cfg, jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten(state)
    assert all(isinstance(l, jax.Array) for l in leaves)
    rebuilt = jax.tree_util.tree_unflatten(treedef, leaves)
    assert rebuilt.tx is state.tx
    assert int(rebuilt.replace(step=state.step + 1).step) == 1


def test_checkpoint_roundtrip_exact_and_atomic(tmp_path):
    """Every leaf (params, Adam moments, lr, step) restores bit-exactly,
    and the write leaves no temporary file behind."""
    from fetal_mri_segmentation_tpu.training.state import (
        create_abstract_state)

    cfg = tiny_config(model_file=str(tmp_path / "m.ckpt"), augment=False)
    model = build_model(cfg)
    state = create_train_state(model, cfg, jax.random.PRNGKey(0))
    x, y = make_batch(cfg)
    state, _ = make_train_step(model, cfg)(state, x, y,
                                           jax.random.PRNGKey(1), None)
    io = CheckpointIO(cfg.model_file)
    io.save(state, epoch=3, best_val=-0.25)
    assert sorted(os.listdir(cfg.model_file)) == ["state.npz"]
    restored, epoch, best, _ = io.restore(create_abstract_state(model, cfg))
    assert (epoch, best) == (3, -0.25)
    for a, b in zip(jax.tree_util.tree_leaves(state),
                    jax.tree_util.tree_leaves(restored)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
