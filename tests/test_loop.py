"""End-to-end epoch-loop integration test on synthetic data
(SURVEY.md section 4 integration row): train -> log -> checkpoint -> resume."""

import os

import jax
import numpy as np
import pytest

from fetal_mri_segmentation_tpu.config import Config
from fetal_mri_segmentation_tpu.data import open_data_file, write_data_to_file
from fetal_mri_segmentation_tpu.models import build_model
from fetal_mri_segmentation_tpu.pipeline import (
    get_training_and_validation_generators)
from fetal_mri_segmentation_tpu.training import (
    CheckpointIO, create_train_state, train_model)
from tests.synthetic import write_synthetic_dataset


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("loop")
    files = write_synthetic_dataset(str(d / "nii"), n_cases=4,
                                    shape=(20, 20, 20))
    write_data_to_file(files, str(d / "data.h5"), image_shape=(16, 16, 16),
                       normalize="per_volume", crop=False)
    return d


def make_cfg(d, **kw):
    defaults = dict(
        image_shape=(16, 16, 16), patch_shape=(8, 8, 8), depth=2,
        n_base_filters=2, batch_size=4, validation_batch_size=4, n_epochs=2,
        compute_dtype="float32", augment=True, flip=True, permute=True,
        contrast=0.1, initial_learning_rate=1e-2, early_stop=50,
        data_file=str(d / "data.h5"), model_file=str(d / "model.ckpt"),
        training_file=str(d / "t.pkl"), validation_file=str(d / "v.pkl"),
        training_log=str(d / "training.log"))
    defaults.update(kw)
    return Config(**defaults)


def test_train_model_end_to_end_and_resume(workdir):
    d = workdir
    cfg = make_cfg(d)
    model = build_model(cfg)
    data_file = open_data_file(cfg.data_file)
    try:
        tg, n_t, vg, n_v = get_training_and_validation_generators(
            data_file, batch_size=cfg.batch_size, n_labels=1,
            training_keys_file=cfg.training_file,
            validation_keys_file=cfg.validation_file,
            data_split=0.75, overwrite=True, patch_shape=cfg.patch_shape,
            validation_batch_size=cfg.validation_batch_size,
            training_patch_start_offset=(2, 2, 2), skip_blank=True, seed=0)

        state = create_train_state(model, cfg, jax.random.PRNGKey(0))
        state = train_model(model, state, cfg, tg, vg, n_t, n_v,
                            verbose=False)

        # CSV log written with the expected columns
        assert os.path.exists(cfg.training_log)
        header = open(cfg.training_log).readline().strip().split(",")
        for col in ("epoch", "loss", "val_loss", "dice_coefficient",
                    "val_dice_coefficient", "lr", "patches_per_sec"):
            assert col in header
        n_rows = sum(1 for _ in open(cfg.training_log)) - 1
        assert n_rows == 2

        # best checkpoint saved
        assert CheckpointIO(cfg.model_file).exists()

        # resume: runs epochs 2.. from the checkpoint without error
        cfg2 = make_cfg(d, n_epochs=3)
        state2 = create_train_state(model, cfg2, jax.random.PRNGKey(0))
        state2 = train_model(model, state2, cfg2, tg, vg, n_t, n_v,
                             verbose=False)
        assert int(state2.step) > 0
    finally:
        data_file.close()


def test_train_model_multi_device_mesh(workdir):
    """Same loop through the DP path on the virtual 8-device mesh."""
    from fetal_mri_segmentation_tpu.parallel import make_mesh

    d = workdir
    cfg = make_cfg(d, model_file=str(d / "model_dp.ckpt"),
                   training_log=str(d / "training_dp.log"),
                   batch_size=8, validation_batch_size=8, n_epochs=1)
    model = build_model(cfg)
    data_file = open_data_file(cfg.data_file)
    try:
        tg, n_t, vg, n_v = get_training_and_validation_generators(
            data_file, batch_size=cfg.batch_size, n_labels=1,
            training_keys_file=str(d / "t_dp.pkl"),
            validation_keys_file=str(d / "v_dp.pkl"),
            data_split=0.75, overwrite=True, patch_shape=cfg.patch_shape,
            validation_batch_size=cfg.validation_batch_size,
            skip_blank=True, seed=0)
        state = create_train_state(model, cfg, jax.random.PRNGKey(0))
        state = train_model(model, state, cfg, tg, vg, n_t, n_v,
                            mesh=make_mesh(8), verbose=False)
        assert os.path.exists(cfg.training_log)
    finally:
        data_file.close()


def test_resume_preserves_dropped_learning_rate(workdir, tmp_path):
    """A resumed run must keep the checkpoint's (dropped) LR — the plateau
    scheduler is rebuilt from the RESTORED state, not the fresh config."""
    from fetal_mri_segmentation_tpu.training import CheckpointIO

    d = tmp_path
    cfg = make_cfg(workdir, model_file=str(d / "m.ckpt"),
                   training_log=str(d / "log.csv"), n_epochs=1)
    model = build_model(cfg)
    state = create_train_state(model, cfg, jax.random.PRNGKey(0))
    # simulate a mid-training checkpoint with a dropped LR
    state = state.set_learning_rate(cfg.initial_learning_rate * 0.25)
    CheckpointIO(cfg.model_file).save(state, epoch=1, best_val=-0.3)

    data_file = open_data_file(cfg.data_file)
    try:
        tg, n_t, vg, n_v = get_training_and_validation_generators(
            data_file, batch_size=cfg.batch_size, n_labels=1,
            training_keys_file=str(d / "t.pkl"),
            validation_keys_file=str(d / "v.pkl"),
            data_split=0.75, overwrite=True, patch_shape=cfg.patch_shape,
            validation_batch_size=cfg.validation_batch_size,
            skip_blank=True, seed=0)
        cfg2 = make_cfg(workdir, model_file=str(d / "m.ckpt"),
                        training_log=str(d / "log.csv"), n_epochs=2)
        fresh = create_train_state(model, cfg2, jax.random.PRNGKey(0))
        out_state = train_model(model, fresh, cfg2, tg, vg, n_t, n_v,
                                verbose=False)
        # lr stayed at (or below) the restored dropped value
        assert out_state.learning_rate <= cfg.initial_learning_rate * 0.25 + 1e-12
    finally:
        data_file.close()


def test_detect_dice_collapse():
    """Saturation-collapse detector: fires only after `patience` consecutive
    near-zero training-dice epochs (the lr-too-high soft-Dice failure mode;
    see training/loop.py::detect_dice_collapse)."""
    from fetal_mri_segmentation_tpu.training.loop import detect_dice_collapse

    assert not detect_dice_collapse([])
    assert not detect_dice_collapse([0.001, 0.002])          # too short
    assert detect_dice_collapse([0.001, 0.002, 0.0005])      # 3 low epochs
    assert not detect_dice_collapse([0.001, 0.3, 0.0005])    # interrupted
    # healthy-then-collapsed history: the window is the LAST 3 epochs
    assert detect_dice_collapse([0.9, 0.95, 0.002, 0.001, 0.003])
    # healthy run never fires
    assert not detect_dice_collapse([0.1, 0.5, 0.8, 0.9])


def _scripted_training(monkeypatch, tmp_path, cfg, state, model,
                       val_losses, start_losses_at=0):
    """Run train_model with stubbed train/eval steps whose val losses follow
    a script — isolates the callback/checkpoint logic from real training."""
    import itertools

    import jax.numpy as jnp

    from fetal_mri_segmentation_tpu.training import loop as loop_mod

    counter = itertools.count(start_losses_at)

    def fake_make_train_step(model, config):
        def step(state, x, y, k, n_valid):
            return state, {"loss": jnp.float32(0.0),
                           "dice": jnp.float32(0.5)}
        return step

    def fake_make_eval_step(model, config):
        def step(state, x, y, n_valid):
            return {"loss": jnp.float32(val_losses[next(counter)]),
                    "dice": jnp.float32(0.5)}
        return step

    monkeypatch.setattr(loop_mod, "make_train_step", fake_make_train_step)
    monkeypatch.setattr(loop_mod, "make_eval_step", fake_make_eval_step)

    def gen():
        x = np.zeros((1, 8, 8, 8, 1), np.float32)
        y = np.zeros((1, 8, 8, 8, 1), np.float32)
        while True:
            yield x, y

    return train_model(model, state, cfg, gen(), gen(), 1, 1, verbose=False)


def test_exact_resume_drops_lr_at_same_epoch(tmp_path, monkeypatch):
    """A run interrupted mid-plateau must drop the LR at the SAME epoch an
    uninterrupted run does: the plateau patience counters are persisted in
    the checkpoint, not rebuilt from zero on resume.

    Script (patience=2, min_delta=1e-4): epoch 1 improves val_loss by LESS
    than min_delta — a checkpoint is written (strict <) but the plateau
    counter INCREMENTS (wait=1). An uninterrupted run then drops the LR at
    epoch 2. A run killed after epoch 1 and resumed must too — with the old
    rebuild-from-best_val behavior wait restarts at 0 and the drop lands an
    epoch late."""
    losses = [1.0, 1.0 - 5e-5, 1.5, 1.5]
    lr0, drop = 1e-2, 0.5

    def cfg_for(sub):
        d = tmp_path / sub
        d.mkdir(exist_ok=True)
        return make_cfg(d, patience=2, early_stop=50, batch_size=1,
                        validation_batch_size=1,
                        initial_learning_rate=lr0, learning_rate_drop=drop,
                        data_file="unused")

    # uninterrupted: epochs 0..2 -> LR dropped at epoch 2
    cfg_a = cfg_for("uninterrupted")
    model = build_model(cfg_a)
    st = create_train_state(model, cfg_a, jax.random.PRNGKey(0))
    final_a = _scripted_training(monkeypatch, tmp_path, cfg_a, st, model,
                                 losses, )
    # n_epochs=2 in make_cfg -> run A only covered epochs 0..1; extend
    cfg_a.n_epochs = 3
    final_a = _scripted_training(monkeypatch, tmp_path, cfg_a, st, model,
                                 losses)
    assert abs(final_a.learning_rate - lr0 * drop) < 1e-8  # f32 storage

    # interrupted after epoch 1, then resumed for exactly ONE epoch (2):
    # the restored wait counter must make epoch 2 the drop epoch
    cfg_b = cfg_for("interrupted")
    cfg_b.n_epochs = 2
    st_b = create_train_state(model, cfg_b, jax.random.PRNGKey(0))
    _scripted_training(monkeypatch, tmp_path, cfg_b, st_b, model, losses)
    cfg_b.n_epochs = 3
    st_b2 = create_train_state(model, cfg_b, jax.random.PRNGKey(0))
    final_b = _scripted_training(monkeypatch, tmp_path, cfg_b, st_b2, model,
                                 losses[2:])
    assert abs(final_b.learning_rate - lr0 * drop) < 1e-8  # f32 storage


def test_resume_restores_early_stop_patience(tmp_path, monkeypatch):
    """Early-stop patience must also survive a resume: with patience=3 and
    a best at epoch 0, an interrupted+resumed run must stop at the same
    epoch (3) as an uninterrupted one."""
    losses = [1.0, 1.0 - 5e-5, 1.5, 1.5, 1.5, 1.5, 1.5]

    d = tmp_path / "early"
    d.mkdir()
    cfg = make_cfg(d, patience=50, early_stop=3, batch_size=1,
                   validation_batch_size=1, data_file="unused")
    model = build_model(cfg)

    # interrupted after epoch 1 (checkpoint at epoch 1 carries early.wait=1
    # — the 5e-5 improvement is under EarlyStopping's min_delta=0.0? no:
    # strict < counts as improvement there, so early.wait=0... use the
    # plateau-identical script anyway and compare against an uninterrupted
    # reference run rather than hardcoding the stop epoch)
    def last_logged_epoch(path):
        return int(float(open(path).read().splitlines()[-1].split(",")[0]))

    cfg.n_epochs = 20
    st = create_train_state(model, cfg, jax.random.PRNGKey(0))
    _scripted_training(monkeypatch, tmp_path, cfg, st, model, losses)
    # uninterrupted: best at epoch 1, then 3 bad epochs -> stops at epoch 4
    uninterrupted_stop = last_logged_epoch(cfg.training_log)

    d2 = tmp_path / "early2"
    d2.mkdir()
    cfg2 = make_cfg(d2, patience=50, early_stop=3, batch_size=1,
                    validation_batch_size=1, data_file="unused")
    cfg2.n_epochs = 3  # interrupt after epoch 2 (one bad epoch seen)
    st2 = create_train_state(model, cfg2, jax.random.PRNGKey(0))
    _scripted_training(monkeypatch, tmp_path, cfg2, st2, model, losses)
    cfg2.n_epochs = 20  # resume (rewinds to the best checkpoint's epoch 2)
    st3 = create_train_state(model, cfg2, jax.random.PRNGKey(0))
    _scripted_training(monkeypatch, tmp_path, cfg2, st3, model, losses[2:])
    assert last_logged_epoch(cfg2.training_log) == uninterrupted_stop


def test_train_model_accepts_abstract_state_with_checkpoint(tmp_path,
                                                            monkeypatch):
    """train.py's compile-free resume: an abstract (eval_shape) state
    template trains fine when a checkpoint exists, and fails loudly when
    none does."""
    from fetal_mri_segmentation_tpu.training.state import (
        create_abstract_state)

    d = tmp_path / "abs"
    d.mkdir()
    cfg = make_cfg(d, batch_size=1, validation_batch_size=1,
                   data_file="unused")
    model = build_model(cfg)
    with pytest.raises(ValueError, match="abstract state"):
        _scripted_training(monkeypatch, tmp_path, cfg,
                           create_abstract_state(model, cfg), model,
                           [1.0, 0.9])
    st = create_train_state(model, cfg, jax.random.PRNGKey(0))
    _scripted_training(monkeypatch, tmp_path, cfg, st, model, [1.0, 0.9])
    cfg.n_epochs = 3
    final = _scripted_training(monkeypatch, tmp_path, cfg,
                               create_abstract_state(model, cfg), model,
                               [0.8])
    # restored concrete params trained one more epoch without model.init
    assert all(not isinstance(leaf, jax.ShapeDtypeStruct)
               for leaf in jax.tree_util.tree_leaves(final.params))


def test_peek_epoch_sidecar(workdir, tmp_path):
    """CheckpointIO.peek_epoch reads the resume epoch WITHOUT a restore
    (train.py uses it to fast-forward the generators' per-epoch rng for
    data-order exact resume); legacy checkpoints without the sidecar and
    missing checkpoints return None."""
    d = workdir
    cfg = make_cfg(d, model_file=str(tmp_path / "peek.ckpt"), n_epochs=1,
                   training_log=str(tmp_path / "peek.log"))
    model = build_model(cfg)
    data_file = open_data_file(cfg.data_file)
    try:
        tg, n_t, vg, n_v = get_training_and_validation_generators(
            data_file, batch_size=cfg.batch_size, n_labels=1,
            training_keys_file=cfg.training_file,
            validation_keys_file=cfg.validation_file,
            data_split=0.75, overwrite=False, patch_shape=cfg.patch_shape,
            validation_batch_size=cfg.validation_batch_size,
            training_patch_start_offset=(2, 2, 2), skip_blank=True, seed=0)
        io = CheckpointIO(cfg.model_file)
        assert io.peek_epoch() is None  # no checkpoint yet
        assert io.peek_data_order() is None
        state = create_train_state(model, cfg, jax.random.PRNGKey(0))
        train_model(model, state, cfg, tg, vg, n_t, n_v, verbose=False)
        assert io.peek_epoch() == 1  # saved at the end of epoch 0
        # host-staged training records lockstep batch boundaries
        assert io.peek_data_order() == {"mode": "lockstep"}
        # legacy checkpoint (sidecar removed) degrades to None, not a crash
        os.remove(cfg.model_file + ".meta.json")
        assert io.peek_epoch() is None
        assert io.peek_data_order() is None
    finally:
        data_file.close()


def test_resume_bitwise_identical_to_uninterrupted(workdir, tmp_path):
    """Data-order exact resume, end to end: an interrupted-at-2-epochs run
    resumed to 4 epochs produces BITWISE-identical training/validation
    metrics to an uninterrupted 4-epoch run — exercising the batch-level
    generator fast-forward (skip_blank=True, so epoch boundaries drift
    from steps_per_epoch), the per-epoch augmentation rng derivation, the
    scheduler-counter restore and the checkpoint-epoch sidecar together
    (train.py wires these identically)."""
    d = workdir
    data_file = open_data_file(str(d / "data.h5"))

    def gens(cfg, start_epoch=0):
        return get_training_and_validation_generators(
            data_file, batch_size=cfg.batch_size, n_labels=1,
            training_keys_file=cfg.training_file,
            validation_keys_file=cfg.validation_file,
            data_split=0.75, overwrite=False, patch_shape=cfg.patch_shape,
            validation_batch_size=cfg.validation_batch_size,
            training_patch_start_offset=(2, 2, 2), skip_blank=True,
            seed=3, start_epoch=start_epoch)

    def metric_rows(path):
        # {epoch: metric columns}, last row winning: a resume that rewinds
        # to the best epoch legitimately re-logs the replayed epochs — the
        # replays must be bitwise identical, so last-wins stays exact
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

    try:
        cfg_c = make_cfg(d, n_epochs=4, model_file=str(tmp_path / "c.ckpt"),
                         training_log=str(tmp_path / "c.log"))
        model = build_model(cfg_c)
        tg, n_t, vg, n_v = gens(cfg_c)
        state = create_train_state(model, cfg_c, jax.random.PRNGKey(1))
        train_model(model, state, cfg_c, tg, vg, n_t, n_v, verbose=False,
                    seed=3)

        # interrupted run: 2 epochs...
        cfg_r = make_cfg(d, n_epochs=2, model_file=str(tmp_path / "r.ckpt"),
                         training_log=str(tmp_path / "r.log"))
        tg, n_t, vg, n_v = gens(cfg_r)
        state = create_train_state(model, cfg_r, jax.random.PRNGKey(1))
        train_model(model, state, cfg_r, tg, vg, n_t, n_v, verbose=False,
                    seed=3)

        # ...then resumed to 4, exactly as train.py wires it: peek the
        # checkpoint epoch, fast-forward fresh generators by epoch*steps
        cfg_r4 = make_cfg(d, n_epochs=4, model_file=cfg_r.model_file,
                          training_log=cfg_r.training_log)
        start = CheckpointIO(cfg_r4.model_file).peek_epoch() or 0
        assert start > 0
        tg, n_t, vg, n_v = gens(cfg_r4, start_epoch=start)
        state = create_train_state(model, cfg_r4, jax.random.PRNGKey(1))
        train_model(model, state, cfg_r4, tg, vg, n_t, n_v, verbose=False,
                    seed=3)

        cont, res = metric_rows(cfg_c.training_log), \
            metric_rows(cfg_r4.training_log)
        assert set(cont) == set(res)
        for e in sorted(cont):
            assert cont[e] == res[e], \
                f"epoch {e} diverged: {cont[e]} != {res[e]}"
    finally:
        data_file.close()


def test_peek_epoch_rejects_corrupt_sidecar(tmp_path):
    """A hand-edited/corrupt sidecar must never feed a negative epoch into
    the generators' skip_batches (it would fast-forward forever) — and a
    present-but-unreadable sidecar degrades to None."""
    import json
    path = str(tmp_path / "x.ckpt")
    os.makedirs(path)
    open(os.path.join(path, "state.npz"), "w").close()  # exists() marker
    io = CheckpointIO(path)
    json.dump({"epoch": -1, "best_val": 0.0}, open(path + ".meta.json", "w"))
    assert io.peek_epoch() is None
    open(path + ".meta.json", "w").write("not json")
    assert io.peek_epoch() is None
    json.dump({"epoch": 7, "best_val": 0.0}, open(path + ".meta.json", "w"))
    assert io.peek_epoch() == 7


def test_resume_warns_on_sidecar_checkpoint_mismatch(workdir, tmp_path,
                                                     capsys):
    """If the sidecar epoch (used to fast-forward the generators) and the
    checkpoint payload epoch disagree — kill between the two writes, or a
    checkpoint dir copied without its sidecar — the resume must say the
    data order is no longer exact instead of silently diverging."""
    import json
    d = workdir
    cfg = make_cfg(d, model_file=str(tmp_path / "m.ckpt"), n_epochs=1,
                   training_log=str(tmp_path / "m.log"))
    model = build_model(cfg)
    data_file = open_data_file(cfg.data_file)
    try:
        tg, n_t, vg, n_v = get_training_and_validation_generators(
            data_file, batch_size=cfg.batch_size, n_labels=1,
            training_keys_file=cfg.training_file,
            validation_keys_file=cfg.validation_file,
            data_split=0.75, overwrite=False, patch_shape=cfg.patch_shape,
            validation_batch_size=cfg.validation_batch_size,
            training_patch_start_offset=(2, 2, 2), skip_blank=True, seed=0)
        state = create_train_state(model, cfg, jax.random.PRNGKey(0))
        train_model(model, state, cfg, tg, vg, n_t, n_v, verbose=False)
        # stale sidecar: pretend it lags the checkpoint payload by one save
        json.dump({"epoch": 9, "best_val": 0.0},
                  open(cfg.model_file + ".meta.json", "w"))
        cfg2 = make_cfg(d, model_file=cfg.model_file, n_epochs=2,
                        training_log=cfg.training_log)
        capsys.readouterr()
        state2 = create_train_state(model, cfg2, jax.random.PRNGKey(0))
        train_model(model, state2, cfg2, tg, vg, n_t, n_v, verbose=False)
        assert "sidecar epoch 9" in capsys.readouterr().out
    finally:
        data_file.close()


def test_resume_bitwise_identical_under_dp_mesh(workdir, tmp_path):
    """Exact resume holds on the 8-device data-parallel mesh too: the
    sharded step consumes the same per-epoch fold_in keys and the same
    fast-forwarded generator stream, so an interrupted+resumed DP run is
    bitwise identical to an uninterrupted one."""
    from fetal_mri_segmentation_tpu.parallel import make_mesh

    d = workdir
    data_file = open_data_file(str(d / "data.h5"))
    mesh = make_mesh(8)

    def gens(cfg, start_epoch=0):
        return get_training_and_validation_generators(
            data_file, batch_size=cfg.batch_size, n_labels=1,
            training_keys_file=cfg.training_file,
            validation_keys_file=cfg.validation_file,
            data_split=0.75, overwrite=False, patch_shape=cfg.patch_shape,
            validation_batch_size=cfg.validation_batch_size,
            training_patch_start_offset=(2, 2, 2), skip_blank=True,
            seed=11, start_epoch=start_epoch)

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

    try:
        kw = dict(batch_size=8, validation_batch_size=8)
        cfg_c = make_cfg(d, n_epochs=3, model_file=str(tmp_path / "dc.ckpt"),
                         training_log=str(tmp_path / "dc.log"), **kw)
        model = build_model(cfg_c)
        tg, n_t, vg, n_v = gens(cfg_c)
        state = create_train_state(model, cfg_c, jax.random.PRNGKey(2))
        train_model(model, state, cfg_c, tg, vg, n_t, n_v, mesh=mesh,
                    verbose=False, seed=11)

        cfg_r = make_cfg(d, n_epochs=1, model_file=str(tmp_path / "dr.ckpt"),
                         training_log=str(tmp_path / "dr.log"), **kw)
        tg, n_t, vg, n_v = gens(cfg_r)
        state = create_train_state(model, cfg_r, jax.random.PRNGKey(2))
        train_model(model, state, cfg_r, tg, vg, n_t, n_v, mesh=mesh,
                    verbose=False, seed=11)

        cfg_r3 = make_cfg(d, n_epochs=3, model_file=cfg_r.model_file,
                          training_log=cfg_r.training_log, **kw)
        start = CheckpointIO(cfg_r3.model_file).peek_epoch() or 0
        assert start > 0
        tg, n_t, vg, n_v = gens(cfg_r3, start_epoch=start)
        state = create_train_state(model, cfg_r3, jax.random.PRNGKey(2))
        train_model(model, state, cfg_r3, tg, vg, n_t, n_v, mesh=mesh,
                    verbose=False, seed=11)

        cont, res = metric_rows(cfg_c.training_log), \
            metric_rows(cfg_r3.training_log)
        assert set(cont) == set(res)
        for e in sorted(cont):
            assert cont[e] == res[e], \
                f"epoch {e} diverged under DP: {cont[e]} != {res[e]}"
    finally:
        data_file.close()


def test_train_model_rejects_zero_steps(workdir):
    cfg = make_cfg(workdir)
    model = build_model(cfg)
    state = create_train_state(model, cfg, jax.random.PRNGKey(0))

    def empty():
        while True:
            yield None
    with pytest.raises(ValueError, match="steps_per_epoch"):
        train_model(model, state, cfg, empty(), empty(), 0, 1, verbose=False)


def test_train_model_without_validation(workdir, tmp_path, capsys):
    """validation_steps == 0 (1-case dataset, validation_split=1.0) must
    train monitoring the TRAINING loss — not fabricate val metrics of 0.0
    that pin best_val and decay the LR every `patience` epochs."""
    d = tmp_path
    cfg = make_cfg(workdir, model_file=str(d / "m.ckpt"),
                   training_file=str(d / "t.pkl"),
                   validation_file=str(d / "v.pkl"),
                   training_log=str(d / "novalid.log"), n_epochs=2)
    model = build_model(cfg)
    data_file = open_data_file(cfg.data_file)
    try:
        tg, n_t, vg, n_v = get_training_and_validation_generators(
            data_file, batch_size=cfg.batch_size, n_labels=1,
            training_keys_file=cfg.training_file,
            validation_keys_file=cfg.validation_file,
            data_split=1.0, overwrite=True, patch_shape=cfg.patch_shape,
            validation_batch_size=cfg.validation_batch_size,
            skip_blank=True, seed=0)
        assert n_v == 0
        state = create_train_state(model, cfg, jax.random.PRNGKey(0))
        train_model(model, state, cfg, tg, vg, n_t, n_v, verbose=True)
    finally:
        data_file.close()
    out = capsys.readouterr().out
    assert "no validation will run" in out
    assert "val_loss" not in out  # nothing fabricated in the epoch lines
    # a best checkpoint WAS written (monitored on training loss)
    from fetal_mri_segmentation_tpu.training.checkpoint import CheckpointIO
    assert CheckpointIO(cfg.model_file).exists()
    # and the CSV rows carry train metrics without val_ columns
    with open(cfg.training_log) as f:
        header = f.readline()
    assert "loss" in header and "val_loss" not in header
