"""Subprocess-level CLI wiring tests for serve.py and predict.py --input.

The library paths are covered by tests/test_serve.py and
tests/test_predict_case.py; these pin the argparse surface itself (flag
names, config loading, exit codes) end-to-end in a real process. Kept to
ONE small checkpoint and two short-lived subprocesses — serving cold-start
is sub-second (create_abstract_state), so the cost is mostly interpreter +
jax import.
"""
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import pytest

from fetal_mri_segmentation_tpu.config import Config
from fetal_mri_segmentation_tpu.models import build_model
from fetal_mri_segmentation_tpu.training import create_train_state
from fetal_mri_segmentation_tpu.training.checkpoint import CheckpointIO
from tests.synthetic import write_synthetic_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_serve")
    write_synthetic_dataset(str(d / "watch"), n_cases=1, shape=(24, 24, 24))
    cfg = Config(image_shape=(24, 24, 24), patch_shape=(16, 16, 16),
                 model_name="unet", depth=3, n_base_filters=4,
                 compute_dtype="float32", validation_patch_overlap=4,
                 data_file=str(d / "none.h5"),
                 model_file=str(d / "ckpt"))
    model = build_model(cfg)
    state = create_train_state(model, cfg, jax.random.PRNGKey(0))
    CheckpointIO(cfg.model_file).save(state, epoch=1, best_val=-0.5)
    cfg.save(str(d / "exp.json"))
    return d


def _run(args, timeout=240):
    env = dict(os.environ,
               JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, timeout=timeout, env=env, cwd=REPO)


@pytest.mark.parametrize("device_preprocess", [False, True],
                         ids=["host-preprocess", "device-preprocess"])
def test_serve_cli_once(experiment, device_preprocess):
    d = experiment
    out = str(d / ("served_dev" if device_preprocess else "served"))
    args = [os.path.join(REPO, "serve.py"),
            "--config", str(d / "exp.json"),
            "--watch", str(d / "watch"),
            "--output", out,
            "--once"]  # no --overlap: defaults to the config's
    #                    validation_patch_overlap (4 here; the old
    #                    hardcoded 16 would reject this 16^3-patch config)
    if device_preprocess:
        args.append("--device-preprocess")
    r = _run(args)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "1 case(s) predicted" in r.stdout
    assert os.path.exists(os.path.join(out, "case_0", "prediction.nii.gz"))


def test_predict_cli_input(experiment):
    d = experiment
    r = _run([os.path.join(REPO, "predict.py"),
              "--config", str(d / "exp.json"),
              "--output-dir", str(d / "pred"),
              # no --overlap: defaults to the config's
              # validation_patch_overlap (the old hardcoded 16 would
              # reject this 16^3-patch config)
              "--input", str(d / "watch" / "case_0")])
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(str(d / "pred" / "case_0" / "prediction.nii.gz"))
    # incompatible flags fail fast with a clear message
    r = _run([os.path.join(REPO, "predict.py"),
              "--config", str(d / "exp.json"),
              "--input", str(d / "watch" / "case_0"),
              "--num-devices", "2"], timeout=120)
    assert r.returncode != 0
    assert "--input is single-device" in (r.stderr + r.stdout)


def test_predict_cli_prob_dtype_requires_prob_map(experiment):
    """--prob-dtype float16 without --prob-map is a no-op path — it must
    fail fast like every other incompatible flag combination, not let the
    user believe they exercised the fp16 transfer."""
    d = experiment
    r = _run([os.path.join(REPO, "predict.py"),
              "--config", str(d / "exp.json"),
              "--input", str(d / "watch" / "case_0"),
              "--prob-dtype", "float16"], timeout=120)
    assert r.returncode != 0
    assert "--prob-dtype applies to the probability-map" in (
        r.stderr + r.stdout)
