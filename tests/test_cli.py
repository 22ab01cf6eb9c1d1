"""train.py CLI helpers."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from train import fetch_training_data_files
from tests.synthetic import write_synthetic_dataset


def test_fetch_training_data_files(tmp_path):
    write_synthetic_dataset(str(tmp_path), n_cases=3, shape=(8, 8, 8),
                            modalities=("volume",))
    files, ids = fetch_training_data_files(str(tmp_path), ("volume",))
    assert len(files) == 3 and ids == ["case_0", "case_1", "case_2"]
    assert all(len(f) == 2 for f in files)  # [volume, truth]
    assert files[0][-1].endswith("truth.nii.gz")


def test_fetch_skips_incomplete_cases(tmp_path):
    write_synthetic_dataset(str(tmp_path), n_cases=2, shape=(8, 8, 8))
    os.remove(os.path.join(str(tmp_path), "case_1", "truth.nii.gz"))
    files, ids = fetch_training_data_files(str(tmp_path), ("volume",))
    assert ids == ["case_0"]


def test_shipped_configs_load_cleanly():
    """configs/*.json presets must load without unknown-key warnings and
    resolve to the intended model families."""
    import glob
    import json
    import warnings

    from fetal_mri_segmentation_tpu.config import Config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = sorted(glob.glob(os.path.join(root, "configs", "*.json")))
    assert paths, "configs/ presets missing"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cfgs = {os.path.basename(p): Config.load(p) for p in paths}
    assert cfgs["fetal_unet.json"].model_name == "unet"
    assert cfgs["fetal_isensee.json"].model_name == "isensee"
    for name, cfg in cfgs.items():
        assert cfg.n_labels == len(cfg.labels), name
        # every non-comment key must be a real Config field
        d = json.load(open(os.path.join(root, "configs", name)))
        known = {f.name for f in __import__("dataclasses").fields(Config)}
        bad = [k for k in d if not k.startswith("_") and k not in known]
        assert not bad, f"{name}: unknown keys {bad}"


def test_assign_output_names_dedup_never_collides():
    from predict import assign_output_names

    # the deduped second "foo" must NOT take the literal "foo_2" input's
    # name (previously silently overwrote its output)
    names = assign_output_names(
        ["a/foo.nii.gz", "b/foo_2.nii.gz", "c/foo.nii"])
    assert names[0] == "foo"
    assert names[1] == "foo_2"
    assert len(set(names)) == 3
    # stable simple case
    assert assign_output_names(["x/c1.nii", "y/c2.nii"]) == ["c1", "c2"]


def test_config_data_dir_key_and_cli_precedence(tmp_path):
    """data_dir is a first-class config key (no unknown-key warning) and a
    JSON config alone can point train.py at the dataset; an explicit
    --data-dir still wins (train.py: args.data_dir or cfg.data_dir or
    'data')."""
    import json
    import warnings

    from fetal_mri_segmentation_tpu.config import Config

    p = tmp_path / "c.json"
    json.dump({"data_dir": "/some/cases", "n_epochs": 1}, open(p, "w"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # unknown keys warn -> would raise
        cfg = Config.load(str(p))
    assert cfg.data_dir == "/some/cases"
    assert (None or cfg.data_dir or "data") == "/some/cases"
    assert ("/cli/wins" or cfg.data_dir or "data") == "/cli/wins"
    assert (None or Config().data_dir or "data") == "data"


@pytest.mark.parametrize("key", ["use_pallas_conv", "use_pallas_dec0"])
def test_config_with_removed_kernel_flags_still_loads(tmp_path, key):
    """Configs saved while the kernel flags existed load, with the
    unknown-key warning, and the flag has no effect."""
    import json

    from fetal_mri_segmentation_tpu.config import Config

    p = tmp_path / "old.json"
    json.dump({key: True, "n_epochs": 3}, open(p, "w"))
    with pytest.warns(UserWarning, match=key):
        cfg = Config.load(str(p))
    assert cfg.n_epochs == 3 and not hasattr(cfg, key)


@pytest.mark.parametrize("bad,match", [
    (dict(model_name="vnet"), "model_name"),
    (dict(compute_dtype="fp8"), "compute_dtype"),
    (dict(normalization="zscore"), "normalization"),
    (dict(batch_size=0), "batch_size"),
    (dict(initial_learning_rate=-1.0), "initial_learning_rate"),
])
def test_config_validates_at_construction(bad, match):
    """Invalid configs must fail at Config() with an actionable message,
    not epochs later inside the pipeline."""
    from fetal_mri_segmentation_tpu.config import Config

    with pytest.raises(ValueError, match=match):
        Config(**bad)
