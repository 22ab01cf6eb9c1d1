"""chip_smoke.py by import: its contract pieces, and its phases rehearsed
on the CPU at a tiny size (the real run needs GPUs and full widths).

The rehearsals run in float32, where the programs and the reference agree
to rounding, so the script's own bf16/TF32 limits apply unchanged."""

import json
import os
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

TINY = dict(image_shape=(32, 32, 32), patch_shape=(16, 16, 16), depth=4,
            n_base_filters=2, batch_size=2, validation_batch_size=2,
            validation_patch_overlap=4, training_patch_start_offset=(4, 4, 4),
            compute_dtype="float32")


def test_result_line_is_the_contract():
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


@pytest.mark.parametrize("multi,want", [
    (False, ["device", "train", "predict", "serve"]),
    (True, ["device", "multi"]),
])
def test_phase_selection(multi, want):
    assert chip_smoke.phases(multi) == want


def test_exits_nonzero_without_gpu():
    """No CPU fallback: with JAX held to the CPU the script stops before
    any phase and prints no result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join(REPO,
                                                        "chip_smoke.py")],
                          capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs 1 GPU" in proc.stderr


def test_phases_rehearsed_on_cpu(tmp_path):
    """train (unet + isensee, checkpoint restore), predict (each predictor
    vs the reference) and serve, end to end at a tiny size."""
    cfg, state = chip_smoke.phase_train(str(tmp_path), n_cases=6, **TINY)
    assert int(state.step) >= 4
    report = chip_smoke.phase_predict(cfg, state, "cpu")
    assert set(report) == {"sliding_window", "direct", "direct_tta_flips",
                           "direct_f32"}
    assert all(r["dice"] >= chip_smoke.LABEL_DICE_MIN
               for r in report.values())
    chip_smoke.phase_serve(cfg, str(tmp_path), "cpu", raw_shape=(40, 40, 30))
    for i in range(2):
        assert os.path.exists(tmp_path / "served" / f"case_{i}"
                              / "prediction.nii.gz")


def test_multi_phase_rehearsed_on_virtual_devices(tmp_path):
    """--multi's DP and spatial comparisons over 4 of the suite's virtual
    CPU devices (a 1-D mesh)."""
    tiny = {k: v for k, v in TINY.items() if k != "batch_size"}
    chip_smoke.phase_multi(jax.devices()[:4], str(tmp_path), "cpu", batch=4,
                           **tiny)
