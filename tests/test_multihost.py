"""Two-process multi-host smoke test (SURVEY.md §5.8).

Runs the REAL `jax.distributed.initialize` path: two local CPU processes
(one device each) form a 2-device global mesh via a TCP coordinator and
execute one data-parallel train step; the result must match a
single-process run on a 2-virtual-device mesh (same global batch, same
seeds).

Env-gated: the coordinator handshake + two extra JAX startups cost ~1 min
on a small CPU host, so CI skips unless FETAL_MULTIHOST_TEST=1:

    FETAL_MULTIHOST_TEST=1 python -m pytest tests/test_multihost.py -q
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.skipif(
    os.environ.get("FETAL_MULTIHOST_TEST") != "1",
    reason="two-process jax.distributed smoke is slow — set "
           "FETAL_MULTIHOST_TEST=1 to run it")

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(n_local_devices: int) -> dict:
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"--xla_force_host_platform_device_count={n_local_devices}",
        PYTHONPATH=os.pathsep.join(
            [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
             env.get("PYTHONPATH", "")]))
    return env


def test_two_process_dp_step_matches_single_process(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    out2 = str(tmp_path / "two_proc.pkl")
    out1 = str(tmp_path / "one_proc.pkl")

    procs = [subprocess.Popen(
        [sys.executable, _WORKER, "--processes", "2", "--pid", str(pid),
         "--coordinator", coord, "--out", out2],
        env=_env(1), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(2)]
    outputs = [p.communicate(timeout=600)[0] for p in procs]
    for p, o in zip(procs, outputs):
        assert p.returncode == 0, f"worker failed:\n{o[-2000:]}"

    r = subprocess.run(
        [sys.executable, _WORKER, "--processes", "1", "--out", out1],
        env=_env(2), capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]

    two = pickle.load(open(out2, "rb"))
    one = pickle.load(open(out1, "rb"))
    assert two["process_count"] == 2 and one["process_count"] == 1
    assert np.isclose(two["loss"], one["loss"], atol=1e-6)
    assert np.isclose(two["dice"], one["dice"], atol=1e-6)
    assert np.isclose(two["param_digest"], one["param_digest"],
                      rtol=1e-6)
