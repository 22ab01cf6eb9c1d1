"""Subprocess worker for the two-process multi-host smoke test.

Launched by tests/test_multihost.py. Runs ONE data-parallel train step over
a 2-device global mesh — either as one of two cooperating processes
(jax.distributed.initialize over a local TCP coordinator; 1 CPU device
each) or as a single process with 2 virtual devices (the reference
result). Process 0 writes the step metrics and a parameter digest so the
parent can assert the two-process path computes the same numbers.
"""

import argparse
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--processes", type=int, required=True)
    ap.add_argument("--pid", type=int, default=0)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    if args.processes > 1:
        # the surface under test: parallel/distributed.py::
        # initialize_distributed → jax.distributed.initialize (multi-host path)
        from fetal_mri_segmentation_tpu.parallel.distributed import (
            initialize_distributed)
        initialize_distributed(args.coordinator, args.processes, args.pid)

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from fetal_mri_segmentation_tpu.config import Config
    from fetal_mri_segmentation_tpu.models import build_model
    from fetal_mri_segmentation_tpu.parallel import (
        make_dp_train_step, make_mesh, replicate_state, shard_batch)
    from fetal_mri_segmentation_tpu.training import create_train_state

    assert jax.process_count() == args.processes, (
        jax.process_count(), args.processes)
    assert jax.device_count() == 2, jax.device_count()

    cfg = Config(model_name="unet", depth=2, n_base_filters=2,
                 patch_shape=(8, 8, 8), batch_size=2,
                 compute_dtype="float32", augment=False,
                 initial_learning_rate=1e-2)
    model = build_model(cfg)
    # SGD: the param delta is linear in the gradient (same rationale as
    # tests/test_parallel.py::test_dp_step_matches_single_device)
    tx = optax.sgd(1.0)
    state = create_train_state(model, cfg, jax.random.PRNGKey(0), tx=tx)

    rng = np.random.default_rng(0)
    shape = (2, 1, 8, 8, 8)
    y = np.zeros(shape, np.float32)
    y[:, :, 2:6, 2:6, 2:6] = 1.0
    x = (y * 2 + rng.normal(0, 0.3, shape)).astype(np.float32)

    mesh = make_mesh(2)
    state = replicate_state(mesh, state)
    step = make_dp_train_step(model, cfg, mesh)
    xs, ys = shard_batch(mesh, x, y)
    new_state, metrics = step(state, xs, ys, jax.random.PRNGKey(7),
                              jnp.asarray(2))

    # metrics and params are fully replicated -> materializable locally
    digest = float(sum(float(jnp.sum(jnp.abs(leaf)))
                       for leaf in jax.tree_util.tree_leaves(
                           new_state.params)))
    result = {"loss": float(metrics["loss"]),
              "dice": float(metrics["dice"]),
              "param_digest": digest,
              "process_count": jax.process_count()}
    if jax.process_index() == 0:
        with open(args.out, "wb") as f:
            pickle.dump(result, f)
    print(f"[worker pid={args.pid}] ok: {result}", flush=True)


if __name__ == "__main__":
    main()
