#!/usr/bin/env python
"""Time the formulation choices XLA is given on the GPU.

1. The full-resolution decoder level ``dec0`` of the flagship unet
   (upsample x2 of 128 channels at 32^3, concat with a 64-channel 64^3
   skip, 3^3 conv 192 -> 64) at B=1 and B=6, forward and forward+backward,
   in its three exact-math forms: the 8-parity decomposition
   (models/layers.py::up_concat_conv3x3), one input-dilated conv
   (up_concat_conv3x3_dilated), and plain upsample + concat + conv.
2. The whole flagship unet (configs/fetal_unet.json widths, 64^3 patches)
   at B=1 and B=6, forward and forward+backward of the soft-Dice loss, with
   level-0 space-to-depth folding off/on x decoder form parity/dilated —
   the two gates in models/layers.py (FOLD_BACKENDS, DILATED_BACKENDS).
3. A large bf16 matrix product, for the rate a plain op reaches here.

Each time is the median of 5 windows of 10 calls, each window ended by
``block_until_ready``, after a warm-up call. FLOPs are those of the plain
form (2 * MACs of a dense 3^3 conv over the upsampled, concatenated
input; x3 for forward+backward); the share is of the published 989
TFLOP/s dense bf16 peak of an H100 SXM. Prints one JSON line per
measurement and the card's name and power limit.

    python tools/bench_forms.py [--out bench_forms.jsonl] [--only dec0]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

H100_BF16_PEAK = 989e12  # NVIDIA H100 SXM data sheet, dense bf16


def timed(fn, *args, windows: int = 5, calls: int = 10) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    out = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(calls):
            r = fn(*args)
        jax.block_until_ready(r)
        out.append((time.perf_counter() - t0) / calls)
    return float(np.median(out))


def dec0_rows(emit):
    import jax
    import jax.numpy as jnp

    from fetal_mri_segmentation_tpu.models.layers import (
        up_concat_conv3x3, up_concat_conv3x3_dilated, upsample_nearest)

    def plain(x, s, k, b):
        h = jnp.concatenate([upsample_nearest(x, (2, 2, 2)), s], axis=-1)
        return jax.lax.conv_general_dilated(
            h, k, (1, 1, 1), "SAME",
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC")) + b

    forms = {"parity": up_concat_conv3x3,
             "dilated": up_concat_conv3x3_dilated, "plain": plain}
    rng = np.random.default_rng(0)
    bf = jnp.bfloat16
    for B in (1, 6):
        x = jnp.asarray(rng.normal(size=(B, 32, 32, 32, 128)), bf)
        s = jnp.asarray(rng.normal(size=(B, 64, 64, 64, 64)), bf)
        k = jnp.asarray(rng.normal(size=(3, 3, 3, 192, 64)) * 0.05, bf)
        b = jnp.zeros((64,), jnp.float32)
        flops = 2.0 * B * 64 ** 3 * 27 * 192 * 64
        for name, f in forms.items():
            fwd = jax.jit(lambda x, s, k, b, f=f: f(x, s, k, b.astype(bf)))
            grad = jax.jit(jax.grad(
                lambda x, s, k, b, f=f: jnp.sum(
                    f(x, s, k, b.astype(bf)).astype(jnp.float32) ** 2),
                argnums=(0, 1, 2)))
            for mode, fn, mult in (("fwd", fwd, 1), ("fwd+bwd", grad, 3)):
                sec = timed(fn, x, s, k, b)
                emit({"bench": "dec0", "form": name, "batch": B,
                      "mode": mode, "ms": sec * 1e3,
                      "tflops": mult * flops / sec / 1e12,
                      "peak_share": mult * flops / sec / H100_BF16_PEAK})


def model_rows(emit):
    import jax
    import jax.numpy as jnp

    from fetal_mri_segmentation_tpu.config import Config
    from fetal_mri_segmentation_tpu.models import build_model, layers
    from fetal_mri_segmentation_tpu.ops import dice_coefficient_loss

    cfg = Config.load(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "fetal_unet.json"))
    rng = np.random.default_rng(0)
    for B in (1, 6):
        x = jnp.asarray(rng.normal(size=(B, 64, 64, 64, 1)), jnp.float32)
        y = jnp.asarray(rng.random((B, 64, 64, 64, 1)) > 0.7, jnp.float32)
        for fold in ("off", (1, 1, 2)):
            for form in ("parity", "dilated"):
                cfg.fold_level0 = fold
                model = build_model(cfg)
                variables = model.init(jax.random.PRNGKey(0), x[:1])
                layers.DILATED_BACKENDS = (frozenset({"gpu"})
                                           if form == "dilated"
                                           else frozenset())

                def loss(p, x, y):
                    return dice_coefficient_loss(
                        y, model.apply({"params": p}, x, train=True))

                fwd = jax.jit(lambda v, x: model.apply(v, x))
                grad = jax.jit(jax.grad(loss))
                t_fwd = timed(fwd, variables, x)
                t_grad = timed(grad, variables["params"], x, y)
                emit({"bench": "unet", "batch": B,
                      "fold": "off" if fold == "off" else "1,1,2",
                      "decoder": form, "fwd_ms": t_fwd * 1e3,
                      "fwd+bwd_ms": t_grad * 1e3})
    layers.DILATED_BACKENDS = frozenset()
    stats = jax.devices()[0].memory_stats() or {}
    emit({"bench": "memory", **{k: stats.get(k) for k in
                                ("bytes_limit", "peak_bytes_in_use")}})


def matmul_row(emit):
    import jax
    import jax.numpy as jnp

    n = 8192
    a = jnp.ones((n, n), jnp.bfloat16)
    f = jax.jit(lambda a: a @ a)
    sec = timed(f, a)
    emit({"bench": "matmul_bf16", "n": n, "ms": sec * 1e3,
          "tflops": 2 * n ** 3 / sec / 1e12,
          "peak_share": 2 * n ** 3 / sec / H100_BF16_PEAK})


def main():
    import jax

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", choices=["dec0", "unet", "matmul"])
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        sys.exit("bench_forms: no GPU visible")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    sink = open(args.out, "a") if args.out else None

    def emit(row):
        row = {**row, "card": card, "device_kind": jax.devices()[0]
               .device_kind}
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    for name, fn in (("matmul", matmul_row), ("dec0", dec0_rows),
                     ("unet", model_rows)):
        if args.only in (None, name):
            fn(emit)


if __name__ == "__main__":
    main()
