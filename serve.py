#!/usr/bin/env python
"""Streaming inference server: watch a directory, predict new cases on arrival.

Beyond the reference surface (its only inference mode is a batch run over the
validation pickle). One process compiles the predictor once, keeps params
device-resident, and serves every case dropped into --watch:

    python serve.py --config experiment.json --watch incoming/ --output served/
    python serve.py --config experiment.json --watch incoming/ --direct --once

Case layout: <watch>/<case>/{<modality>.nii.gz...} (train-time layout), or
bare .nii[.gz] files for single-modality configs. Idempotent: a case with an
existing prediction.nii.gz is skipped; delete it to re-predict.
"""

from __future__ import annotations

import argparse
import signal
import threading


def main(config, watch: str, output: str = "served", overlap: int = None,
         patch_batch_size: int = 8, direct: bool = False, tta: bool = False,
         poll: float = 1.0, once: bool = False, threshold: float = 0.5,
         save_inputs: bool = False, device_preprocess: bool = False,
         stats_file: str = None):
    if overlap is None:
        # follow the config's validation grid: a patch_shape smaller than
        # the old hardcoded 16 would otherwise reject its own config
        overlap = config.validation_patch_overlap
    from fetal_mri_segmentation_tpu.utils.compilation_cache import (
        enable_compilation_cache)
    enable_compilation_cache()
    from fetal_mri_segmentation_tpu.inference.predict import (
        build_serving_predictor, load_serving_model)
    from fetal_mri_segmentation_tpu.inference.serve import watch_and_predict

    model, variables = load_serving_model(config)
    predictor = build_serving_predictor(
        model, config, direct=direct, tta=tta, overlap=overlap,
        patch_batch_size=patch_batch_size)

    # training-distribution moments loaded ONCE, shared by the device
    # preprocessor and the watch loop (same injection as predict.py --input)
    moments = None
    if config.normalization == "global":
        from fetal_mri_segmentation_tpu.inference.predict import (
            load_global_moments)
        moments = load_global_moments(config.data_file)
    device_pre = None
    if device_preprocess:
        from fetal_mri_segmentation_tpu.inference.predict import (
            make_device_preprocessor)
        device_pre = make_device_preprocessor(model, config, moments=moments)

    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    if not once:
        print(f"[serve] watching {watch} -> {output} "
              f"({'direct' if direct else 'sliding-window'} mode, "
              f"poll {poll}s; Ctrl-C to stop)", flush=True)
    stats: dict = {}
    n = watch_and_predict(watch, output, model, variables, config, predictor,
                          poll_interval=poll, once=once, stop=stop,
                          threshold=threshold, overlap=overlap,
                          save_inputs=save_inputs, stats=stats,
                          stats_file=stats_file, device_pre=device_pre,
                          moments=moments)
    print(f"[serve] done: {n} case(s) predicted")
    if once and stats.get("aux_write_failures"):
        # served cases whose --save-inputs copies were lost: the predictions
        # ARE on disk (a rerun would skip these cases and could not rewrite
        # the copies anyway), so report truthfully but exit 0
        print(f"[serve] note: {stats['aux_write_failures']} auxiliary "
              f"--save-inputs write(s) were lost on otherwise-served cases "
              f"— see log above", flush=True)
    if once and stats.get("write_failures"):
        # a --once run that lost PREDICTIONS (e.g. disk full) must not exit
        # 0 claiming success — the artifacts are simply not on disk
        raise SystemExit(
            f"[serve] {stats['write_failures']} case(s) predicted but "
            f"their prediction writes FAILED — see log above")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--watch", required=True,
                    help="directory to watch for incoming cases")
    ap.add_argument("--output", default="served")
    ap.add_argument("--overlap", type=int, default=None,
                    help="sliding-window patch overlap (default: the "
                         "config's validation_patch_overlap)")
    ap.add_argument("--patch-batch-size", type=int, default=8)
    ap.add_argument("--direct", action="store_true",
                    help="whole-volume forward (no patch grid; ~2x less "
                         "device time; dims must divide 2^(depth-1))")
    ap.add_argument("--tta", action="store_true",
                    help="test-time augmentation averaging (see --tta-mode)")
    ap.add_argument("--tta-mode", choices=["permute", "flips"],
                    default=None,
                    help="implies --tta. permute = all 48 cube symmetries "
                         "(cubic patches only; the default with bare "
                         "--tta); flips = 8-way axis-flip subgroup "
                         "(~6x cheaper, any patch shape)")
    ap.add_argument("--poll", type=float, default=1.0,
                    help="poll interval in seconds")
    ap.add_argument("--once", action="store_true",
                    help="process the current backlog and exit")
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--save-inputs", action="store_true",
                    help="also write the preprocessed data_<modality> and "
                         "truth NIfTIs per case (the full evaluate.py-ready "
                         "output tree; off by default to keep the hot path "
                         "to one write)")
    ap.add_argument("--device-preprocess", action="store_true",
                    help="run the ingest zoom + normalization on the device "
                         "(host does read + crop only; shape-bucketed "
                         "compiles, fp-level parity with the host path)")
    ap.add_argument("--stats-file", default=None, metavar="PATH",
                    help="write an atomically-replaced JSON heartbeat after "
                         "every sweep (uptime, served/failed counts, "
                         "quarantine size, p50/p95/max case latency) for "
                         "external monitoring")
    args = ap.parse_args()

    from fetal_mri_segmentation_tpu.config import Config
    from fetal_mri_segmentation_tpu.inference.predict import resolve_tta

    main(Config.load(args.config), watch=args.watch, output=args.output,
         overlap=args.overlap, patch_batch_size=args.patch_batch_size,
         direct=args.direct, tta=resolve_tta(args.tta, args.tta_mode),
         poll=args.poll, once=args.once,
         threshold=args.threshold, save_inputs=args.save_inputs,
         device_preprocess=args.device_preprocess,
         stats_file=args.stats_file)
