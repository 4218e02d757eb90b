"""CLI driver (layer L6) — the reference's ``train_model.py`` as a proper
command-line tool.

Reference flow (train_model.py:1-83): read ``configuration.cfg`` -> load
options -> [optionally train] -> batch inference over the inference folder.
Here both phases are explicit subcommands; ``run`` does train-then-infer
like the reference script's full (partly commented-out) pipeline.

Usage:
    python -m subcort_tpu.cli train  [--config configuration.cfg]
    python -m subcort_tpu.cli infer  [--config configuration.cfg]
    python -m subcort_tpu.cli run    [--config configuration.cfg]
"""

from __future__ import annotations

import argparse
import os
import sys


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="subcort_tpu",
                                description="sub-cortical segmentation in JAX")
    p.add_argument("command",
                   choices=["train", "infer", "run", "evaluate", "loo",
                            "import-atlas"],
                   help="train: fit the model; infer: segment the inference "
                        "folder; run: both; evaluate: Dice of existing "
                        "segmentations vs ground truth; loo: leave-one-out "
                        "cross-validation over the train folder (volumes "
                        "loaded once, one model + held-out Dice per fold); "
                        "import-atlas: validate + install user-supplied MNI "
                        "atlas assets")
    p.add_argument("--config", default="configuration.cfg",
                   help="path to a reference-format configuration.cfg")
    p.add_argument("--template", default=None,
                   help="import-atlas: path to the MNI T1 template NIfTI")
    p.add_argument("--atlas", default=None,
                   help="import-atlas: path to the (X,Y,Z,15) probabilistic "
                        "subcortical atlas NIfTI (channel 14 = background)")
    p.add_argument("--atlas-dir", default=None,
                   help="import-atlas: install directory (default: the "
                        "package atlases/ directory)")
    p.add_argument("--weights-path", default="nets",
                   help="experiment artifact root (reference: nets/)")
    p.add_argument("--augment", action="store_true",
                   help="enable rotation/flip augmentation (the reference "
                        "defines but never activates it)")
    p.add_argument("--intensity-augment", type=float, default=None,
                   metavar="S",
                   help="train-time intensity-robustness augmentation "
                        "strength (overrides [tpu] intensity_augment; "
                        "0 = off = reference-exact, 2.0 = the strength "
                        "validated by the robustness gate)")
    p.add_argument("--folds", default=None,
                   help="loo: comma-separated held-out subject names "
                        "(default: every subject in the train folder)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="capture a jax.profiler trace of the command into "
                        "DIR (view with TensorBoard/Perfetto)")
    return p


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)

    if args.command == "import-atlas":
        # pure file operation — no config, no accelerator
        if not (args.template and args.atlas):
            print("import-atlas requires --template and --atlas",
                  file=sys.stderr)
            return 2
        from subcort_tpu.registration.atlas import (AtlasValidationError,
                                                    install_atlas)
        try:
            dest = install_atlas(args.template, args.atlas,
                                 dest_dir=args.atlas_dir)
        except AtlasValidationError as e:
            print(f"atlas validation failed: {e}", file=sys.stderr)
            return 1
        print(f"--> atlas assets installed into {dest}")
        return 0

    from subcort_tpu.config import load_options, print_options, select_platform

    options = load_options(args.config)
    if args.intensity_augment is not None:
        options["intensity_augment"] = args.intensity_augment
    select_platform(options)  # must precede first backend init

    # multi-host launch (SUBCORT_NUM_PROCESSES>1): join the coordination
    # service before the backend initializes; single-process is a no-op.
    # segment_folder then shards the subject list per host (SURVEY §2.5).
    from subcort_tpu.parallel.distributed import initialize
    initialize()

    from subcort_tpu.utils import enable_compilation_cache, enable_nan_checks
    enable_compilation_cache()
    if options.bool("debug_nans"):
        enable_nan_checks()

    from subcort_tpu.engine import SegmentationEngine, Trainer, build_training_index
    from subcort_tpu.models.importer import load_theano_checkpoint

    if options["net_verbose"]:
        print_options(options)

    if args.command == "evaluate":
        # per-subject Dice of written segmentations against the GT masks
        # (the reference reports this offline in its paper; here it's a
        # first-class subcommand)
        import json

        import numpy as np

        from subcort_tpu.engine import load_test_names
        from subcort_tpu.engine.metrics import dice_per_class, mean_dice
        from subcort_tpu.io import load_nii

        t1_names, subjects = load_test_names(options)
        seg_name = ("out_subcortical_seg_prec.nii.gz"
                    if options.bool("post_process")
                    else "out_subcortical_rawseg.nii.gz")
        all_means = []
        for path, sub in zip(t1_names, subjects):
            d = os.path.dirname(path)
            seg_p = os.path.join(d, seg_name)
            gt_p = os.path.join(d, options["roi_name"])
            if not (os.path.exists(seg_p) and os.path.exists(gt_p)):
                print(json.dumps({"subject": sub, "skipped": True}))
                continue
            seg = np.asarray(load_nii(seg_p).data)
            gt = np.asarray(load_nii(gt_p).data).astype(np.int32)
            gt = np.where(gt == 15, 0, gt)  # boundary-bg is background
            per = dice_per_class(seg, gt)
            m = mean_dice(seg, gt)
            all_means.append(m)
            print(json.dumps({"subject": sub, "mean_dice": round(m, 4),
                              "per_class": {k: round(v, 4)
                                            for k, v in per.items()}}))
        if all_means:
            print(json.dumps({"cohort_mean_dice":
                              round(float(np.mean(all_means)), 4),
                              "n_subjects": len(all_means)}))
        return 0

    if args.command == "loo":
        # leave-one-out protocol (reference base.py:14-15: the data is
        # loaded once for all folds; the fold loop itself was left to the
        # user — here it's a subcommand emitting one JSON line per fold)
        import json

        from subcort_tpu.engine.loo import run_loo

        folds = ([f.strip() for f in args.folds.split(",") if f.strip()]
                 if args.folds else None)
        summary = run_loo(options, weights_path=args.weights_path,
                          folds=folds, augment=args.augment)
        for name, rec in summary["folds"].items():
            print(json.dumps({"fold": name, **rec}))
        print(json.dumps({"loo_mean_dice": summary["mean_dice"],
                          "n_folds": len(summary["folds"])}))
        return 0

    from subcort_tpu.utils import profile_trace

    with profile_trace(args.profile):
        if args.command in ("train", "run"):
            print("--> loading training data")
            index = build_training_index(options)
            trainer = Trainer(options, weights_path=args.weights_path,
                              augment=args.augment)
            print("--> training")
            trainer.fit(index)
            params = trainer.params
        else:
            ckpt = os.path.join(args.weights_path, options["experiment"],
                                options["experiment"] + ".pkl")
            print("--> loading weights from", ckpt)
            params = load_theano_checkpoint(ckpt)

        if args.command in ("infer", "run"):
            engine = SegmentationEngine(params, options)
            times = engine.segment_folder()
            for sub, minutes in times.items():
                print(f"--> scan {sub} segmented in {minutes:.2f} min")
    return 0


if __name__ == "__main__":
    sys.exit(main())
