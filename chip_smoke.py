#!/usr/bin/env python
"""Smoke run of the main path on an NVIDIA GPU, through the user's entry
points, at full model width and MNI scale (181 x 217 x 181).

Phases, each printing its results as one JSON line:

  device    the card, its power limit, jax/jaxlib, XLA_FLAGS, compile cache
  register  ``register_masks(backend="jax")`` on a subject with an empty
            tmp/ (jax affine + NMI FFD + prior warp on the card); warped-prior
            Dice against the phantom's known ground truth, min det(J), peak
            device memory. It runs first so the peak is its own.
  infer     ``cli infer`` with the default options (FCN engine, crop,
            post-process, labels), then with out_probabilities = True, then
            with compute_dtype = bfloat16; per-scan wall time
  train     ``cli train`` for one epoch on two subjects at batch_size 256
  compare   the same scan against the repo's plain references: the patch
            engine (XLA gather, Precision.HIGHEST) and the pure-numpy
            Lasagne oracle on 256 seeded candidate voxels, both with the
            seeded weights; the bf16 profile against f32 with the weights the
            train phase wrote; one jitted train step on the card against the
            same step on the host CPU

The weights are ``init_params`` from ``--seed`` at the published widths,
exported as a reference-format pickle and loaded through the checkpoint
path. The data is the synthetic phantom cohort of registration/atlas.py.

``--four-cards`` runs only the multi-card path and its one-card reference:
one train step on a fixed batch sharded over 4 cards against the same step
on one (loss and update within 1e-4 relative), ``cli train`` with
data_parallel = 4 against data_parallel = 1 (same global batch; epoch
losses reported), and ``segment_volume(devices=4 cards)`` for the SPMD FCN
and the sharded patch engine, labels bit-equal to one card.

Any failed check raises, so the script exits non-zero and never prints the
final line. Without a GPU it exits non-zero before any phase. The last line
of a passing run is

  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Usage:
    python chip_smoke.py [--seed N] [--workdir DIR] [--four-cards]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

REPO = os.path.dirname(os.path.abspath(__file__))
MNI_SHAPE = (181, 217, 181)
ORACLE_VOXELS = 256

# the floors the repo already holds each path to (README "Quality gates",
# CLAUDE.md "Invariants")
FCN_VS_PATCH_MIN = 0.9999
BF16_MIN = 0.999
TRAIN_LOSS_RTOL = 1e-4
REG_DICE_MIN = 0.93
REG_MIN_JAC = 0.05
SGD_LR = 1e-3
HISTORY_KEYS = ("epoch", "train_loss", "valid_loss", "valid_accuracy",
                "train_loss_best", "valid_loss_best", "valid_accuracy_best",
                "dur")


def report(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


class _Tee(io.TextIOBase):
    """Copies writes to the real stdout and keeps them for parsing."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.out.write(s)
        self.buf.write(s)
        return len(s)

    def flush(self):
        self.out.flush()


def run_cli(argv) -> str:
    """``subcort_tpu.cli.main`` in this process (a second JAX process could
    not get the card's memory); returns what it printed."""
    from subcort_tpu.cli import main as cli_main

    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        rc = cli_main(list(argv))
    check(rc == 0, f"cli {argv[0]} returned {rc}")
    return tee.buf.getvalue()


def write_cfg(ctx, name: str, tpu=None, **model) -> str:
    """A configuration.cfg over the cohort with [model] ``model`` and
    [tpu] ``tpu`` keys."""
    lines = ["[database]", f"train_folder = {ctx.cohort}",
             f"inference_folder = {ctx.cohort}", "t1_name = T1.nii.gz",
             "roi_name = gt_15_classes.nii.gz", "", "[model]",
             f"name = {name}", "mode = cuda"]
    lines += [f"{k} = {v}" for k, v in model.items()]
    lines += ["", "[tpu]", f"seed = {ctx.seed}"]
    lines += [f"{k} = {v}" for k, v in (tpu or {}).items()]
    path = os.path.join(ctx.work, f"{name}.cfg")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def peak_bytes(dev):
    """Peak device memory in use so far; None where the backend keeps no
    memory statistics."""
    stats = dev.memory_stats()
    return stats and stats.get("peak_bytes_in_use")


# ------------------------------------------------------------------ phases
def phase_device(n_cards: int):
    import jax
    import jaxlib

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) != n_cards:
        raise SystemExit(f"chip_smoke: needs {n_cards} NVIDIA GPU(s), "
                         f"JAX found {devs}")
    from subcort_tpu.utils import enable_compilation_cache
    enable_compilation_cache()
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    for line in cards.splitlines():
        print(line)
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    report("device", **info, cards=cards.splitlines(), jax=jax.__version__,
           jaxlib=jaxlib.__version__,
           xla_flags=os.environ.get("XLA_FLAGS", ""),
           compile_cache=jax.config.jax_compilation_cache_dir)
    return info, cards.splitlines()


def make_data(ctx, register: bool = True) -> None:
    """Seeded phantom cohort (two subjects with priors), with ``register``
    one more subject with an empty tmp/, and the exported seeded weights."""
    import jax
    import numpy as np

    from subcort_tpu.models import init_params
    from subcort_tpu.models.importer import save_theano_checkpoint
    from subcort_tpu.registration.atlas import make_synthetic_cohort

    t0 = time.perf_counter()
    ctx.atlas_dir = os.path.join(ctx.work, "atlases")
    os.environ["SUBCORT_ATLAS_DIR"] = ctx.atlas_dir
    ctx.cohort = os.path.join(ctx.work, "cohort")
    ctx.subjects = make_synthetic_cohort(ctx.cohort, n_subjects=2,
                                         shape=ctx.shape, seed=ctx.seed,
                                         atlas_dir=ctx.atlas_dir)
    if register:
        ctx.reg_subject = make_synthetic_cohort(
            os.path.join(ctx.work, "register"), n_subjects=1,
            shape=ctx.shape, seed=ctx.seed, atlas_dir=ctx.atlas_dir,
            write_priors=False)[0]
    ctx.weights = os.path.join(ctx.work, "nets")
    ctx.pkl = os.path.join(ctx.weights, "smoke", "smoke.pkl")
    os.makedirs(os.path.dirname(ctx.pkl), exist_ok=True)
    save_theano_checkpoint(jax.tree_util.tree_map(
        np.asarray, init_params(jax.random.key(ctx.seed))), ctx.pkl)
    report("data", shape=list(ctx.shape), subjects=len(ctx.subjects),
           seconds=time.perf_counter() - t0)


def phase_register(ctx) -> None:
    import jax
    import numpy as np

    from subcort_tpu.io import load_nii
    from subcort_tpu.registration import load_cpp_grid, register_masks
    from subcort_tpu.registration.jax_ffd import jacobian_stats

    t1 = os.path.join(ctx.reg_subject, "T1.nii.gz")
    tmp = os.path.join(ctx.reg_subject, "tmp")
    check(not os.listdir(tmp), "registration subject's tmp/ is not empty")
    seconds = register_masks(t1, backend="jax", similarity="nmi")
    peak = peak_bytes(jax.devices()[0])
    img = load_nii(t1)
    priors = np.asarray(load_nii(
        os.path.join(tmp, "MNI_sub_probabilities.nii.gz")).data)
    gt = np.asarray(load_nii(
        os.path.join(ctx.reg_subject, "gt_15_classes.nii.gz")).data)
    dices = []
    for s in range(14):
        p, g = priors[..., s] > 0.5, gt == s + 1
        denom = int(p.sum()) + int(g.sum())
        dices.append(2.0 * int((p & g).sum()) / denom if denom else 0.0)
    dice = float(np.mean(dices))
    jac = jacobian_stats(load_cpp_grid(os.path.join(tmp, "transform.nii"),
                                       img.affine), img.shape)
    report("register", backend="jax", similarity="nmi",
           seconds_with_compile=seconds, dice=dice, dice_min=REG_DICE_MIN,
           min_jac=jac["min_jac"], min_jac_floor=REG_MIN_JAC,
           peak_device_bytes=peak, card=ctx.cards)
    check(dice >= REG_DICE_MIN, f"registration Dice {dice} < {REG_DICE_MIN}")
    check(jac["min_jac"] > REG_MIN_JAC,
          f"registration min det(J) {jac['min_jac']} <= {REG_MIN_JAC}")


def _scan_stats(printed: str) -> list:
    return [json.loads(l) for l in printed.splitlines()
            if l.startswith('{"scan"')]


def phase_infer(ctx) -> None:
    import numpy as np

    from subcort_tpu.io import load_nii

    def infer(tag, **model):
        cfg = write_cfg(ctx, "smoke", **model)
        t0 = time.perf_counter()
        stats = _scan_stats(run_cli(["infer", "--config", cfg,
                                     "--weights-path", ctx.weights]))
        wall = time.perf_counter() - t0
        check(len(stats) == len(ctx.subjects), f"{tag}: missing scan stats")
        for sub in ctx.subjects:
            seg = np.asarray(load_nii(os.path.join(
                sub, "out_subcortical_seg_prec.nii.gz")).data)
            check(seg.shape == ctx.shape, f"{tag}: seg shape {seg.shape}")
            classes = np.unique(seg[seg > 0])
            check(classes.size >= 2, f"{tag}: trivial labels {classes}")
        # the first scan in the folder pays the compiles; the next is warm
        report("infer", config=tag, seconds=wall,
               candidate_voxels=stats[-1]["candidate_voxels"],
               cold_scan_seconds=stats[0]["wall_seconds"],
               warm_scan_seconds=stats[-1]["wall_seconds"],
               label_classes=int(classes.size), card=ctx.cards)
        return stats

    infer("labels")
    infer("probs", out_probabilities="True")
    for sub in ctx.subjects:
        prob = np.asarray(load_nii(os.path.join(
            sub, "out_subcortical_prob.nii.gz")).data)
        check(prob.shape == ctx.shape + (15,), f"prob shape {prob.shape}")
        check(bool(np.isfinite(prob).all()), "non-finite probabilities")
        s = prob.sum(-1)
        s = s[s > 0]
        check(s.size > 0 and float(np.abs(s - 1).max()) < 0.05,
              "probability maps do not sum to 1")
    infer("bf16", tpu={"compute_dtype": "bfloat16"})


def _scan(ctx):
    """The first subject's T1, priors and candidate voxels."""
    import numpy as np

    from subcort_tpu.config import Options
    from subcort_tpu.engine.infer import candidate_centers
    from subcort_tpu.io import load_nii

    sub = ctx.subjects[0]
    image = np.asarray(load_nii(os.path.join(sub, "T1.nii.gz")).data)
    atlas = np.asarray(load_nii(os.path.join(
        sub, "tmp", "MNI_sub_probabilities.nii.gz")).data, np.float32)
    mask = load_nii(os.path.join(sub, "tmp",
                                 "MNI_subcortical_mask.nii.gz")).data
    return image, atlas, candidate_centers(image, Options(), mask)


def phase_compare(ctx) -> None:
    import jax
    import numpy as np

    from subcort_tpu.engine.infer import segment_volume
    from subcort_tpu.models import load_theano_checkpoint
    from subcort_tpu.ops import normalize_nonzero
    from subcort_tpu.ops.patches import gather_triplanar_np

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import lasagne_oracle as oracle

    image, atlas, centers = _scan(ctx)
    sel = tuple(centers.T)
    params = load_theano_checkpoint(ctx.pkl)

    fcn, _ = segment_volume(params, image, atlas, centers, engine="fcn")
    patch, _ = segment_volume(params, image, atlas, centers, engine="patch")
    fcn_vs_patch = float((fcn[sel] == patch[sel]).mean())
    # bf16 against f32 with the trained weights: the seeded net's outputs
    # are near-uniform over the 15 classes, so bf16 rounding flips its
    # near-ties, which a trained net does not have
    trained = load_theano_checkpoint(os.path.join(
        ctx.weights, "smoke_train", "smoke_train.pkl"))
    f32_t, _ = segment_volume(trained, image, atlas, centers, engine="fcn")
    bf16_t, _ = segment_volume(trained, image, atlas, centers, engine="fcn",
                               compute_dtype="bfloat16")
    bf16_agree = float((f32_t[sel] == bf16_t[sel]).mean())

    rng = np.random.default_rng(ctx.seed)
    pick = centers[rng.choice(len(centers), ORACLE_VOXELS, replace=False)]
    norm, _, _ = normalize_nonzero(image)
    ax, co, sa = gather_triplanar_np(norm, pick)
    vec = atlas[tuple(pick.T)].copy()
    empty = vec.sum(1) == 0
    vec[empty] = 0.0
    vec[empty, 14] = 1.0
    want = oracle.forward(oracle.load_raw(ctx.pkl), ax[:, None], co[:, None],
                          sa[:, None], vec).argmax(1)
    oracle_agree = float((fcn[tuple(pick.T)] == want).mean())

    # one train step, card against host CPU, on a fixed batch of the cohort
    cpu = jax.devices("cpu")[0]
    step = _fixed_step(ctx)
    (gpu_loss, gpu_p), (cpu_loss, cpu_p) = step(jax.devices()[0]), step(cpu)
    loss_rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)

    report("compare", candidate_voxels=int(len(centers)),
           fcn_vs_patch_agreement=fcn_vs_patch,
           fcn_vs_patch_min=FCN_VS_PATCH_MIN,
           oracle_agreement=oracle_agree, oracle_voxels=ORACLE_VOXELS,
           bf16_agreement=bf16_agree, bf16_min=BF16_MIN,
           train_step_loss_gpu=gpu_loss, train_step_loss_cpu=cpu_loss,
           train_step_loss_rel_diff=loss_rel, train_step_rtol=TRAIN_LOSS_RTOL,
           train_step_update_rel_diff=_update_rel_diff(ctx, cpu_p, gpu_p))
    check(fcn_vs_patch >= FCN_VS_PATCH_MIN,
          f"FCN vs patch agreement {fcn_vs_patch} < {FCN_VS_PATCH_MIN}")
    check(oracle_agree == 1.0, f"oracle agreement {oracle_agree} != 1.0")
    check(bf16_agree >= BF16_MIN, f"bf16 agreement {bf16_agree} < {BF16_MIN}")
    check(loss_rel <= TRAIN_LOSS_RTOL,
          f"train step GPU vs CPU loss rel diff {loss_rel} > {TRAIN_LOSS_RTOL}")


def _fixed_step(ctx, batch_size: int = 256):
    """One jitted ``make_train_step`` on the cohort's first ``batch_size``
    samples from the seeded weights. Returns ``run(where)`` -> (loss, new
    params as numpy), where ``where`` is a device or a mesh (batch sharded
    over ``'data'``, volumes and weights replicated). The optimizer is
    plain SGD, so the update is the gradient times the learning rate."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from subcort_tpu.config import Options
    from subcort_tpu.engine import build_training_index
    from subcort_tpu.engine.train import TRAIN_SPEC, make_train_step
    from subcort_tpu.models import load_theano_checkpoint
    from subcort_tpu.parallel import replicated, shard_batch

    index = build_training_index(Options(train_folder=ctx.cohort,
                                         debug=False, seed=ctx.seed))
    batch = {"centers": index.centers[:batch_size],
             "labels": index.labels[:batch_size].astype(np.int32),
             "atlas": index.atlas[:batch_size]}
    opt = optax.sgd(SGD_LR)
    step = make_train_step(opt, TRAIN_SPEC)
    p0 = jax.tree_util.tree_map(jnp.asarray, load_theano_checkpoint(
        ctx.pkl, TRAIN_SPEC))

    def run(where):
        if isinstance(where, jax.sharding.Mesh):
            rep = replicated(where)
            p, st, vols = jax.device_put((p0, opt.init(p0), index.volumes), rep)
            b = shard_batch(batch, where)
        else:
            p, st, vols, b = jax.device_put(
                (p0, opt.init(p0), index.volumes, batch), where)
        new_p, _, loss = step(p, st, vols, b["centers"], b["labels"],
                              b["atlas"], jax.random.key(ctx.seed))
        return float(loss), jax.tree_util.tree_map(np.asarray, new_p)

    return run


def _update_rel_diff(ctx, ref, got) -> float:
    """||update(got) - update(ref)|| / ||update(ref)|| over all weights,
    each update taken from the seeded weights."""
    import jax
    import numpy as np

    from subcort_tpu.engine.train import TRAIN_SPEC
    from subcort_tpu.models import load_theano_checkpoint

    p0 = jax.tree_util.tree_leaves(load_theano_checkpoint(ctx.pkl, TRAIN_SPEC))
    d_ref = np.concatenate([(r - p).ravel() for r, p in
                            zip(jax.tree_util.tree_leaves(ref), p0)])
    d_got = np.concatenate([(g - p).ravel() for g, p in
                            zip(jax.tree_util.tree_leaves(got), p0)])
    return float(np.linalg.norm(d_got - d_ref) / np.linalg.norm(d_ref))


def _train_epoch(ctx, name: str, batch_size: int, data_parallel: int) -> dict:
    cfg = write_cfg(ctx, name, batch_size=batch_size,
                    max_epochs=1, load_weights="False", net_verbose=1,
                    debug="False", tpu={"data_parallel": data_parallel})
    t0 = time.perf_counter()
    run_cli(["train", "--config", cfg, "--weights-path", ctx.weights])
    wall = time.perf_counter() - t0
    exp = os.path.join(ctx.weights, name)
    with open(os.path.join(exp, f"{name}_history.jsonl")) as fh:
        hist = [json.loads(l) for l in fh if l.strip()]
    check(len(hist) == 1, f"{name}: {len(hist)} history lines, want 1")
    rec = hist[0]
    missing = [k for k in HISTORY_KEYS if k not in rec]
    check(not missing, f"{name}: history lacks {missing}")
    check(all(abs(rec[k]) < float("inf") for k in ("train_loss", "valid_loss")),
          f"{name}: non-finite loss {rec}")
    check(os.path.exists(os.path.join(exp, f"{name}.pkl")),
          f"{name}: best-only checkpoint not written")
    return {**rec, "seconds": wall}


def phase_train(ctx) -> None:
    rec = _train_epoch(ctx, "smoke_train", 256, 1)
    report("train", batch_size=256, epoch_seconds=rec["dur"],
           train_loss=rec["train_loss"], valid_loss=rec["valid_loss"],
           valid_accuracy=rec["valid_accuracy"], seconds=rec["seconds"],
           card=ctx.cards)


def phase_four_cards(ctx) -> None:
    import jax
    import numpy as np

    from subcort_tpu.engine.infer import segment_volume
    from subcort_tpu.models import load_theano_checkpoint
    from subcort_tpu.parallel import make_mesh

    devs = jax.devices()
    # one step on a fixed batch: the batch sharded over the cards (BN
    # statistics and gradients all-reduced) against the whole batch on one
    step = _fixed_step(ctx)
    one_step, four_step = step(devs[0]), step(make_mesh(len(devs)))
    step_loss_rel = abs(four_step[0] - one_step[0]) / abs(one_step[0])
    update_rel = _update_rel_diff(ctx, one_step[1], four_step[1])

    # the user's path: one `cli train` epoch. data_parallel = 4 splits each
    # step's batch over the cards, so a per-card batch_size of 64 gives the
    # same global batch of 256. Reported, not held to 1e-4: Adam turns the
    # reduction-order rounding of near-zero gradients into O(lr) updates,
    # so the two runs drift apart step by step.
    one = _train_epoch(ctx, "smoke_dp1", 256, 1)
    four = _train_epoch(ctx, "smoke_dp4", 256 // len(devs), len(devs))
    epoch_rel = {k: abs(four[k] - one[k]) / abs(one[k])
                 for k in ("train_loss", "valid_loss")}

    image, atlas, centers = _scan(ctx)
    params = load_theano_checkpoint(ctx.pkl)
    equal = {}
    for engine in ("fcn", "patch"):
        lab1, _ = segment_volume(params, image, atlas, centers, engine=engine)
        labn, _ = segment_volume(params, image, atlas, centers, engine=engine,
                                 devices=devs)
        equal[engine] = bool(np.array_equal(lab1, labn))
    report("four_cards", cards=ctx.cards, step_loss_1=one_step[0],
           step_loss_4=four_step[0], step_loss_rel_diff=step_loss_rel,
           step_update_rel_diff=update_rel, rtol=TRAIN_LOSS_RTOL,
           epoch_train_loss_1=one["train_loss"],
           epoch_train_loss_4=four["train_loss"],
           epoch_valid_loss_1=one["valid_loss"],
           epoch_valid_loss_4=four["valid_loss"], epoch_loss_rel_diff=epoch_rel,
           epoch_seconds_1=one["dur"], epoch_seconds_4=four["dur"],
           fcn_spmd_labels_equal=equal["fcn"],
           patch_sharded_labels_equal=equal["patch"],
           candidate_voxels=int(len(centers)))
    check(step_loss_rel <= TRAIN_LOSS_RTOL,
          f"4 vs 1 card step loss rel diff {step_loss_rel} > {TRAIN_LOSS_RTOL}")
    check(update_rel <= TRAIN_LOSS_RTOL,
          f"4 vs 1 card step update rel diff {update_rel} > {TRAIN_LOSS_RTOL}")
    check(all(equal.values()), f"multi-card labels differ: {equal}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=None,
                    help="data and outputs (default: a temporary directory, "
                         "removed at the end)")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card path and its one-card "
                         "reference")
    args = ap.parse_args(argv)

    # the GPU, plus the host CPU for the compare phase's reference step
    plats = os.environ.get("JAX_PLATFORMS") or "cuda"
    if "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    sys.path.insert(0, REPO)

    device, cards = phase_device(4 if args.four_cards else 1)
    work = args.workdir or tempfile.mkdtemp(prefix="chip_smoke_")
    os.makedirs(work, exist_ok=True)
    ctx = types.SimpleNamespace(work=work, seed=args.seed, shape=MNI_SHAPE,
                                cards=cards)
    try:
        t0 = time.perf_counter()
        make_data(ctx, register=not args.four_cards)
        phases = ([phase_four_cards] if args.four_cards else
                  [phase_register, phase_infer, phase_train, phase_compare])
        for phase in phases:
            t = time.perf_counter()
            phase(ctx)
            report("timing", of=phase.__name__[len("phase_"):],
                   seconds=time.perf_counter() - t, card=cards)
        report("timing", of="total", seconds=time.perf_counter() - t0,
               card=cards)
    finally:
        if args.workdir is None:
            shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
