"""CLI surface tests: argument parsing and the evaluate subcommand
(the heavier train/infer/run flows are driven end-to-end on the GPU by
chip_smoke.py)."""

import json

import numpy as np
import pytest

from subcort_tpu.cli import _build_parser, main
from subcort_tpu.io import NiftiImage, save_nii

CFG = """\
[database]
train_folder = {root}
inference_folder = {root}
t1_name = T1.nii.gz
roi_name = gt_15_classes.nii.gz
save_tmp = True

[model]
name = cli_v1
mode = cpu
patch_size = 32
batch_size = 128
patience = 5
net_verbose = 0
max_epochs = 1
train_split = 0.25
test_batch_size = 1000
load_weights = False
out_probabilities = False
speedup_segmentation = True
post_process = True
debug = False
"""


def test_parser_contract():
    p = _build_parser()
    a = p.parse_args(["run", "--config", "x.cfg", "--augment"])
    assert a.command == "run" and a.config == "x.cfg" and a.augment
    with pytest.raises(SystemExit):
        p.parse_args(["bogus"])


def test_evaluate_subcommand(tmp_path, rng, capsys):
    sub = tmp_path / "s01"
    sub.mkdir()
    gt = np.zeros((16, 16, 16), np.uint8)
    gt[4:9, 4:9, 4:9] = 3
    gt[10:12, 10:12, 10:12] = 15  # boundary bg -> treated as background
    seg = np.zeros_like(gt)
    seg[4:9, 4:9, 4:9] = 3        # perfect for class 3
    save_nii(NiftiImage(np.ones((16, 16, 16), np.float32)), str(sub / "T1.nii.gz"))
    save_nii(NiftiImage(gt), str(sub / "gt_15_classes.nii.gz"))
    save_nii(NiftiImage(seg), str(sub / "out_subcortical_seg_prec.nii.gz"))

    cfg = tmp_path / "configuration.cfg"
    cfg.write_text(CFG.format(root=tmp_path))
    rc = main(["evaluate", "--config", str(cfg)])
    assert rc == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    per_subject = [l for l in lines if l.get("subject") == "s01"]
    assert per_subject and per_subject[0]["mean_dice"] == 1.0
    cohort = [l for l in lines if "cohort_mean_dice" in l]
    assert cohort and cohort[0]["n_subjects"] == 1


def test_evaluate_rawseg_and_skip(tmp_path, rng, capsys):
    """post_process=False reads out_subcortical_rawseg.nii.gz; subjects
    without a segmentation are reported as skipped, imperfect overlap gives
    fractional Dice, and the cohort line averages only scored subjects."""
    for name in ("s01", "s02"):
        sub = tmp_path / name
        sub.mkdir()
        save_nii(NiftiImage(np.ones((16, 16, 16), np.float32)),
                 str(sub / "T1.nii.gz"))
    gt = np.zeros((16, 16, 16), np.uint8)
    gt[4:8, 4:8, 4:8] = 2          # 64 voxels of class 2
    seg = np.zeros_like(gt)
    seg[4:8, 4:8, 4:6] = 2         # 32 of them -> Dice 2*32/(64+32) = 2/3
    save_nii(NiftiImage(gt), str(tmp_path / "s01" / "gt_15_classes.nii.gz"))
    save_nii(NiftiImage(seg),
             str(tmp_path / "s01" / "out_subcortical_rawseg.nii.gz"))
    save_nii(NiftiImage(gt), str(tmp_path / "s02" / "gt_15_classes.nii.gz"))
    # s02 has GT but no segmentation -> skipped

    cfg = tmp_path / "configuration.cfg"
    cfg.write_text(CFG.format(root=tmp_path).replace(
        "post_process = True", "post_process = False"))
    rc = main(["evaluate", "--config", str(cfg)])
    assert rc == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    s01 = next(l for l in lines if l.get("subject") == "s01")
    assert s01["mean_dice"] == pytest.approx(2 / 3, abs=1e-3)
    assert s01["per_class"]["2"] == pytest.approx(2 / 3, abs=1e-3)
    s02 = next(l for l in lines if l.get("subject") == "s02")
    assert s02.get("skipped") is True
    cohort = next(l for l in lines if "cohort_mean_dice" in l)
    assert cohort["n_subjects"] == 1
    assert cohort["cohort_mean_dice"] == pytest.approx(2 / 3, abs=1e-3)
