"""Training data engine (layer L3/L5).

Reference counterparts: ``load_data`` / ``load_patches`` /
``load_patch_vectors`` / ``generate_training_set`` (cnn_cort/base.py:11-117,
120-256). The reference materializes every training patch on the host
(3 views x {image,label} x {pos,neg} numpy slicing) and ships patch tensors
to the device per batch. This design keeps *volumes* resident in device
memory and gathers patches on device inside the jitted train step:

    TrainingIndex = stacked normalized volumes (S, X, Y, Z)
                  + centers (N, 4) [subject, x, y, z]
                  + center labels (N,)  (class 15 remapped to 0)
                  + atlas vectors (N, 15)

Sampling semantics preserved (base.py:120-184): positives are all voxels
with 0 < GT < 15; negatives are boundary-background voxels (GT == 15),
subsampled to the positive count per subject (``balance_neg``); labels are
the *center voxel* class of the label patch (y[:, p//2, p//2],
base.py:85) — which is exactly the GT class at the center. All randomness
uses explicit PRNG (fixes SURVEY.md §2.3-8).

A reference-compatible ``generate_training_set`` facade (host patch
tensors) is kept for API parity and differential tests.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from subcort_tpu.config import Options
from subcort_tpu.io import load_nii
from subcort_tpu.ops import (balanced_negative_sample, get_mask_voxels,
                             normalize_nonzero, shuffle_consistent)
from subcort_tpu.ops.patches import HALF, gather_triplanar_np

BG_BOUNDARY_CLASS = 15  # GT convention: boundary-background voxels


@dataclasses.dataclass
class Subject:
    name: str
    t1_path: str
    roi_path: str
    prior_path: str  # tmp/MNI_sub_probabilities.nii.gz


def _configured_register(register_masks, options: Options):
    """Bind the cfg-selected registration backend/cost ([tpu] reg_backend /
    reg_similarity) onto ``register_masks`` (reference: base.py:483-551 has
    no knobs — NiftyReg NMI is hardwired there)."""
    def run(path: str) -> float:
        return register_masks(path,
                              backend=options["reg_backend"],
                              similarity=options["reg_similarity"])
    return run


def list_training_subjects(options: Options) -> List[Subject]:
    """Enumerate sorted subject subfolders of the train folder
    (base.py:143-149 conventions)."""
    d = options["train_folder"]
    subs = [f for f in sorted(os.listdir(d)) if os.path.isdir(os.path.join(d, f))]
    return [Subject(
        name=s,
        t1_path=os.path.join(d, s, options["t1_name"]),
        roi_path=os.path.join(d, s, options["roi_name"]),
        prior_path=os.path.join(d, s, "tmp", "MNI_sub_probabilities.nii.gz"),
    ) for s in subs]


@dataclasses.dataclass
class TrainingIndex:
    """Device-ready training set: volumes + center index, not patches."""
    volumes: np.ndarray       # (S, X, Y, Z) float32, normalized, *padded by HALF*
    centers: np.ndarray       # (N, 4) int32: subject, x, y, z (original coords)
    labels: np.ndarray        # (N,) int32 in [0, 14]
    atlas: np.ndarray         # (N, 15) float32
    subject_names: list

    def __len__(self):
        return self.centers.shape[0]


def _subject_samples(labels_vol: np.ndarray, rng: np.random.Generator,
                     balance_neg: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Per-subject sampled centers + center-voxel labels."""
    pos = get_mask_voxels(np.logical_and(labels_vol > 0,
                                         labels_vol < BG_BOUNDARY_CLASS))
    if balance_neg:
        neg = balanced_negative_sample(labels_vol, pos.shape[0],
                                       neg_class=BG_BOUNDARY_CLASS, rng=rng)
    else:
        neg = get_mask_voxels(labels_vol == BG_BOUNDARY_CLASS)
    centers = np.concatenate([pos, neg], axis=0)
    y = labels_vol[centers[:, 0], centers[:, 1], centers[:, 2]].astype(np.int32)
    y[y == BG_BOUNDARY_CLASS] = 0  # base.py:89
    return centers, y


def leave_one_out(subjects: Sequence[Subject], held_out: str):
    """Split subjects for the reference's leave-one-out protocol
    (load_data's docstring, base.py:14-15: data loaded once, per-fold
    training sets built per held-out scan). Returns (train_subjects,
    held_out_subject)."""
    train = [s for s in subjects if s.name != held_out]
    out = [s for s in subjects if s.name == held_out]
    if not out:
        raise ValueError(f"no subject named {held_out!r}")
    return train, out[0]


def build_training_index(options: Options,
                         subjects: Optional[Sequence[Subject]] = None,
                         register_fn=None,
                         rng: Optional[np.random.Generator] = None,
                         randomize: Optional[bool] = None,
                         exclude_subject: Optional[str] = None) -> TrainingIndex:
    """Load all subjects, sample balanced centers, gather atlas vectors.

    The volumes are normalized (nonzero stats) and pre-padded by HALF so the
    train step's device gather needs no per-batch padding. Shapes may differ
    across subjects; all are zero-padded up to the max extent.
    """
    if rng is None:
        rng = np.random.default_rng(options["seed"])
    if subjects is None:
        subjects = list_training_subjects(options)
    if exclude_subject is not None:
        subjects, _ = leave_one_out(subjects, exclude_subject)
    if randomize is None:
        randomize = bool(options["randomize_train"])
    if not subjects:
        raise ValueError(f"no training subjects in {options['train_folder']!r}")

    vols, all_centers, all_labels, all_atlas = [], [], [], []
    for si, sub in enumerate(subjects):
        t1 = load_nii(sub.t1_path).data
        gt = np.asarray(load_nii(sub.roi_path).data).astype(np.int32)
        norm, _, _ = normalize_nonzero(t1)
        centers, y = _subject_samples(gt, rng)

        if not os.path.exists(sub.prior_path):
            if register_fn is None:
                from subcort_tpu.registration import register_masks
                register_fn = _configured_register(register_masks, options)
            register_fn(sub.t1_path)
        prior = np.asarray(load_nii(sub.prior_path).data, dtype=np.float32)
        vec = prior[centers[:, 0], centers[:, 1], centers[:, 2]].copy()
        empty = vec.sum(axis=1) == 0
        vec[empty] = 0.0
        vec[empty, 14] = 1.0  # per-sample bg fix-up (base.py:392-394 semantics)

        vols.append(norm)
        all_centers.append(np.concatenate(
            [np.full((centers.shape[0], 1), si, np.int32), centers], axis=1))
        all_labels.append(y)
        all_atlas.append(vec)

    # pad volumes to common extent + HALF halo on every side
    xm = max(v.shape[0] for v in vols)
    ym = max(v.shape[1] for v in vols)
    zm = max(v.shape[2] for v in vols)
    stack = np.zeros((len(vols), xm + 2 * HALF, ym + 2 * HALF, zm + 2 * HALF),
                     np.float32)
    for i, v in enumerate(vols):
        stack[i, HALF:HALF + v.shape[0], HALF:HALF + v.shape[1],
              HALF:HALF + v.shape[2]] = v

    centers = np.concatenate(all_centers, axis=0)
    labels = np.concatenate(all_labels, axis=0)
    atlas = np.concatenate(all_atlas, axis=0).astype(np.float32)

    if randomize:
        centers, labels, atlas = shuffle_consistent([centers, labels, atlas], rng)

    if options.bool("debug"):
        print("    --> X_TRAIN:", len(labels))
        print("    --> Y_TRAIN POS:", int((labels > 0).sum()))
        print("    --> Y_TRAIN NEG:", int((labels == 0).sum()))

    return TrainingIndex(volumes=stack, centers=centers, labels=labels,
                         atlas=atlas, subject_names=[s.name for s in subjects])


# ------------------------------------------------------- reference-compat facade
def generate_training_set(index: TrainingIndex, patch: int = 2 * HALF):
    """Materialize host patch tensors from a TrainingIndex — the reference's
    ``generate_training_set`` output contract (base.py:53-117):
    (x_axial, x_cor, x_sag, x_atlas, y) with x_* shaped (N, 1, p, p).

    Exists for API parity and differential testing; the train loop never
    calls it (patches are gathered on device).
    """
    n = len(index)
    ax = np.empty((n, patch, patch), np.float32)
    co = np.empty((n, patch, patch), np.float32)
    sa = np.empty((n, patch, patch), np.float32)
    for si in range(index.volumes.shape[0]):
        m = index.centers[:, 0] == si
        if not m.any():
            continue
        # volumes are pre-padded by HALF: strip the halo for the numpy twin,
        # which pads internally.
        vol = index.volumes[si, HALF:-HALF, HALF:-HALF, HALF:-HALF]
        a, c, s = gather_triplanar_np(vol, index.centers[m, 1:4], patch)
        ax[m], co[m], sa[m] = a, c, s
    return (ax[:, None], co[:, None], sa[:, None], index.atlas.copy(),
            index.labels.copy())


def load_data(options: Options, register_fn=None):
    """Reference facade (base.py:11-37): one call loading the whole training
    folder into patch tensors. Returns (x_axial, x_cor, x_sag, x_atlas, y,
    names)."""
    index = build_training_index(options, register_fn=register_fn)
    ax, co, sa, atlas, y = generate_training_set(index)
    return ax, co, sa, atlas, y, index.subject_names
