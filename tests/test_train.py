"""Training-stack tests: data engine, split semantics, trainer protocol,
checkpoint/resume, data-parallel mesh execution."""

import json
import os

import numpy as np
import pytest

import jax

from subcort_tpu.config import Options
from subcort_tpu.engine import (Trainer, TrainingIndex, build_training_index,
                                generate_training_set, load_data,
                                train_split_stratified)
from subcort_tpu.io import NiftiImage, save_nii
from subcort_tpu.models.triplanar import TriPlanarSpec


# a tiny spec keeps CPU-test compile+train time sane while exercising the
# identical code path (patch 24 is the smallest the conv stack admits:
# 24->20->10->6->3->1, branch_flat 60)
TINY = TriPlanarSpec(patch_size=24)


def _make_dataset(tmp_path, rng, n_subjects=2, shape=(24, 26, 22)):
    for i in range(n_subjects):
        sub = tmp_path / f"s{i:02d}"
        (sub / "tmp").mkdir(parents=True)
        img = (rng.random(shape) * 500 + 50).astype(np.float32)
        gt = np.zeros(shape, np.uint8)
        gt[8:14, 9:15, 8:13] = rng.integers(1, 15, (6, 6, 5))  # structures
        gt[2:22, 2:24, 2:6] = 15                                # boundary bg (plenty)
        atlas = rng.random(shape + (15,)).astype(np.float32)
        atlas /= atlas.sum(-1, keepdims=True)
        save_nii(NiftiImage(img), str(sub / "T1.nii.gz"))
        save_nii(NiftiImage(gt), str(sub / "gt_15_classes.nii.gz"))
        save_nii(NiftiImage(atlas), str(sub / "tmp" / "MNI_sub_probabilities.nii.gz"))
    return Options(train_folder=str(tmp_path), debug=False, seed=11)


def test_build_training_index(tmp_path, rng):
    opts = _make_dataset(tmp_path, rng)
    idx = build_training_index(opts)
    assert idx.volumes.shape[0] == 2
    assert idx.centers.shape[1] == 4
    assert len(idx) == idx.labels.shape[0] == idx.atlas.shape[0]
    # balanced: positives == negatives per construction
    assert (idx.labels > 0).sum() == (idx.labels == 0).sum()
    # 15 never appears (remapped to 0, base.py:89)
    assert idx.labels.max() <= 14
    # atlas vectors sum to ~1 (normalized synthetic priors)
    np.testing.assert_allclose(idx.atlas.sum(1), 1.0, atol=1e-4)


def test_build_training_index_deterministic(tmp_path, rng):
    opts = _make_dataset(tmp_path, rng)
    i1 = build_training_index(opts, rng=np.random.default_rng(5))
    i2 = build_training_index(opts, rng=np.random.default_rng(5))
    np.testing.assert_array_equal(i1.centers, i2.centers)
    np.testing.assert_array_equal(i1.labels, i2.labels)


def test_generate_training_set_reference_contract(tmp_path, rng):
    opts = _make_dataset(tmp_path, rng)
    ax, co, sa, atlas, y, names = load_data(opts)
    n = y.shape[0]
    assert ax.shape == (n, 1, 32, 32) == co.shape == sa.shape
    assert atlas.shape == (n, 15)
    assert names == ["s00", "s01"]
    # center pixel of the x-patch equals the normalized image at the center:
    # gather parity is covered in test_ops; here check dtype contract
    assert ax.dtype == np.float32 and y.dtype == np.int32


def test_train_split_stratified():
    labels = np.repeat(np.arange(4), 20)
    tr, va = train_split_stratified(labels, 0.25)
    assert len(tr) + len(va) == 80
    assert len(va) == 20
    for c in range(4):
        assert (labels[va] == c).sum() == 5  # stratified
    tr0, va0 = train_split_stratified(labels, 0.0)
    assert len(va0) == 0 and len(tr0) == 80


def _tiny_index(rng, n=96, s=2, extent=20):
    half = TINY.patch_size // 2
    vols = rng.standard_normal(
        (s, extent + 2 * half, extent + 2 * half, extent + 2 * half)
    ).astype(np.float32)
    centers = np.stack([
        rng.integers(0, s, n),
        rng.integers(0, extent, n),
        rng.integers(0, extent, n),
        rng.integers(0, extent, n)], axis=1).astype(np.int32)
    labels = rng.integers(0, 15, n).astype(np.int32)
    atlas = rng.random((n, 15)).astype(np.float32)
    return TrainingIndex(vols, centers, labels, atlas, [f"s{i}" for i in range(s)])


def test_trainer_epoch_protocol(tmp_path, rng):
    opts = Options(experiment="exp1", batch_size=16, max_epochs=3, patience=10,
                   train_split=0.25, net_verbose=0, load_weights=False, seed=3)
    tr = Trainer(opts, spec=TINY, weights_path=str(tmp_path / "nets"))
    idx = _tiny_index(rng)
    hist = tr.fit(idx)
    assert len(hist) == 3
    for k in ("epoch", "train_loss", "valid_loss", "valid_accuracy",
              "train_loss_best", "valid_loss_best", "valid_accuracy_best", "dur"):
        assert k in hist[0]
    assert np.isfinite(hist[-1]["train_loss"])
    # best-only weights + state + jsonl history exist
    assert os.path.exists(str(tmp_path / "nets" / "exp1" / "exp1.pkl"))
    assert os.path.exists(str(tmp_path / "nets" / "exp1" / "exp1_state.pkl"))
    lines = open(str(tmp_path / "nets" / "exp1" / "exp1_history.jsonl")).read().splitlines()
    assert len(lines) == 3 and json.loads(lines[0])["epoch"] == 1


def test_trainer_loss_decreases(tmp_path, rng):
    opts = Options(experiment="exp2", batch_size=32, max_epochs=8, patience=20,
                   train_split=0.25, net_verbose=0, load_weights=False, seed=4)
    tr = Trainer(opts, spec=TINY, weights_path=str(tmp_path / "nets"))
    idx = _tiny_index(rng, n=256)
    # learnable rule: label = 3 iff atlas channel 3 dominant, else 0
    idx.labels[:] = np.where(idx.atlas.argmax(1) == 3, 3, 0)
    hist = tr.fit(idx)
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]


def test_trainer_early_stopping(tmp_path, rng):
    opts = Options(experiment="exp3", batch_size=16, max_epochs=50, patience=2,
                   train_split=0.25, net_verbose=0, load_weights=False, seed=5)
    tr = Trainer(opts, spec=TINY, weights_path=str(tmp_path / "nets"))
    idx = _tiny_index(rng)  # random labels: validation won't keep improving
    hist = tr.fit(idx)
    assert len(hist) < 50
    assert hist[-1]["epoch"] >= tr.best_epoch + 2


def test_trainer_resume(tmp_path, rng):
    opts = Options(experiment="exp4", batch_size=16, max_epochs=2, patience=10,
                   train_split=0.25, net_verbose=0, load_weights=False, seed=6)
    tr = Trainer(opts, spec=TINY, weights_path=str(tmp_path / "nets"))
    idx = _tiny_index(rng)
    tr.fit(idx)

    opts2 = Options(**{**opts.asdict(), "load_weights": True, "max_epochs": 4})
    tr2 = Trainer(opts2, spec=TINY, weights_path=str(tmp_path / "nets"))
    assert tr2.epoch == 2  # resumed
    hist = tr2.fit(idx)
    assert hist[-1]["epoch"] == 4
    lines = open(str(tmp_path / "nets" / "exp4" / "exp4_history.jsonl")).read().splitlines()
    assert len(lines) == 4


def test_trainer_data_parallel_mesh(tmp_path, rng):
    """DP over the 8-device CPU mesh: same code path as several GPUs."""
    assert len(jax.devices()) == 8
    opts = Options(experiment="exp5", batch_size=8, max_epochs=2, patience=10,
                   train_split=0.25, net_verbose=0, load_weights=False,
                   seed=7, data_parallel=8)
    tr = Trainer(opts, spec=TINY, weights_path=str(tmp_path / "nets"))
    assert tr.mesh.devices.size == 8
    idx = _tiny_index(rng, n=320)
    hist = tr.fit(idx)
    assert len(hist) == 2 and np.isfinite(hist[-1]["train_loss"])


def test_train_step_mesh_matches_single_device(rng):
    """One full-width train step with the batch sharded over the 8-device
    mesh (BN statistics and gradients all-reduced) against the same step on
    one device: the loss, and the SGD update (the gradient times the
    learning rate), agree up to reduction order."""
    import optax

    from subcort_tpu.engine.train import TRAIN_SPEC, make_train_step
    from subcort_tpu.models import init_params
    from subcort_tpu.parallel import make_mesh, replicated, shard_batch

    half = TRAIN_SPEC.patch_size // 2
    vols = rng.standard_normal((2,) + (20 + 2 * half,) * 3).astype(np.float32)
    n = 64
    batch = {"centers": np.stack([rng.integers(0, 2, n)] +
                                 [rng.integers(0, 20, n) for _ in range(3)],
                                 axis=1).astype(np.int32),
             "labels": rng.integers(0, 15, n).astype(np.int32),
             "atlas": rng.random((n, 15)).astype(np.float32)}
    opt = optax.sgd(1e-3)
    step = make_train_step(opt, TRAIN_SPEC)
    p0 = init_params(jax.random.key(3))

    def run(ndev):
        mesh = make_mesh(ndev)
        p, st, v = jax.device_put((p0, opt.init(p0), vols), replicated(mesh))
        b = shard_batch(batch, mesh)
        new, _, loss = step(p, st, v, b["centers"], b["labels"], b["atlas"],
                            jax.random.key(4))
        delta = [np.asarray(x) - np.asarray(x0) for x, x0 in
                 zip(jax.tree_util.tree_leaves(new),
                     jax.tree_util.tree_leaves(p0))]
        return float(loss), np.concatenate([d.ravel() for d in delta])

    loss1, d1 = run(1)
    loss8, d8 = run(8)
    assert np.isclose(loss8, loss1, rtol=1e-5)
    assert np.linalg.norm(d8 - d1) <= 1e-4 * np.linalg.norm(d1)


def test_augmentation_path_runs(tmp_path, rng):
    opts = Options(experiment="exp6", batch_size=16, max_epochs=1, patience=5,
                   train_split=0.25, net_verbose=0, load_weights=False, seed=8)
    tr = Trainer(opts, spec=TINY, weights_path=str(tmp_path / "nets"),
                 augment=True)
    hist = tr.fit(_tiny_index(rng))
    assert np.isfinite(hist[0]["train_loss"])


def test_augmentation_matches_reference_transform(rng):
    """Differential pin of _augment_views against a numpy reimplementation
    of the reference's Rotate_batch_Iterator.transform
    (/root/reference/cnn_cort/nets.py:46-124):

    - the transform set, in stack order, is [rotate_180, rotate_0_flipped,
      rotate_180_flipped] built by the reference's literal compositions
      (rotate_90 = x[:,:,::-1,:].transpose(0,1,3,2) applied twice, then
      [..., ::-1] flips) — reimplemented verbatim below, NOT simplified, so
      any drift in our kernel's slicing fails against the true semantics;
    - selection is the SAME exactly-half uniform subset for all three views
      (np.random.choice(bs, bs/2, replace=False), nets.py:52);
    - the choice index r is drawn independently PER VIEW (nets.py:72-78
      draws fresh r_indices for in1/in2/in3).

    The device draws (subset + per-view r) are mirrored by re-deriving the
    jax.random split structure, so the comparison is bitwise.
    """
    import jax
    import jax.numpy as jnp

    from subcort_tpu.engine.train import _augment_views

    b, p = 64, 8
    ax = rng.standard_normal((b, p, p)).astype(np.float32)
    co = rng.standard_normal((b, p, p)).astype(np.float32)
    sa = rng.standard_normal((b, p, p)).astype(np.float32)
    key = jax.random.key(123)

    got = [np.asarray(v) for v in
           _augment_views(key, jnp.asarray(ax), jnp.asarray(co),
                          jnp.asarray(sa))]

    # mirror the device RNG derivation (pins the split structure)
    k_sel, k1, k2, k3 = jax.random.split(key, 4)
    selected = np.asarray(jax.random.permutation(k_sel, jnp.arange(b)) < b // 2)
    rs = [np.asarray(jax.random.randint(k, (b,), 0, 3)) for k in (k1, k2, k3)]

    # exactly-half selection law (nets.py:52: bs/2 without replacement)
    assert int(selected.sum()) == b // 2

    # per-view independence: three independent r draws must differ somewhere
    assert not (np.array_equal(rs[0], rs[1]) and np.array_equal(rs[1], rs[2]))

    def reference_transform_stack(x):
        """nets.py:60-72 verbatim on an (N, 1, h, w) batch."""
        rotate_90 = x[:, :, ::-1, :].transpose(0, 1, 3, 2)
        rotate_180 = rotate_90[:, :, ::-1, :].transpose(0, 1, 3, 2)
        rotate_0_flipped = x[:, :, :, ::-1]
        rotate_180_flipped = rotate_180[:, :, :, ::-1]
        return np.stack([rotate_180, rotate_0_flipped, rotate_180_flipped],
                        axis=1)

    for view, out, r in zip((ax, co, sa), got, rs):
        x = view[:, None]  # reference layout (N, 1, h, w)
        augmented = reference_transform_stack(x)
        expect = x.copy()
        idx = np.flatnonzero(selected)
        expect[idx] = np.stack([augmented[i, r[i]] for i in idx])
        np.testing.assert_array_equal(out, expect[:, 0])
        # unselected rows untouched
        np.testing.assert_array_equal(out[~selected], view[~selected])


def test_intensity_augmentation_semantics(rng):
    """Behavioral pin of _augment_intensity (the [tpu] intensity_augment
    knob, no reference analogue — default-off keeps training
    reference-exact): the transform must be a per-sample affine
    (gain*view + shift) plus per-voxel noise, with gain/shift SHARED across
    the three views (they sample the same volume at the same center) and
    noise drawn independently per view; strength 0.0 is the exact identity;
    draws stay inside the documented bounds."""
    import jax
    import jax.numpy as jnp

    from subcort_tpu.engine.train import _augment_intensity

    b, p = 32, 8
    views = [rng.standard_normal((b, p, p)).astype(np.float32)
             for _ in range(3)]
    jviews = [jnp.asarray(v) for v in views]
    key = jax.random.key(9)

    # strength 0 is the identity (the knob-off contract)
    for o, v in zip(_augment_intensity(key, *jviews, 0.0), views):
        np.testing.assert_array_equal(np.asarray(o), v)

    got = [np.asarray(v) for v in _augment_intensity(key, *jviews, 1.0)]
    # determinism under a fixed key
    got_again = [np.asarray(v) for v in _augment_intensity(key, *jviews, 1.0)]
    for a, b_ in zip(got, got_again):
        np.testing.assert_array_equal(a, b_)

    # shifting every input by +1 with the SAME key isolates the gain
    # exactly: out(v+1) - out(v) = gain (noise/shift cancel)
    got_p1 = [np.asarray(v)
              for v in _augment_intensity(key, *(v + 1.0 for v in jviews), 1.0)]
    gains = []
    for o1, o2 in zip(got, got_p1):
        g = o2 - o1
        # constant per sample over all voxels -> a true per-sample scalar
        gm = g.mean(axis=(1, 2), keepdims=True)
        np.testing.assert_allclose(g, np.broadcast_to(gm, g.shape),
                                   rtol=0, atol=1e-5)
        gains.append(gm[:, 0, 0])
    # gain shared across the three views, inside U(0.75, 1.25)
    np.testing.assert_allclose(gains[0], gains[1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(gains[0], gains[2], rtol=0, atol=1e-6)
    assert gains[0].min() >= 0.75 - 1e-5 and gains[0].max() <= 1.25 + 1e-5
    assert gains[0].std() > 0.01  # actually randomized

    # zero input isolates shift + sigma*noise; pixel means approximate the
    # shared shift (|shift| <= 0.2, sigma <= 0.15 over 64 pixels -> sem
    # ~0.019), and the per-view noise must differ between views
    zeros = [jnp.zeros((b, p, p), jnp.float32)] * 3
    res = [np.asarray(v) for v in _augment_intensity(key, *zeros, 1.0)]
    means = [r.mean(axis=(1, 2)) for r in res]
    np.testing.assert_allclose(means[0], means[1], rtol=0, atol=0.08)
    assert np.abs(means[0]).max() <= 0.2 + 0.08
    assert not np.array_equal(res[0], res[1])  # independent per-view noise
    assert max(r.std() for r in res) > 0.0  # noise actually applied


def test_intensity_augmentation_path_runs(tmp_path, rng):
    # the knob flows Options -> Trainer -> jitted step; loss stays finite
    opts = Options(experiment="exp_ia", batch_size=16, max_epochs=1,
                   patience=5, train_split=0.25, net_verbose=0,
                   load_weights=False, seed=8, intensity_augment=1.0)
    tr = Trainer(opts, spec=TINY, weights_path=str(tmp_path / "nets"))
    assert tr.intensity_augment == 1.0
    hist = tr.fit(_tiny_index(rng))
    assert np.isfinite(hist[0]["train_loss"])


def test_leave_one_out_split(tmp_path, rng):
    """Reference LOO protocol: per-fold training sets excluding one subject."""
    from subcort_tpu.engine import (build_training_index, leave_one_out,
                                    list_training_subjects)
    import pytest as _pytest

    opts = _make_dataset(tmp_path, rng)
    subjects = list_training_subjects(opts)
    train, held = leave_one_out(subjects, "s01")
    assert held.name == "s01" and [s.name for s in train] == ["s00"]
    with _pytest.raises(ValueError):
        leave_one_out(subjects, "nope")

    idx_full = build_training_index(opts)
    idx_loo = build_training_index(opts, exclude_subject="s01")
    assert idx_loo.subject_names == ["s00"]
    assert len(idx_loo) < len(idx_full)
    assert idx_loo.centers[:, 0].max() == 0  # only subject 0 present


def test_trainer_bfloat16_mixed_precision_step(tmp_path):
    """[tpu] train_dtype=bfloat16: forward/backward in bf16 with f32 master
    params — one step must run, keep params f32, and produce a finite loss
    close to the f32 step's."""
    import jax
    import jax.numpy as jnp
    import optax

    from subcort_tpu.engine.train import make_train_step
    from subcort_tpu.models import init_params

    rng = np.random.default_rng(0)
    volumes = rng.standard_normal((2, 24 + 32, 24 + 32, 24 + 32)).astype(np.float32)
    b = 16
    centers = np.stack([rng.integers(0, 2, b)] +
                       [rng.integers(0, 24, b) for _ in range(3)], 1).astype(np.int32)
    labels = rng.integers(0, 15, b).astype(np.int32)
    atlas = rng.random((b, 15)).astype(np.float32)

    params = init_params(jax.random.key(0))
    opt = optax.adam(1e-3)

    outs = {}
    for name, cd in (("f32", None), ("bf16", "bfloat16")):
        step = make_train_step(opt, compute_dtype=cd)
        p, o, loss = step(params, opt.init(params), jnp.asarray(volumes),
                          jnp.asarray(centers), jnp.asarray(labels),
                          jnp.asarray(atlas), jax.random.key(1))
        outs[name] = (p, float(loss))
        # master params stay f32 regardless of compute dtype
        assert jax.tree_util.tree_leaves(p)[0].dtype == jnp.float32

    assert np.isfinite(outs["bf16"][1])
    assert abs(outs["bf16"][1] - outs["f32"][1]) < 0.1 * max(outs["f32"][1], 1.0)
