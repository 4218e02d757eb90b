"""Data-engine kernel tests (SURVEY.md §4: unit tests per L3 kernel).

The gather kernels are checked against a literal numpy re-implementation of
the reference's ``get_patches`` semantics (base.py:272-308): per-axis pad of
(half, size-half), per-center slice ``[c - half, c + size - half)``, squeeze
of the singleton view axis.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from subcort_tpu.ops import (balanced_negative_sample, gather_atlas_vectors,
                             gather_triplanar, get_mask_voxels,
                             normalize_nonzero, pad_volume, shuffle_consistent)
from subcort_tpu.ops.patches import gather_triplanar_np


def ref_patches(image, centers, psize=32, mode="axial"):
    """Independent re-implementation of reference get_patches semantics."""
    if mode == "axial":
        patch = (psize, psize, 1)
    elif mode == "coronal":
        patch = (psize, 1, psize)
    else:
        patch = (1, psize, psize)
    half = tuple(p // 2 for p in patch)
    padding = tuple((h, p - h) for h, p in zip(half, patch))
    padded = np.pad(image, padding, mode="constant")
    out = []
    for c in centers:
        nc = [ci + hi for ci, hi in zip(c, half)]
        sl = tuple(slice(n - h, n + (p - h)) for n, h, p in zip(nc, half, patch))
        out.append(np.squeeze(padded[sl]))
    return np.stack(out)


@pytest.fixture()
def volume(rng):
    return rng.standard_normal((40, 36, 28)).astype(np.float32)


def _centers(rng, vol, n=50):
    return np.stack([rng.integers(0, s, n) for s in vol.shape], axis=1).astype(np.int32)


def test_gather_matches_reference_semantics(volume, rng):
    centers = _centers(rng, volume)
    ax, co, sa = gather_triplanar(pad_volume(volume), centers)
    np.testing.assert_array_equal(np.asarray(ax), ref_patches(volume, centers, mode="axial"))
    np.testing.assert_array_equal(np.asarray(co), ref_patches(volume, centers, mode="coronal"))
    np.testing.assert_array_equal(np.asarray(sa), ref_patches(volume, centers, mode="saggital"))


def test_gather_border_centers_zero_padded(volume):
    centers = np.array([[0, 0, 0],
                        [39, 35, 27],
                        [0, 35, 13]], dtype=np.int32)
    ax, co, sa = gather_triplanar(pad_volume(volume), centers)
    np.testing.assert_array_equal(np.asarray(ax), ref_patches(volume, centers, mode="axial"))
    np.testing.assert_array_equal(np.asarray(co), ref_patches(volume, centers, mode="coronal"))
    np.testing.assert_array_equal(np.asarray(sa), ref_patches(volume, centers, mode="saggital"))
    # the corner patch must be mostly zeros (outside the volume)
    a0 = np.asarray(ax)[0]
    assert (a0[:16, :] == 0).all() and (a0[:, :16] == 0).all()


def test_numpy_twin_matches_jax(volume, rng):
    centers = _centers(rng, volume, 20)
    jax_out = gather_triplanar(pad_volume(volume), centers)
    np_out = gather_triplanar_np(volume, centers)
    for a, b in zip(jax_out, np_out):
        np.testing.assert_array_equal(np.asarray(a), b)


def _gather_case(case, rng):
    """(volumes (S, X, Y, Z), centers (N, 4) with the subject index first)."""
    if case == "interior":
        vols = rng.standard_normal((1, 40, 36, 28)).astype(np.float32)
        n = 64
    elif case == "border":
        vols = rng.standard_normal((1, 34, 33, 35)).astype(np.float32)
        corners = np.asarray([[0, 0, 0], [33, 32, 34], [0, 32, 17],
                              [33, 0, 0]], np.int32)
        return vols, np.concatenate([np.zeros((4, 1), np.int32), corners], 1)
    else:  # multi_subject
        vols = rng.standard_normal((3, 30, 26, 22)).astype(np.float32)
        n = 96
    shape = vols.shape[1:]
    centers = np.stack([rng.integers(0, vols.shape[0], n)] +
                       [rng.integers(0, s, n) for s in shape],
                       axis=1).astype(np.int32)
    return vols, centers


@pytest.mark.parametrize("case", ["interior", "border", "multi_subject"])
def test_gathers_match_numpy_twin(case, rng):
    """The inference gather (ops.patches.gather_triplanar, one padded
    volume) and the training gather (engine.train.gather_triplanar_subjects,
    a stack of padded volumes) against the host numpy twin, center by
    center, bit-exact."""
    from subcort_tpu.engine.train import gather_triplanar_subjects

    vols, centers = _gather_case(case, rng)
    want = [np.empty((len(centers), 32, 32), np.float32) for _ in range(3)]
    for s in range(vols.shape[0]):
        rows = centers[:, 0] == s
        if not rows.any():
            continue
        for w, g in zip(want, gather_triplanar_np(vols[s], centers[rows, 1:])):
            w[rows] = g
        got = gather_triplanar(pad_volume(jnp.asarray(vols[s])),
                               jnp.asarray(centers[rows, 1:]))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(g), w[rows])
    padded = jnp.stack([pad_volume(jnp.asarray(v)) for v in vols])
    got = gather_triplanar_subjects(padded, jnp.asarray(centers))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(g), w)


def test_atlas_gather_and_bg_fixup(rng):
    atlas = rng.random((10, 10, 10, 15)).astype(np.float32)
    atlas[3, 4, 5, :] = 0.0  # a voxel with no prior mass
    centers = np.array([[3, 4, 5], [1, 1, 1]], dtype=np.int32)
    vec = np.asarray(gather_atlas_vectors(atlas, centers))
    # base.py:392-394: empty prior -> background channel (14) = 1
    assert vec[0, 14] == 1.0 and vec[0, :14].sum() == 0.0
    np.testing.assert_array_equal(vec[1], atlas[1, 1, 1])


def test_normalize_nonzero_semantics(rng):
    vol = rng.integers(0, 1000, (20, 20, 20)).astype(np.int16)
    vol[:5] = 0
    out, mean, std = normalize_nonzero(vol)
    nz = vol[vol != 0]
    assert mean == pytest.approx(nz.mean(), rel=1e-12)
    assert std == pytest.approx(nz.std(), rel=1e-12)
    # zero voxels are included in the output (become -mean/std)
    np.testing.assert_allclose(out[:5], -mean / std, rtol=1e-5)
    assert out.dtype == np.float32


def test_normalize_rejects_degenerate():
    with pytest.raises(ValueError):
        normalize_nonzero(np.zeros((4, 4, 4)))
    with pytest.raises(ValueError):
        normalize_nonzero(np.full((4, 4, 4), 7.0))


def test_get_mask_voxels_order_and_sampling(rng):
    mask = np.zeros((6, 5, 4), dtype=np.uint8)
    mask[1, 2, 3] = 1
    mask[4, 0, 2] = 1
    mask[1, 0, 0] = 1
    idx = get_mask_voxels(mask)
    np.testing.assert_array_equal(idx, np.stack(np.nonzero(mask), axis=1))
    sub = get_mask_voxels(mask, size=2, rng=np.random.default_rng(0))
    assert sub.shape == (2, 3)
    sub2 = get_mask_voxels(mask, size=2, rng=np.random.default_rng(0))
    np.testing.assert_array_equal(sub, sub2)  # explicit PRNG => reproducible


def test_balanced_negative_sample(rng):
    labels = np.zeros((12, 12, 12), dtype=np.uint8)
    labels[2:6, 2:6, 2:6] = 15
    neg = balanced_negative_sample(labels, 10, rng=np.random.default_rng(1))
    assert neg.shape == (10, 3)
    assert (labels[neg[:, 0], neg[:, 1], neg[:, 2]] == 15).all()


def test_shuffle_consistent(rng):
    a = np.arange(10)
    b = np.arange(10) * 2.0
    sa, sb = shuffle_consistent([a, b], np.random.default_rng(3))
    np.testing.assert_array_equal(sb, sa * 2.0)
    with pytest.raises(ValueError):
        shuffle_consistent([a, b[:5]], np.random.default_rng(3))


