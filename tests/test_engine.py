"""End-to-end inference-engine tests on synthetic NIfTI phantoms
(SURVEY.md §4: pipeline tests without real data)."""

import os

import numpy as np
import pytest

import jax

from subcort_tpu.config import Options
from subcort_tpu.engine import (SegmentationEngine, load_test_names,
                                post_process_segmentation, segment_volume,
                                test_scan)
from subcort_tpu.io import NiftiImage, load_nii, save_nii
from subcort_tpu.models import init_params, load_theano_checkpoint, predict
from subcort_tpu.ops import normalize_nonzero
from subcort_tpu.ops.patches import gather_triplanar_np


@pytest.fixture(scope="module")
def params():
    return init_params(jax.random.key(7))


@pytest.fixture()
def phantom(rng):
    """Synthetic T1 + prior atlas + atlas mask."""
    image = (rng.random((36, 40, 32)) * 800 + 100).astype(np.float32)
    image[:4] = 0  # background border
    atlas = rng.random((36, 40, 32, 15)).astype(np.float32)
    atlas /= atlas.sum(axis=-1, keepdims=True)
    mask = np.zeros((36, 40, 32), np.uint8)
    mask[12:24, 14:28, 10:22] = 1
    return image, atlas, mask


def _slow_labels(params, image, atlas, centers):
    """Host-side slow path: numpy gather + jitted forward, no scan/scatter."""
    norm, _, _ = normalize_nonzero(image)
    ax, co, sa = gather_triplanar_np(norm, centers)
    vec = atlas[centers[:, 0], centers[:, 1], centers[:, 2]].copy()
    empty = vec.sum(1) == 0
    vec[empty] = 0
    vec[empty, 14] = 1
    y = predict(params, {"axial": ax, "coronal": co, "sagittal": sa,
                         "atlas": vec})
    return np.asarray(y).astype(np.uint8)


def test_segment_volume_matches_slow_path(params, phantom, rng):
    image, atlas, _ = phantom
    centers = np.stack([rng.integers(0, s, 300) for s in image.shape],
                       axis=1).astype(np.int32)
    centers = np.unique(centers, axis=0)
    label_vol, prob_vol = segment_volume(params, image, atlas, centers,
                                         want_probs=True, chunk=128)
    want = _slow_labels(params, image, atlas, centers)
    got = label_vol[centers[:, 0], centers[:, 1], centers[:, 2]]
    np.testing.assert_array_equal(got, want)
    # voxels never requested stay background
    untouched = np.ones(image.shape, bool)
    untouched[centers[:, 0], centers[:, 1], centers[:, 2]] = False
    assert label_vol[untouched].sum() == 0
    # prob volume: rows at centers sum to 1 (default readback is the uint8
    # fixed-point wire, so sums carry up to 15 half-steps of 1/255)
    pr = prob_vol[centers[:, 0], centers[:, 1], centers[:, 2]]
    np.testing.assert_allclose(pr.sum(1), 1.0, atol=15 * 0.5 / 255)
    # and exactly with a float32 readback
    _, pv32 = segment_volume(params, image, atlas, centers,
                             want_probs=True, chunk=128,
                             probs_dtype=np.float32)
    pr32 = pv32[centers[:, 0], centers[:, 1], centers[:, 2]]
    np.testing.assert_allclose(pr32.sum(1), 1.0, atol=1e-4)


def test_segment_volume_empty_candidates(params, phantom):
    """Zero candidate voxels (e.g. an empty dilated atlas mask after a
    degenerate registration) must yield all-zero outputs like the
    reference's zero-batch generator (base.py:379-380,414-417), for every
    engine — not crash on the empty bbox."""
    image, atlas, _ = phantom
    centers = np.zeros((0, 3), np.int32)
    for eng in ("auto", "fcn", "patch"):
        lv, pv = segment_volume(params, image, atlas, centers,
                                want_probs=True, engine=eng)
        assert lv.shape == image.shape and lv.sum() == 0
        assert pv.shape == image.shape + (15,) and pv.sum() == 0


def test_test_scan_empty_mask_contract(params, phantom, tmp_path):
    """A subject whose atlas mask is empty still gets the reference's
    output files (all-background) through the full test_scan path."""
    image, atlas, _ = phantom
    empty_mask = np.zeros(image.shape, np.uint8)
    sub = _write_subject(tmp_path, "s_empty", image, atlas, empty_mask)
    opts = Options(test_folder=str(tmp_path), post_process=True,
                   out_probabilities=True, crop=True, debug=False,
                   net_verbose=0)
    minutes = test_scan(params, str(sub / "T1.nii.gz"), opts)
    assert minutes >= 0
    seg = load_nii(str(sub / "out_subcortical_seg_prec.nii.gz")).data
    prob = load_nii(str(sub / "out_subcortical_prob.nii.gz")).data
    assert seg.shape == image.shape and seg.sum() == 0
    assert prob.shape == image.shape + (15,) and prob.sum() == 0


def test_patch_engine_compile_bucketing(params, phantom, rng):
    """Differently-sized candidate sets in the same chunk-count ladder
    bucket (pow2 and 3·pow2/4 rungs — infer._round_up_pow2) must reuse the
    compiled program (each new shape is a compile)."""
    from subcort_tpu.engine.infer import _forward_centers

    image, atlas, _ = phantom
    def run(n):
        centers = np.unique(np.stack([rng.integers(0, s, n)
                                      for s in image.shape], 1).astype(np.int32),
                            axis=0)
        segment_volume(params, image, atlas, centers, engine="patch", chunk=64)

    run(300)   # ceil(~295/64)=5 chunks -> bucket 6
    before = _forward_centers._cache_size()
    run(370)   # ~6 chunks -> same bucket 6
    assert _forward_centers._cache_size() == before


def _write_subject(tmp_path, name, image, atlas, mask):
    sub = tmp_path / name
    (sub / "tmp").mkdir(parents=True)
    save_nii(NiftiImage(image), str(sub / "T1.nii.gz"))
    save_nii(NiftiImage(atlas), str(sub / "tmp" / "MNI_sub_probabilities.nii.gz"))
    save_nii(NiftiImage(mask), str(sub / "tmp" / "MNI_subcortical_mask.nii.gz"))
    return sub


def test_test_scan_file_contract(params, phantom, tmp_path):
    """Output filenames/shapes per base.py:445-455."""
    image, atlas, mask = phantom
    sub = _write_subject(tmp_path, "subj01", image, atlas, mask)
    opts = Options(post_process=True, out_probabilities=True, crop=True,
                   debug=False)
    minutes = test_scan(params, str(sub / "T1.nii.gz"), opts)
    assert minutes >= 0
    seg = load_nii(str(sub / "out_subcortical_seg_prec.nii.gz"))
    assert seg.shape == image.shape
    prob = load_nii(str(sub / "out_subcortical_prob.nii.gz"))
    assert prob.shape == image.shape + (15,)
    assert not os.path.exists(str(sub / "out_subcortical_rawseg.nii.gz"))


def test_test_scan_rawseg_when_no_postprocess(params, phantom, tmp_path):
    image, atlas, mask = phantom
    sub = _write_subject(tmp_path, "subj02", image, atlas, mask)
    opts = Options(post_process=False, out_probabilities=False, crop=False,
                   debug=False)
    test_scan(params, str(sub / "T1.nii.gz"), opts)
    raw = load_nii(str(sub / "out_subcortical_rawseg.nii.gz"))
    assert raw.shape == image.shape
    assert not os.path.exists(str(sub / "out_subcortical_seg_prec.nii.gz"))
    # crop=False classifies every nonzero voxel; zero-intensity border voxels
    # are never candidates
    assert raw.data[image == 0].sum() == 0


def test_engine_folder_sweep(params, phantom, tmp_path):
    image, atlas, mask = phantom
    _write_subject(tmp_path, "s1", image, atlas, mask)
    _write_subject(tmp_path, "s2", image, atlas, mask)
    opts = Options(test_folder=str(tmp_path), post_process=False,
                   out_probabilities=False, crop=True, debug=False)
    names, subjects = load_test_names(opts)
    assert subjects == ["s1", "s2"]
    engine = SegmentationEngine(params, opts)
    times = engine.segment_folder()
    assert set(times) == {"s1", "s2"}
    for s in subjects:
        assert os.path.exists(str(tmp_path / s / "out_subcortical_rawseg.nii.gz"))


def test_folder_sweep_pipelined_matches_serial(params, phantom, tmp_path):
    """The pipelined sweep (prefetch + async writeback, folder_pipeline=True
    default) must write bit-identical outputs to the serial sweep."""
    image, atlas, mask = phantom
    for mode in ("pipe", "serial"):
        root = tmp_path / mode
        root.mkdir()
        for s in ("s1", "s2", "s3"):
            _write_subject(root, s, image, atlas, mask)
        opts = Options(test_folder=str(root), post_process=True,
                       out_probabilities=True, crop=True, debug=False,
                       net_verbose=0, folder_pipeline=(mode == "pipe"))
        times = SegmentationEngine(params, opts).segment_folder()
        assert set(times) == {"s1", "s2", "s3"}
    for s in ("s1", "s2", "s3"):
        for f in ("out_subcortical_prob.nii.gz",
                  "out_subcortical_seg_prec.nii.gz"):
            a = load_nii(str(tmp_path / "pipe" / s / f)).data
            b = load_nii(str(tmp_path / "serial" / s / f)).data
            np.testing.assert_array_equal(a, b)


def test_folder_sweep_pipelined_surfaces_write_errors(params, phantom,
                                                      tmp_path, monkeypatch):
    """A failed async writeback must raise from segment_folder, not vanish
    in the writer thread."""
    image, atlas, mask = phantom
    for s in ("s1", "s2"):
        _write_subject(tmp_path, s, image, atlas, mask)
    opts = Options(test_folder=str(tmp_path), post_process=False,
                   out_probabilities=False, crop=True, debug=False,
                   net_verbose=0, folder_pipeline=True)
    import subcort_tpu.engine.infer as inf

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(inf, "save_nii", boom)
    with pytest.raises(OSError, match="disk full"):
        SegmentationEngine(params, opts).segment_folder()


def test_bounded_writer_backpressure_and_errors():
    """The pipelined sweep's write queue must never hold more than
    max_inflight deferred closures (each pins a scan's ~430 MB prob
    volume), and a failed write must surface at the next submit, not
    only at drain."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from subcort_tpu.engine.infer import _BoundedWriter

    gate = threading.Event()
    in_flight = []
    peak = []

    def slow_write():
        in_flight.append(1)
        peak.append(len(in_flight))
        gate.wait(5)
        in_flight.pop()

    with ThreadPoolExecutor(1) as pool:
        w = _BoundedWriter(pool, max_inflight=2)
        w.submit(slow_write)
        w.submit(slow_write)
        # queue is full: a third submit must block until one completes
        t = threading.Thread(target=w.submit, args=(slow_write,))
        t.start()
        t.join(0.3)
        assert t.is_alive(), "third submit should block at max_inflight=2"
        gate.set()
        t.join(5)
        assert not t.is_alive()
        w.drain()
    assert max(peak) <= 2  # single writer thread: sequential writes

    def boom():
        raise OSError("disk full")

    with ThreadPoolExecutor(1) as pool:
        w = _BoundedWriter(pool, max_inflight=1)
        w.submit(boom)
        with pytest.raises(OSError, match="disk full"):
            w.submit(boom)  # backpressure drains the failed oldest write
        w.futures.clear()


def test_folder_sweep_scan_error_surfaces_pending_writes(params, phantom,
                                                         tmp_path, capsys,
                                                         monkeypatch):
    """If a scan fails mid-sweep, queued write errors from earlier scans
    must be reported (not silently discarded) and the primary error
    re-raised."""
    image, atlas, mask = phantom
    for s in ("s1", "s2", "s3"):
        _write_subject(tmp_path, s, image, atlas, mask)
    opts = Options(test_folder=str(tmp_path), post_process=False,
                   out_probabilities=False, crop=True, debug=False,
                   net_verbose=0, folder_pipeline=True)
    import subcort_tpu.engine.infer as inf

    def bad_write(*a, **k):
        raise OSError("disk full")

    real_load = inf._load_scan_inputs
    calls = []

    def failing_load(path, *a, **k):
        calls.append(path)
        if "s3" in path:
            raise RuntimeError("registration exploded")
        return real_load(path, *a, **k)

    monkeypatch.setattr(inf, "save_nii", bad_write)
    monkeypatch.setattr(inf, "_load_scan_inputs", failing_load)
    with pytest.raises((RuntimeError, OSError)):
        SegmentationEngine(params, opts).segment_folder()


def test_segment_volume_fcn_matches_patch_engine(params, phantom, rng):
    """The dense (à-trous) engine and the patch engine must agree exactly
    on labels and probabilities at every candidate voxel."""
    image, atlas, mask = phantom
    centers = np.stack(np.nonzero(mask), axis=1).astype(np.int32)
    lv_p, pv_p = segment_volume(params, image, atlas, centers,
                                want_probs=True, chunk=256, engine="patch",
                                probs_dtype=np.float32)
    lv_f, pv_f = segment_volume(params, image, atlas, centers,
                                want_probs=True, engine="fcn",
                                prior_dtype=np.float32,
                                probs_dtype=np.float32)
    np.testing.assert_array_equal(lv_f, lv_p)
    sel = centers[:, 0], centers[:, 1], centers[:, 2]
    np.testing.assert_allclose(pv_f[sel], pv_p[sel], atol=2e-4, rtol=1e-3)

    # the default float16 prior transfer must stay >= 99.9% label-identical
    # (the north-star agreement tolerance, BASELINE.md)
    lv_h, _ = segment_volume(params, image, atlas, centers, engine="fcn")
    agree = (lv_h[sel] == lv_p[sel]).mean()
    assert agree >= 0.999


def test_segment_volume_bfloat16_agreement(params, phantom, rng):
    """compute_dtype='bfloat16' must stay >=99.9% label-identical to f32
    (the north-star agreement tolerance)."""
    image, atlas, mask = phantom
    centers = np.stack(np.nonzero(mask), axis=1).astype(np.int32)
    lv32, _ = segment_volume(params, image, atlas, centers, engine="fcn")
    lv16, _ = segment_volume(params, image, atlas, centers, engine="fcn",
                             compute_dtype="bfloat16")
    sel = centers[:, 0], centers[:, 1], centers[:, 2]
    assert (lv16[sel] == lv32[sel]).mean() >= 0.999


def test_segment_volume_fast_profile_agreement(params, phantom, rng):
    """The bench's fast profile (bfloat16 activations + uint8 prior
    transfer combined) must stay >=99.9% label-identical to the exact
    path (bench.py reports the same agreement on the chip)."""
    image, atlas, mask = phantom
    centers = np.stack(np.nonzero(mask), axis=1).astype(np.int32)
    lv32, _ = segment_volume(params, image, atlas, centers, engine="fcn")
    lvf, _ = segment_volume(params, image, atlas, centers, engine="fcn",
                            compute_dtype="bfloat16", prior_dtype=np.uint8)
    sel = centers[:, 0], centers[:, 1], centers[:, 2]
    assert (lvf[sel] == lv32[sel]).mean() >= 0.999


def test_segment_volume_fcn_bbox_splitting(params, phantom, rng):
    """Oversized bboxes are processed in sub-slabs; results must be
    identical to the unsplit evaluation (covers crop=False whole-volume)."""
    image, atlas, _ = phantom
    centers = np.stack(np.nonzero(image.astype(bool)), 1).astype(np.int32)
    lv_one, pv_one = segment_volume(params, image, atlas, centers,
                                    want_probs=True, engine="fcn",
                                    prior_dtype=np.float32,
                                    probs_dtype=np.float32)
    lv_split, pv_split = segment_volume(params, image, atlas, centers,
                                        want_probs=True, engine="fcn",
                                        prior_dtype=np.float32,
                                        probs_dtype=np.float32,
                                        fcn_max_bbox_voxels=5000)
    np.testing.assert_array_equal(lv_split, lv_one)
    sel = centers[:, 0], centers[:, 1], centers[:, 2]
    np.testing.assert_allclose(pv_split[sel], pv_one[sel], atol=1e-5)


# ------------------------------------------------------------------ postprocess
def test_postprocess_keeps_atlas_overlapping_component():
    vol = np.zeros((20, 20, 20), np.uint8)
    vol[2:5, 2:5, 2:5] = 1       # component A (far from atlas)
    vol[12:18, 12:18, 12:18] = 1  # component B (in atlas, larger)
    atlas = np.zeros_like(vol)
    atlas[10:20, 10:20, 10:20] = 1
    out = post_process_segmentation(None, vol, atlas_mask=atlas)
    assert (out[12:18, 12:18, 12:18] == 1).all()
    assert out[2:5, 2:5, 2:5].sum() == 0


def test_postprocess_no_overlap_keeps_largest():
    vol = np.zeros((20, 20, 20), np.uint8)
    vol[2:4, 2:4, 2:4] = 3
    vol[10:16, 10:16, 10:16] = 3
    atlas = np.zeros_like(vol)  # nothing overlaps
    out = post_process_segmentation(None, vol, atlas_mask=atlas)
    assert (out[10:16, 10:16, 10:16] == 3).all()
    assert out[2:4, 2:4, 2:4].sum() == 0


def test_postprocess_bugcompat_reproduces_reference_quirk():
    """SURVEY.md §2.3-7: with no atlas overlap the reference paints the
    background region (argmax lands on component 0)."""
    vol = np.zeros((10, 10, 10), np.uint8)
    vol[2:4, 2:4, 2:4] = 5
    atlas = np.zeros_like(vol)
    out = post_process_segmentation(None, vol, atlas_mask=atlas,
                                    bugcompat_argmax=True)
    # every class 1..14 in turn paints the background region (argmax -> 0),
    # so the last class (14) ends up everywhere — the reference's behavior.
    assert out[0, 0, 0] == 14
    assert (out == 14).all()
    # sane mode leaves the volume clean instead
    sane = post_process_segmentation(None, vol, atlas_mask=atlas)
    assert (sane[vol == 0] == 0).all()


def test_postprocess_absent_class_is_noop():
    vol = np.zeros((8, 8, 8), np.uint8)
    atlas = np.ones_like(vol)
    out = post_process_segmentation(None, vol, atlas_mask=atlas)
    assert out.sum() == 0


def test_outputs_preserve_input_affine(params, phantom, tmp_path):
    """Output NIfTIs must carry the input scan's affine (the reference
    passes t1_nii.affine through, base.py:446,451,454)."""
    image, atlas, mask = phantom
    affine = np.array([[-1.0, 0, 0, 90.0], [0, 1.2, 0, -126.0],
                       [0, 0, 1.1, -72.0], [0, 0, 0, 1.0]])
    sub = tmp_path / "aff01"
    (sub / "tmp").mkdir(parents=True)
    save_nii(NiftiImage(image, affine), str(sub / "T1.nii.gz"))
    save_nii(NiftiImage(atlas, affine), str(sub / "tmp" / "MNI_sub_probabilities.nii.gz"))
    save_nii(NiftiImage(mask, affine), str(sub / "tmp" / "MNI_subcortical_mask.nii.gz"))
    opts = Options(post_process=True, out_probabilities=True, crop=True,
                   debug=False, net_verbose=0)
    test_scan(params, str(sub / "T1.nii.gz"), opts)
    for f in ("out_subcortical_seg_prec.nii.gz", "out_subcortical_prob.nii.gz"):
        out = load_nii(str(sub / f))
        np.testing.assert_allclose(out.affine, affine, atol=1e-4)


def test_segment_volume_uint8_prior_agreement(params, phantom, rng):
    """The quantized (uint8) prior transfer must stay >=99.9%
    label-identical to the float32 path."""
    image, atlas, mask = phantom
    centers = np.stack(np.nonzero(mask), axis=1).astype(np.int32)
    lv32, _ = segment_volume(params, image, atlas, centers, engine="fcn",
                             prior_dtype=np.float32)
    lv8, _ = segment_volume(params, image, atlas, centers, engine="fcn",
                            prior_dtype=np.uint8)
    sel = centers[:, 0], centers[:, 1], centers[:, 2]
    assert (lv8[sel] == lv32[sel]).mean() >= 0.999


def test_segment_volume_uint16_prior_default_agreement(params, phantom, rng):
    """The default fixed-point uint16 prior wire (1/65535 steps — tighter
    than float16's ~1e-3 relative error) must be label-identical to the
    float32 path on the phantom."""
    image, atlas, mask = phantom
    centers = np.stack(np.nonzero(mask), axis=1).astype(np.int32)
    lv32, _ = segment_volume(params, image, atlas, centers, engine="fcn",
                             prior_dtype=np.float32)
    lv16, _ = segment_volume(params, image, atlas, centers, engine="fcn")
    sel = centers[:, 0], centers[:, 1], centers[:, 2]
    assert (lv16[sel] == lv32[sel]).mean() >= 0.9999


def test_bf16_xla_path_matches_cast_inside_semantics(params, phantom, rng):
    """The XLA-gather bf16 path ships the volume pre-cast (engine/infer.py);
    gather-then-cast must equal cast-then-gather, INCLUDING the prior
    vectors — the cast gate once keyed on the volume dtype and silently left
    priors f32 on the pre-cast path (r4 review fix, engine/forward.py)."""
    import jax.numpy as jnp

    from subcort_tpu.engine.forward import scan_forward_centers
    from subcort_tpu.ops import normalize_nonzero, pad_volume

    image, atlas, _ = phantom
    chunk = 64
    centers = np.stack([rng.integers(0, s, 2 * chunk) for s in image.shape],
                       axis=1).astype(np.int32)
    vecs = atlas[centers[:, 0], centers[:, 1], centers[:, 2]].astype(np.float32)
    norm, _, _ = normalize_nonzero(image)
    # segment_volume casts params to the compute dtype before dispatch
    params_bf16 = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.bfloat16), params)

    def run(vol_dtype):
        padded = pad_volume(jnp.asarray(norm.astype(vol_dtype)))
        return scan_forward_centers(
            params_bf16, padded, jnp.asarray(centers), jnp.asarray(vecs),
            chunk, True, compute_dtype="bfloat16", probs_dtype="float32")

    lab_f32vol, probs_f32vol = run(np.float32)      # cast inside the scan
    lab_bf16vol, probs_bf16vol = run(jnp.bfloat16)  # XLA path: pre-cast volume
    np.testing.assert_array_equal(np.asarray(lab_f32vol),
                                  np.asarray(lab_bf16vol))
    np.testing.assert_array_equal(np.asarray(probs_f32vol),
                                  np.asarray(probs_bf16vol))


def test_test_scan_odd_batch_size_chunk_invariance(params, phantom, tmp_path):
    """test_batch_size is free-form in the config contract; the internal
    chunk follows it, and any chunk yields identical outputs."""
    image, atlas, mask = phantom
    s_odd = _write_subject(tmp_path, "odd", image, atlas, mask)
    s_ref = _write_subject(tmp_path, "ref", image, atlas, mask)
    test_scan(params, str(s_odd / "T1.nii.gz"),
              Options(post_process=False, out_probabilities=False, crop=True,
                      debug=False, test_batch_size=1000, use_fcn=False))
    test_scan(params, str(s_ref / "T1.nii.gz"),
              Options(post_process=False, out_probabilities=False, crop=True,
                      debug=False, use_fcn=False))
    np.testing.assert_array_equal(
        load_nii(str(s_odd / "out_subcortical_rawseg.nii.gz")).data,
        load_nii(str(s_ref / "out_subcortical_rawseg.nii.gz")).data)
