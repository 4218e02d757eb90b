"""Per-scan inference engine (workload layer L5).

Reference counterpart: ``test_scan`` + ``load_patch_batch``
(cnn_cort/base.py:335-458). The reference streams 100k-patch host batches
through the net, with patch extraction as a Python slice loop; here a scan
is segmented by jitted device programs over either

    the dense path (default): bbox+halo slab -> à-trous tri-planar convs
      -> scanned head MLP -> per-voxel labels/probs (models/fcn.py), or
    the patch path: device-resident padded volume -> lax.scan over center
      chunks of (XLA gather -> CNN forward),

with per-voxel prior vectors gathered on the host (only the candidate rows
of the ~430 MB 4D prior volume cross to the device) and results scattered
on the host.

Output contract matches the reference exactly (filenames and semantics,
base.py:445-455): ``out_subcortical_prob.nii.gz`` (when out_probabilities),
``out_subcortical_seg_prec.nii.gz`` (post-processed) or
``out_subcortical_rawseg.nii.gz``. One deliberate precision delta: the
prob map's values default to 1/255-step fixed point (``[tpu] probs_dtype =
uint8``, the device->host readback wire; labels are computed on device
and unaffected). Set ``probs_dtype =
float32`` for reference-exact probability values. Fixes SURVEY.md §2.3-1 (the reference
only produces nonzero output when ``debug='True'`` due to a stray indent —
we always predict) and §2.3-2 (``crop`` actually honors False).
"""

from __future__ import annotations

import dataclasses
import os
import time
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from scipy import ndimage

from subcort_tpu.config import Options
from subcort_tpu.engine.postprocess import post_process_segmentation
from subcort_tpu.io import NiftiImage, load_nii, save_nii
from subcort_tpu.models.triplanar import DEFAULT_SPEC, TriPlanarSpec
from subcort_tpu.ops import get_mask_voxels, normalize_stats, pad_volume

DEFAULT_CHUNK = 8192


def load_test_names(options: Options) -> Tuple[list, list]:
    """T1 paths + subject names from the inference folder (base.py:41-50)."""
    dir_name = options["test_folder"]
    subjects = [f for f in sorted(os.listdir(dir_name))
                if os.path.isdir(os.path.join(dir_name, f))]
    t1_names = [os.path.join(dir_name, s, options["t1_name"]) for s in subjects]
    return t1_names, subjects


@partial(jax.jit, static_argnames=("chunk", "want_probs", "spec",
                                   "probs_dtype", "compute_dtype"))
def _forward_centers(params, padded_vol, centers, atlas_vecs,
                     chunk: int, want_probs: bool,
                     spec: TriPlanarSpec = DEFAULT_SPEC,
                     probs_dtype: str = "float32",
                     compute_dtype: str = "float32"):
    """The fused device program: tri-planar gather -> forward, scanned over
    ``chunk``-sized center blocks (shared body: engine.forward).

    Only the ~60 MB padded T1 volume, the (N, 3) centers, and the (N, 15)
    prior vectors cross the host->device boundary — never patch tensors and
    never the ~430 MB 4D prior volume (its per-center gather happens on the
    host). Sentinel (out-of-range) center rows clamp harmlessly; the host
    drops their outputs.
    """
    from subcort_tpu.engine.forward import scan_forward_centers
    return scan_forward_centers(params, padded_vol, centers, atlas_vecs,
                                chunk, want_probs, spec=spec,
                                probs_dtype=probs_dtype,
                                compute_dtype=compute_dtype)


@partial(jax.jit, static_argnames=("out_dtype",))
def _pad_normalize_device(raw: jnp.ndarray, scal: jnp.ndarray,
                          out_dtype: str = "float32") -> jnp.ndarray:
    """(raw - mean) * inv_std on device, then the HALF halo pad — the
    device-side twin of host normalize + ops.pad_volume for raw-wire
    integer volumes (halo voxels are 0 in normalized space, as pad_volume
    produces). Normalization runs in f32 (host-path-exact) and only then
    casts to ``out_dtype``."""
    norm = ((raw.astype(jnp.float32) - scal[0])
            * scal[1]).astype(jnp.dtype(out_dtype))
    return pad_volume(norm)


def candidate_centers(image: np.ndarray, options: Options,
                      atlas_mask: Optional[np.ndarray]) -> np.ndarray:
    """Candidate voxels to classify.

    crop=True: the dilated (10 iterations, base.py:369) binary subcortical
    atlas mask. crop=False: all nonzero image voxels (base.py:372). Note the
    reference's crop flag couldn't actually be disabled (string-truthiness,
    SURVEY.md §2.3-2); here False works.
    """
    if options.bool("crop") and atlas_mask is not None:
        b_mask = ndimage.binary_dilation(atlas_mask.astype(bool),
                                         iterations=options["dilate_crop_iters"])
        return get_mask_voxels(b_mask)
    return get_mask_voxels(image.astype(bool))


def _atlas_vectors_host(atlas: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Host-side atlas gather + per-sample background fix-up (base.py:388-394)."""
    vecs = atlas[centers[:, 0], centers[:, 1], centers[:, 2]].astype(np.float32)
    empty = vecs.sum(axis=1) == 0
    vecs[empty] = 0.0
    vecs[empty, 14] = 1.0
    return vecs


def _bbox_of(centers: np.ndarray, shape, align: int = 16):
    """Tight bbox of the candidate set, dims rounded up to ``align`` (fewer
    XLA recompiles across scans) and clamped inside the volume."""
    lo = centers.min(axis=0)
    hi = centers.max(axis=0) + 1
    dims = hi - lo
    dims = np.minimum(-(-dims // align) * align, np.asarray(shape))
    lo = np.minimum(lo, np.asarray(shape) - dims)
    lo = np.maximum(lo, 0)
    return lo.astype(np.int32), tuple(int(d) for d in dims)


def _split_bbox(lo, dims, max_voxels: int):
    """Split a bbox along its largest axis into sub-bboxes of at most
    ``max_voxels`` each (keeps per-call device memory bounded; enables
    whole-volume FCN evaluation for crop=False)."""
    if int(np.prod(dims)) <= max_voxels:
        yield np.asarray(lo, np.int32), tuple(int(d) for d in dims)
        return
    axis = int(np.argmax(dims))
    n_parts = -(-int(np.prod(dims)) // max_voxels)
    step = -(-dims[axis] // n_parts)
    for start in range(0, dims[axis], step):
        sub_lo = np.asarray(lo, np.int32).copy()
        sub_lo[axis] += start
        sub_dims = list(dims)
        sub_dims[axis] = min(step, dims[axis] - start)
        yield from _split_bbox(sub_lo, tuple(sub_dims), max_voxels)


def _quantize_priors(vecs: np.ndarray, prior_dtype) -> np.ndarray:
    if np.dtype(prior_dtype) == np.uint8:
        # quantized prior transfer (1/255 steps; priors are probabilities):
        # half the bytes of float16; dequantized on device in fcn_forward_slab
        return np.round(vecs * 255.0).astype(np.uint8)
    if np.dtype(prior_dtype) == np.uint16:
        # fixed-point uint16 (default): same bytes as float16 but MORE
        # accurate (1/65535 step vs f16's ~1e-3 relative)
        return np.round(vecs * 65535.0).astype(np.uint16)
    return vecs.astype(prior_dtype)


def _round_up_pow2(m: int, floor: int = 8192) -> int:
    """Bucket candidate counts to a geometric ladder so the jitted head sees
    a bounded set of shapes across scans (each new shape is a compile).

    Rungs are pow2 AND 3·pow2/4 (…, 49152, 65536, 98304, 131072, …): the
    half-density ladder caps shipped-row padding waste at 33% instead of
    100% for ~2x the worst-case shape count. Any monotone ladder preserves
    the compaction invariant in ``_fcn_slab_inputs`` (d_pad < m_pad forces
    m > d_pad: the rung below m_pad is >= d_pad, and m must exceed it)."""
    p = 1 << int(np.ceil(np.log2(max(m, 1))))
    rung = (3 * p) // 4 if m <= (3 * p) // 4 else p
    return max(floor, rung)


def _bg_prior_pattern(n_classes: int, prior_dtype) -> np.ndarray:
    """The quantized background prior row e_{C-1} — the single source of
    truth for 'this row never crosses the wire'. Used by the compaction in
    ``_fcn_slab_inputs`` (rows == pattern are rebuilt on device) and by
    ``segment_volume``'s wire-byte gate (estimating shipped prior rows);
    the device-side twin is the constant append in ``fcn_forward_slab``."""
    pat = np.zeros((1, n_classes), np.float32)
    pat[0, -1] = 1.0
    return _quantize_priors(pat, prior_dtype)[0]


@dataclasses.dataclass
class SparseWire:
    """Packed sparse-mode wire arrays for ``fcn_forward_slab``.

    ``cand_bits``: uint8, little-endian packbits of the candidate mask over
    the bbox voxels (C-order) — ~1 bit per bbox voxel instead of 4 bytes
    per candidate. ``isbg_bits``: uint8, little-endian packbits of the
    per-candidate background flags in lexicographic candidate order, padded
    to ``m_pad`` (the static padded candidate count, a ladder rung) with 1s.
    """
    cand_bits: np.ndarray
    isbg_bits: np.ndarray
    m_pad: int


def _fcn_slab_inputs(image, stats, atlas, lo, dims, shape, spec, prior_dtype,
                     centers=None, force_sparse: bool = False):
    """Host prep for one sub-bbox. ``image`` is the RAW volume; ``stats`` is
    its nonzero (mean, std) — normalization happens on the slab cut only
    (the full-volume normalize costs ~0.1 s/scan of pure host time and the
    device never sees voxels outside the slabs).

    Returns (slab, prior vecs in prior_dtype, cs, wire, norm):
    dense mode (``centers=None``): vecs covers every bbox voxel in C-order,
    cs/wire are None. Sparse mode: cs = the candidate centers inside this
    bbox in np.nonzero (lexicographic) order, wire = a :class:`SparseWire`
    (packed candidate bitmask over the bbox + packed per-candidate bg
    flags), vecs = only the NON-BACKGROUND prior rows in candidate order
    (padded to their own ladder rung) — the device recovers the gather
    indices from the bitmask, rebuilds the bg rows as the constant e_{C-1}
    pattern, and runs the head MLP only at candidate voxels (~5x fewer
    than the bbox). Vs shipping explicit int32 indices + bg rows this cuts
    the sparse-side wire by ~1 MB/scan at MNI scale.

    For narrow-integer scans (the usual int16 T1 NIfTI) the slab ships RAW
    and ``norm`` = (scale(2,), lo(3,), hi(3,)) tells the device to apply
    the identical (x - mean) * inv_std float32 arithmetic there, zeroing
    outside-volume voxels — bit-exact with the host path at half the
    host->device bytes. For float
    scans the slab is normalized on host and ``norm`` is None.
    """
    from subcort_tpu.models.fcn import RF

    bx, by, bz = dims
    half = spec.patch_size // 2
    mean, std = stats
    # cut the bbox+halo slab on the host (ships ~10x less than the whole
    # volume): slab axis i covers [lo-half, lo+dim+half-1]. Outside-volume
    # padding stays 0.0 in normalized space (== pad_volume's convention).
    raw_wire = image.dtype.kind in "iu" and image.dtype.itemsize <= 2
    slab = np.zeros((bx + RF, by + RF, bz + RF),
                    image.dtype if raw_wire else np.float32)
    src, dst = [], []
    for l, d, s in zip(lo, dims, shape):
        a = min(max(int(l) - half, 0), s)
        b = max(min(int(l) + d + half - 1, s), a)
        ds = a - (int(l) - half)
        if ds < 0:
            # sub-bbox starts more than `half` past the volume end (SPMD
            # shard overhang on large meshes): there is no overlap, and a
            # negative dst start would wrap around numpy's negative-index
            # semantics into a non-empty slice — pin both sides to empty
            a = b = s
            ds = 0
        src.append(slice(a, b))
        dst.append(slice(ds, ds + (b - a)))
    if raw_wire:
        slab[tuple(dst)] = image[tuple(src)]
        norm = (np.array([mean, 1.0 / std], np.float32),
                np.array([s.start for s in dst], np.int32),
                np.array([s.stop for s in dst], np.int32))
    else:
        slab[tuple(dst)] = ((image[tuple(src)].astype(np.float32)
                             - np.float32(mean)) * np.float32(1.0 / std))
        norm = None

    if centers is not None:
        inside = np.all((centers >= lo) & (centers < lo + np.asarray(dims)),
                        axis=1)
        cs = centers[inside]
        m = len(cs)
        if m == 0:
            return None, None, cs, None, None  # nothing to classify here
        m_pad = _round_up_pow2(m)
        if force_sparse or m_pad < bx * by * bz:
            # force_sparse: the SPMD evaluator (parallel/fcn_sharded.py)
            # stacks per-device shards and needs every shard in the same
            # (sparse) layout — never the dense fall-through below
            rel = cs - np.asarray(lo)[None, :]
            lin = ((rel[:, 0].astype(np.int64) * by + rel[:, 1]) * bz
                   + rel[:, 2]).astype(np.int64)
            # The device recovers candidate indices as nonzero(bitmask) —
            # always ascending-lin (lexicographic) order — and the host
            # scatter aligns results with ``cs`` positionally. Internal
            # callers (candidate_centers / np.nonzero) are already sorted
            # and unique; reorder/dedup here so arbitrary caller-supplied
            # center lists can't silently misalign the scatter.
            if m > 1 and not (np.diff(lin) > 0).all():
                lin, uniq = np.unique(lin, return_index=True)
                cs = cs[uniq]
                m = len(cs)
                m_pad = _round_up_pow2(m)
            vecs = _quantize_priors(_atlas_vectors_host(atlas, cs),
                                    prior_dtype)
            # Compacted prior wire (lossless): rows equal to the background
            # pattern e_{C-1} — the bg fix-up rows and pure-background atlas
            # voxels, typically most of the dilate-10 candidate shell — need
            # not cross the wire, and neither do explicit gather indices:
            # the candidate set ships as a packed bitmask over the bbox
            # (~1 bit/voxel) plus packed per-candidate bg flags, and the
            # device reconstructs indices (nonzero in the same lex order as
            # ``cs``) and the constant bg rows (bit-exact; pinned by
            # tests/test_fcn.py). Only the non-bg prior rows cross, padded
            # to their own ladder rung.
            pat = _bg_prior_pattern(vecs.shape[1], prior_dtype)
            is_bg = (vecs == pat).all(axis=1)
            nb = int((~is_bg).sum())
            d_pad = _round_up_pow2(nb)
            vecs = np.pad(vecs[~is_bg], ((0, d_pad - nb), (0, 0))) \
                if d_pad > nb else vecs[~is_bg]
            cand = np.zeros(bx * by * bz, np.bool_)
            cand[lin] = True
            isb = np.ones(m_pad, np.bool_)
            isb[:m] = is_bg
            wire = SparseWire(np.packbits(cand, bitorder="little"),
                              np.packbits(isb, bitorder="little"), m_pad)
            return slab, vecs, cs, wire, norm
        # candidates ~fill the bbox: dense head is cheaper than a padded
        # gather — fall through

    # prior vectors for every bbox voxel, C-order over (x, y, z): the
    # bbox is clamped inside the volume, so the gather is one contiguous
    # block slice; a narrow dtype (default float16) halves the transfer
    vecs = atlas[lo[0]:lo[0] + bx, lo[1]:lo[1] + by,
                 lo[2]:lo[2] + bz].reshape(-1, atlas.shape[-1]).astype(
                     np.float32, copy=True)
    empty = vecs.sum(axis=1) == 0
    vecs[empty] = 0.0
    vecs[empty, 14] = 1.0
    return slab, _quantize_priors(vecs, prior_dtype), None, None, norm


def _dequantize_probs(probs_b) -> np.ndarray:
    probs_b = np.asarray(probs_b)
    if probs_b.dtype == np.uint8:
        return probs_b.astype(np.float32) * np.float32(1.0 / 255.0)
    return probs_b


def _fcn_scatter_results(labels_b, probs_b, lo, dims, centers, cs,
                         label_vol, prob_vol, want_probs):
    labels_b = np.asarray(labels_b)
    if cs is not None:
        # sparse mode: results are aligned with cs (pow2 padding dropped)
        m = len(cs)
        label_vol[cs[:, 0], cs[:, 1], cs[:, 2]] = labels_b[:m]
        if want_probs:
            prob_vol[cs[:, 0], cs[:, 1], cs[:, 2]] = \
                _dequantize_probs(probs_b)[:m]
        return
    bx, by, bz = dims
    inside = np.all((centers >= lo) & (centers < lo + np.asarray(dims)), axis=1)
    cs = centers[inside]
    rel = cs - np.asarray(lo)[None, :]
    label_vol[cs[:, 0], cs[:, 1], cs[:, 2]] = \
        labels_b[rel[:, 0], rel[:, 1], rel[:, 2]]
    if want_probs:
        probs_b = _dequantize_probs(probs_b).reshape(bx, by, bz, -1)
        prob_vol[cs[:, 0], cs[:, 1], cs[:, 2]] = \
            probs_b[rel[:, 0], rel[:, 1], rel[:, 2]]


def _fcn_run_bboxes(params, image, stats, atlas, bboxes, shape, centers,
                    label_vol, prob_vol, want_probs, spec, prior_dtype,
                    probs_dtype, dev_dtype, devices=None):
    """Run the dense evaluator over sub-bboxes, optionally fanned out over
    multiple devices (each sub-slab is independent; params are replicated
    per device once, slabs round-robin — device-level pipeline parallelism
    over the candidate region, SURVEY.md §2.5 voxel-axis sharding).

    Results scatter free-as-they-go: at most ``2 * n_devices`` slabs' device
    outputs stay in flight (enough to keep every device busy while the host
    scatters the oldest), so peak HBM for crop=False whole-volume probs runs
    is bounded by a constant number of slabs instead of all of them."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from subcort_tpu.models.fcn import fcn_forward_slab

    if devices is None:
        devices = [None]
    # host prep (slab cut + prior slice) runs in a thread pool so multi-device
    # fan-out is not serialized behind single-threaded numpy prep; dispatch
    # stays in submission order (JAX dispatch is async, so the device work for
    # slab i overlaps the prep of slab i+1 even single-device)
    pool = ThreadPoolExecutor(min(len(bboxes), os.cpu_count() or 1, 8))
    preps = [pool.submit(_fcn_slab_inputs, image, stats, atlas, lo, dims,
                         shape, spec, prior_dtype, centers)
             for lo, dims in bboxes]
    params_per_dev = {}
    pending = deque()
    max_inflight = 2 * len(devices)

    def drain_one():
        labels_b, probs_b, lo, dims, cs = pending.popleft()
        # np.asarray blocks on this slab only; devices keep executing the
        # already-dispatched younger slabs meanwhile
        _fcn_scatter_results(labels_b, probs_b, lo, dims, centers, cs,
                             label_vol, prob_vol, want_probs)

    try:
        for i, (lo, dims) in enumerate(bboxes):
            dev = devices[i % len(devices)]
            if dev not in params_per_dev:
                params_per_dev[dev] = (params if dev is None
                                       else jax.device_put(params, dev))
            slab, vecs, cs, wire, norm = preps[i].result()
            if slab is None:
                continue  # no candidates in this sub-bbox
            if norm is None:
                slab_d = jnp.asarray(slab, dev_dtype)
                norm_d = None
            else:
                # raw narrow-integer bytes over the wire; normalization
                # happens on device in f32 (host-path-exact) then casts to
                # dev_dtype
                slab_d = jnp.asarray(slab)
                scal, nlo, nhi = norm
                norm_d = (jnp.asarray(scal), jnp.asarray(nlo),
                          jnp.asarray(nhi), jnp.zeros((), dev_dtype))
            vecs_d = jnp.asarray(vecs)
            cand_d = isbg_d = None
            if wire is not None:
                cand_d = jnp.asarray(wire.cand_bits)
                isbg_d = jnp.asarray(wire.isbg_bits)
            if dev is not None:
                slab_d = jax.device_put(slab_d, dev)
                vecs_d = jax.device_put(vecs_d, dev)
                if wire is not None:
                    cand_d = jax.device_put(cand_d, dev)
                    isbg_d = jax.device_put(isbg_d, dev)
                norm_d = (None if norm_d is None
                          else tuple(jax.device_put(n, dev) for n in norm_d))
            labels_b, probs_b = fcn_forward_slab(
                params_per_dev[dev], slab_d, vecs_d, want_probs, spec,
                probs_dtype=jnp.dtype(probs_dtype).name, norm=norm_d,
                cand_bits=cand_d, isbg_bits=isbg_d)
            pending.append((labels_b, probs_b, lo, dims, cs))
            while len(pending) > max_inflight:
                drain_one()
    finally:
        # a raising slab (corrupt prior, device error) must not leak the
        # pool: cancel queued preps so the worker thread stops cutting
        # slabs for a run that is already dead (1-core host — stray prep
        # work contends with whatever runs next)
        pool.shutdown(wait=False, cancel_futures=True)
    while pending:
        drain_one()


def segment_volume(params, image: np.ndarray, atlas: np.ndarray,
                   centers: np.ndarray, *, want_probs: bool = False,
                   chunk: int = DEFAULT_CHUNK,
                   spec: TriPlanarSpec = DEFAULT_SPEC,
                   engine: str = "auto",
                   fcn_max_bbox_voxels: int = 6_000_000,
                   prior_dtype=np.uint16,
                   probs_dtype=np.uint8,
                   compute_dtype: str = "float32",
                   devices=None,
                   fcn_spmd: bool = True):
    """Segment one T1 volume at the given centers.

    ``image`` is the *raw* scan (normalization happens here, with the
    reference's nonzero-stats semantics). Returns (label_vol uint8,
    prob_vol float32 or None) as numpy arrays.

    engine='fcn' evaluates the candidate bounding box densely with the
    à-trous evaluator (models/fcn.py), splitting oversized bboxes into
    sub-slabs of at most ``fcn_max_bbox_voxels`` (so crop=False whole-volume
    runs are dense too). engine='patch' gathers per-center patches (XLA
    gather) — better only for very sparse candidate sets. 'auto'
    picks FCN unless the bbox exceeds ~30x the candidate count.

    With ``devices`` (a multi-device list), the FCN path runs as ONE
    sharded SPMD program over a ('data',) mesh by default
    (parallel/fcn_sharded.py — no host dispatch loop on the hot path);
    ``fcn_spmd=False`` keeps the host sub-bbox fan-out, which pipelines
    per-slab uploads against compute.
    Both are bit-identical to single-device (tests/test_parallel.py).
    """
    image = np.asarray(image)
    stats = normalize_stats(image)
    shape = tuple(int(s) for s in image.shape)
    centers = np.asarray(centers, np.int32)
    n = centers.shape[0]
    atlas = np.asarray(atlas, np.float32)
    if not want_probs:
        # probs_dtype is dead without probs but stays a static arg of every
        # jitted program below — canonicalize so labels-only calls with
        # different configured probs_dtypes share one compile instead of
        # forking the jit caches (infer_sharded applies the same rule for
        # its program cache).
        probs_dtype = np.uint8
    dev_dtype = (jnp.bfloat16 if compute_dtype in ("bfloat16", "bf16")
                 else jnp.float32)
    if dev_dtype == jnp.bfloat16:
        # bfloat16 activations/weights: half the activation memory and the
        # bf16 tensor-core rate; argmax labels stay >=99.9% identical
        # (tested).
        params = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.bfloat16), params)

    label_vol = np.zeros(shape, np.uint8)
    prob_vol = (np.zeros(shape + (15,), np.float32) if want_probs else None)
    if n == 0:
        # no candidate voxels (e.g. the dilated atlas mask is empty): the
        # reference's batch generator yields zero batches and the output
        # volumes stay all-zero (base.py:379-380,414-417) — mirror that
        # instead of tripping _bbox_of on an empty center set
        return label_vol, prob_vol

    lo = dims = None
    if engine == "auto":
        # FCN wins whenever candidates are reasonably dense in their bbox
        # (it evaluates every bbox voxel); the patch path wins only for very
        # sparse candidate sets. Oversized bboxes are split per-call.
        lo, dims = _bbox_of(centers, shape)
        bvox = int(np.prod(dims))
        engine = "fcn" if bvox <= 30 * n else "patch"

    if engine == "fcn":
        if lo is None:
            lo, dims = _bbox_of(centers, shape)
        vox = int(np.prod(dims))
        if devices is not None and len(devices) > 1 and fcn_spmd:
            # ONE sharded program per (outer) slab: the slab axis is split
            # over the mesh inside fcn_run_spmd; oversized candidate regions
            # still honor the per-device HBM budget via an outer split
            from jax.sharding import Mesh

            from subcort_tpu.parallel.fcn_sharded import fcn_run_spmd
            mesh = Mesh(np.asarray(devices), ("data",))
            outer = len(devices) * fcn_max_bbox_voxels
            for sub_lo, sub_dims in _split_bbox(lo, dims, outer):
                fcn_run_spmd(params, image, stats, atlas, sub_lo, sub_dims,
                             shape, centers, label_vol, prob_vol, want_probs,
                             spec, prior_dtype, probs_dtype,
                             jnp.dtype(dev_dtype).name, mesh)
            return label_vol, prob_vol
        if devices is not None and len(devices) > 1:
            # split finely enough that every device gets work
            fcn_max_bbox_voxels = min(fcn_max_bbox_voxels,
                                      max(1, -(-vox // len(devices))))
        else:
            # pipeline the wire: >=2 slabs let slab i+1's upload overlap
            # slab i's compute/readback. Gated on estimated wire bytes, not
            # voxels: small-wire runs lose more to the extra halo + dispatch
            # than the overlap buys. The 6 MB threshold was tuned for a far
            # slower host link than PCIe and is kept until the benchmark
            # measures the gate on the GPU.
            m_rows = min(_round_up_pow2(n), vox)
            if m_rows >= vox:
                # candidates ~fill the bbox: _fcn_slab_inputs falls through
                # to dense mode, which ships a prior row for EVERY bbox
                # voxel — no compaction applies, so estimate accordingly
                # (the sparse formula below would undercount by the bg
                # fraction and could leave the slow-link split off)
                prior_rows = vox
            else:
                # prior rows that are pure background never cross the wire
                # (_fcn_slab_inputs compacts them); estimate the shipped
                # fraction from a stride-64 candidate subsample (~3k rows)
                # through the SAME predicate the compaction applies (fix-up
                # + quantize + pattern equality), then round the estimated
                # non-bg count to its pow2 rung — exactly the prefix the
                # compaction ships
                sub = centers[::64]
                sv = _quantize_priors(_atlas_vectors_host(atlas, sub),
                                      prior_dtype)
                dense_frac = float(
                    (sv != _bg_prior_pattern(sv.shape[1], prior_dtype))
                    .any(axis=1).mean())
                prior_rows = min(m_rows,
                                 _round_up_pow2(int(n * dense_frac) + 1))
            from subcort_tpu.models.fcn import RF
            slab_vox = int(np.prod(np.asarray(dims, np.int64) + RF))
            wire = (slab_vox * (2 if image.dtype.kind in "iu" and
                                image.dtype.itemsize <= 2 else 4)
                    + prior_rows * 15 * np.dtype(prior_dtype).itemsize
                    # sparse mode ships packed candidate + bg bitmasks
                    + (vox // 8 + m_rows // 8 if m_rows < vox else 0)
                    + (m_rows * 15 * np.dtype(probs_dtype).itemsize
                       if want_probs else 0))
            if wire >= 6_000_000:
                fcn_max_bbox_voxels = min(fcn_max_bbox_voxels, -(-vox // 2))
        bboxes = list(_split_bbox(lo, dims, fcn_max_bbox_voxels))
        _fcn_run_bboxes(params, image, stats, atlas, bboxes, shape, centers,
                        label_vol, prob_vol, want_probs, spec, prior_dtype,
                        probs_dtype, dev_dtype, devices)
        return label_vol, prob_vol

    # ------------------------------------------------------------- patch path
    # the volume ships pre-cast to the compute dtype: gather-then-cast
    # equals cast-then-gather per voxel (a gather does no arithmetic)
    mean, std = stats
    if image.dtype.kind in "iu" and image.dtype.itemsize <= 2:
        # raw narrow-integer wire (the usual int16 T1): ship the raw volume
        # and pad+normalize on device — identical (x - mean) * inv_std f32
        # arithmetic, a quarter of the host->device bytes. Normalization
        # runs in f32 and only then casts, so the wire dtype never changes
        # numerics.
        padded = _pad_normalize_device(
            jnp.asarray(image),
            jnp.asarray([mean, 1.0 / std], np.float32),
            out_dtype=jnp.dtype(dev_dtype).name)
    else:
        norm = (image.astype(np.float32) - np.float32(mean)) * np.float32(1.0 / std)
        norm = norm.astype(dev_dtype, copy=False)  # no-op for f32 scans
        padded = pad_volume(jnp.asarray(norm))
    vecs = _atlas_vectors_host(atlas, centers)

    if devices is not None and len(devices) > 1:
        # candidate-voxel axis sharded over the device mesh (shard_map);
        # bit-identical to the single-device scan (tests/test_parallel.py)
        from jax.sharding import Mesh

        from subcort_tpu.parallel.infer_sharded import predict_labels_sharded
        mesh = Mesh(np.asarray(devices), ("data",))
        labels, probs = predict_labels_sharded(
            params, padded, centers, vecs, mesh, chunk=chunk, spec=spec,
            want_probs=want_probs, probs_dtype=jnp.dtype(probs_dtype).name,
            compute_dtype=jnp.dtype(dev_dtype).name)
        label_vol[centers[:, 0], centers[:, 1], centers[:, 2]] = labels
        if want_probs:
            prob_vol[centers[:, 0], centers[:, 1], centers[:, 2]] = \
                _dequantize_probs(probs)
        return label_vol, prob_vol

    # bucket the chunk count to a pow2 ladder: _forward_centers specializes
    # on n_chunks, and candidate counts vary per scan — without bucketing
    # every scan pays a recompile. Sentinel rows clamp harmlessly and are
    # dropped below.
    n_chunks = _round_up_pow2(max(1, -(-n // chunk)), floor=1)
    pad = n_chunks * chunk - n
    centers_p = np.concatenate([centers, np.zeros((pad, 3), np.int32)], axis=0)
    vecs_p = np.concatenate([vecs, np.zeros((pad, 15), np.float32)], axis=0)

    labels, probs = _forward_centers(
        params, padded, jnp.asarray(centers_p), jnp.asarray(vecs_p),
        chunk, want_probs, spec,
        probs_dtype=jnp.dtype(probs_dtype).name,
        compute_dtype=jnp.dtype(dev_dtype).name)
    labels = np.asarray(labels)[:n]
    label_vol[centers[:, 0], centers[:, 1], centers[:, 2]] = labels
    if want_probs:
        probs = _dequantize_probs(probs)[:n]
        prob_vol[centers[:, 0], centers[:, 1], centers[:, 2]] = probs
    return label_vol, prob_vol


def _data_parallel_devices(options: Options):
    """Device list for the ``data_parallel`` config knob (SURVEY.md §2.5).

    data_parallel=1 (default) returns None — plain single-default-device
    dispatch. Larger values fan inference out over the first N devices
    (clamped to what exists, with a note, so one cfg works on any slice)."""
    dp = int(options["data_parallel"])
    if dp <= 1:
        return None
    avail = jax.devices()
    if dp > len(avail):
        if options["net_verbose"]:
            print(f"--> data_parallel={dp} requested but only {len(avail)} "
                  "device(s) present; using all of them")
        dp = len(avail)
    return avail[:dp] if dp > 1 else None


def _load_scan_inputs(scan_path: str, options: Options, register_fn=None):
    """Host-side per-scan prep: ensure priors exist (registering on a cache
    miss, base.py:361-365), load the T1 + prior volumes, and enumerate
    candidate voxels.

    Host/subprocess work, safe to run ahead of time (``segment_folder``
    prefetches the next scan's inputs here while the device segments the
    current one) — with one caveat: ``reg_backend=jax`` registers *on
    device*, so a priors cache miss under the pipelined sweep dispatches
    the affine+FFD programs (and, on a cold cache, their compiles)
    interleaved with the main thread's segmentation on the same device.
    Correct (JAX serializes dispatch), but the contention defeats the
    prefetch overlap — pre-register the cohort or use the native backend
    when pipelining."""
    image_dir, _ = os.path.split(scan_path)
    tmp = os.path.join(image_dir, "tmp")
    prior_path = os.path.join(tmp, "MNI_sub_probabilities.nii.gz")
    mask_path = os.path.join(tmp, "MNI_subcortical_mask.nii.gz")

    if not os.path.exists(prior_path):
        if register_fn is None:
            from subcort_tpu.engine.data import _configured_register
            from subcort_tpu.registration import register_masks
            register_fn = _configured_register(register_masks, options)
        register_fn(scan_path)

    t1 = load_nii(scan_path)
    image = np.asarray(t1.data)
    atlas = load_nii(prior_path).data
    atlas_mask = load_nii(mask_path).data if os.path.exists(mask_path) else None
    centers = candidate_centers(image, options, atlas_mask)
    return t1, image, atlas, centers


class _BoundedWriter:
    """Bounded async-write queue for the pipelined folder sweep: at most
    ``max_inflight`` deferred write_outputs closures exist at once (each
    pins a scan's output volumes — a ~430 MB prob map with
    out_probabilities — so an unbounded backlog behind a slow gzip would
    grow host RSS by that much per queued scan). submit() blocks on (and
    surfaces errors from) the oldest write once the bound is hit."""

    def __init__(self, pool, max_inflight: int = 2):
        self.pool = pool
        self.max_inflight = max_inflight
        self.futures = []

    def submit(self, fn):
        while len(self.futures) >= self.max_inflight:
            self.futures.pop(0).result()
        self.futures.append(self.pool.submit(fn))

    def drain(self):
        while self.futures:
            self.futures.pop(0).result()


def test_scan(params, scan_path: str, options: Options,
              register_fn=None, spec: TriPlanarSpec = DEFAULT_SPEC,
              _inputs=None, _writer=None) -> float:
    """Full per-scan pipeline with the reference's file contract
    (base.py:401-458). Returns elapsed minutes, like the reference.

    ``register_fn``: callable(scan_path) ensuring the per-subject ``tmp/``
    prior volumes exist (the registration subsystem); defaults to the
    cache-only behavior — raising if priors are missing.

    ``_inputs``/``_writer`` (internal, used by ``segment_folder``'s
    pipelined sweep): pre-loaded ``_load_scan_inputs`` result, and an
    executor to run post-processing + file writes on so they overlap the
    next scan's device work. With ``_writer`` the returned minutes (and
    the emitted per-scan stats) cover the segmentation stage only —
    loading happened in the prefetch thread and writes are deferred — so
    they are NOT comparable to serial-mode numbers, which cover
    load+segment+write. Output files are guaranteed on disk once the
    caller drains the writer.
    """
    s_time = time.time()
    image_dir, _ = os.path.split(scan_path)
    t1, image, atlas, centers = (
        _inputs if _inputs is not None
        else _load_scan_inputs(scan_path, options, register_fn))
    if options.bool("debug"):
        print("    -->  num of samples to test:", len(centers))

    from subcort_tpu.engine.metrics import ScanStats
    stats = ScanStats(scan_path).set(candidate_voxels=int(len(centers)),
                                     volume_shape=list(image.shape))

    want_probs = options.bool("out_probabilities")
    # the chunk is an internal tiling detail: any value yields identical
    # results
    chunk = min(DEFAULT_CHUNK, max(256, options["test_batch_size"]))
    label_vol, prob_vol = segment_volume(
        params, image, atlas, centers, want_probs=want_probs,
        chunk=chunk, spec=spec,
        engine="auto" if options.bool("use_fcn") else "patch",
        fcn_max_bbox_voxels=options["fcn_max_bbox_voxels"],
        prior_dtype=np.dtype(options["prior_dtype"]),
        probs_dtype=np.dtype(options["probs_dtype"]),
        compute_dtype=options["compute_dtype"],
        devices=_data_parallel_devices(options),
        fcn_spmd=options.bool("fcn_spmd"))

    # capture only what the (possibly deferred) write needs: the affine and
    # the seg output dtype — never `t1`/`image` themselves, which would pin
    # the raw scan volume in the writer queue for its whole lifetime
    affine = t1.affine
    seg_dtype = image.dtype if image.dtype.kind in "iu" else np.uint8

    def write_outputs():
        if want_probs:
            # asarray, not astype: prob_vol is already float32 — avoid a
            # no-op ~430 MB copy before the (streamed, level-1 gzip) write
            save_nii(NiftiImage(np.asarray(prob_vol, np.float32), affine),
                     os.path.join(image_dir, "out_subcortical_prob.nii.gz"))
        if options.bool("post_process"):
            filtered = post_process_segmentation(
                image_dir, label_vol,
                bugcompat_argmax=options["bugcompat_postprocess_argmax"],
                cc_backend=options["cc_backend"])
            save_nii(NiftiImage(filtered.astype(seg_dtype), affine),
                     os.path.join(image_dir, "out_subcortical_seg_prec.nii.gz"))
        else:
            save_nii(NiftiImage(label_vol.astype(np.uint8), affine),
                     os.path.join(image_dir, "out_subcortical_rawseg.nii.gz"))
        if options["net_verbose"]:
            stats.emit()  # one JSON line: wall_seconds, voxels_per_sec, ...

    if _writer is None:
        write_outputs()
    else:
        # pin wall_seconds now: emit() runs later on the writer thread,
        # where time.time() would absorb queue wait + later scans' device
        # work — and pin the returned minutes BEFORE submit(), which can
        # block on an older scan's write once the bounded queue is full.
        # NOTE the measurement semantics differ by mode — serial stats
        # cover segment + post-process + write; pipelined stats (and the
        # returned minutes, since loading happened in the prefetch thread)
        # cover the segmentation stage only.
        stats.stop()
        elapsed = time.time() - s_time
        _writer.submit(write_outputs)
        return elapsed / 60.0
    return (time.time() - s_time) / 60.0


# keep the reference's public name without pytest collecting it as a test
test_scan.__test__ = False


class SegmentationEngine:
    """Convenience wrapper binding (params, options) — the object a user of
    the reference's ``net`` + ``test_scan`` pair migrates to."""

    def __init__(self, params, options: Options,
                 spec: TriPlanarSpec = DEFAULT_SPEC, register_fn=None):
        self.params = jax.device_put(params)
        self.options = options
        self.spec = spec
        self.register_fn = register_fn

    def segment_scan(self, scan_path: str) -> float:
        return test_scan(self.params, scan_path, self.options,
                         register_fn=self.register_fn, spec=self.spec)

    def predict_proba(self, batch) -> np.ndarray:
        """``net.predict_proba`` migration shim (reference nets.py / nolearn):
        softmax probabilities for a pre-extracted patch batch (accepts the
        reference's ``in1..in4`` dict keys or axial/coronal/sagittal/atlas),
        memory-bounded via a scanned chunked forward."""
        from subcort_tpu.models import predict_proba_chunked
        return np.asarray(predict_proba_chunked(self.params, batch))

    def predict(self, batch) -> np.ndarray:
        """``net.predict`` migration shim: argmax class ids."""
        return np.argmax(self.predict_proba(batch), axis=1)

    def segment_folder(self) -> dict:
        """Batch inference over the configured inference folder
        (train_model.py:68-78 flow). Returns {subject: minutes}.

        With ``[tpu] folder_pipeline`` on, the sweep is pipelined: while
        the device segments scan *i*, one IO thread prefetches scan
        *i+1*'s host prep (registration on cache miss, NIfTI gunzip,
        candidate enumeration) and another drains scan *i-1*'s
        post-processing and gzip writeback — the per-scan host costs, which
        otherwise serialize with device compute, overlap it instead. All
        outputs are on disk (and any write error raised) before this
        returns; results are identical to the serial sweep
        (tests/test_engine.py pins this). Default OFF: pipelining only
        pays when spare host cores exist; on a single-core host the
        prefetch/writeback threads contend with the thread feeding the
        device.

        Under a multi-process launch (jax.distributed initialized, e.g. via
        ``SUBCORT_NUM_PROCESSES`` + parallel.distributed.initialize), each
        host segments its strided slice of the subject list — subject-level
        DCN data parallelism (SURVEY.md §2.5); single-process runs are
        unchanged."""
        t1_names, subjects = load_test_names(self.options)
        if jax.process_count() > 1:
            from subcort_tpu.parallel.distributed import host_shard
            pairs = host_shard(list(zip(t1_names, subjects)))
        else:
            pairs = list(zip(t1_names, subjects))
        times = {}
        if not self.options.bool("folder_pipeline") or len(pairs) <= 1:
            for path, sub in pairs:
                if self.options.bool("debug"):
                    print("--> testing scan", sub)
                times[sub] = self.segment_scan(path)
            return times

        from concurrent.futures import ThreadPoolExecutor

        # separate single-thread pools: a slow writeback (e.g. a 430 MB
        # prob-map gzip) must not starve the prefetch of the next scan
        with ThreadPoolExecutor(1) as loader, ThreadPoolExecutor(1) as wpool:
            writer = _BoundedWriter(wpool)
            nxt = loader.submit(_load_scan_inputs, pairs[0][0], self.options,
                                self.register_fn)
            try:
                for i, (path, sub) in enumerate(pairs):
                    inputs = nxt.result()
                    if i + 1 < len(pairs):
                        nxt = loader.submit(_load_scan_inputs, pairs[i + 1][0],
                                            self.options, self.register_fn)
                    if self.options.bool("debug"):
                        print("--> testing scan", sub)
                    times[sub] = test_scan(self.params, path, self.options,
                                           spec=self.spec, _inputs=inputs,
                                           _writer=writer)
                writer.drain()
            except BaseException:
                # a failed scan/prefetch must not silently discard errors
                # from writes already queued: wait them out, report, then
                # re-raise the primary error
                try:
                    writer.drain()
                except Exception as we:  # noqa: BLE001 — reported, not lost
                    print(f"--> additionally, a deferred output write "
                          f"failed: {we!r}")
                raise
        return times
