"""À-trous fully-convolutional evaluator — the fast inference path.

The reference (and our patch engine) evaluates the CNN once per candidate
voxel on a gathered 32x32 patch; neighboring patches share 97% of their
pixels, so per-patch evaluation redoes ~1000x the necessary conv work,
and the per-patch gather moves 3x32x32 values per voxel. This module
evaluates each 2D branch *densely* over whole slices using the standard
"à trous" (dilated-conv) transformation of a stride-2-pooled patch network,
producing per-pixel 180-d features that are bit-equivalent (up to float
reassociation) to running the patch branch at every pixel:

    patch net                      dense equivalent (all VALID)
    ---------                      ---------------------------
    conv1 3x3                      conv 3x3, dilation 1
    conv2 3x3                      conv 3x3, dilation 1
    maxpool k2 s2                  maxpool k2, stride 1, dilation 1
    conv3 3x3                      conv 3x3, dilation 2
    conv4 3x3                      conv 3x3, dilation 2
    maxpool k2 s2                  maxpool k2, stride 1, dilation 2
    conv5 3x3                      conv 3x3, dilation 4
    dense 540->180                 conv 3x3, dilation 4, 60->180 channels
                                   (the (540,180) weight IS the (3,3,60,180)
                                   kernel in our (h,w,c) flatten order)

For an input slab of spatial extent (H+31, W+31), the dense output has
extent (H, W) and output (i, j) equals the patch-branch output for the
patch centered at (x0+i, y0+j) where the slab starts at original
coordinate (x0-16, y0-16). Receptive field = 31 = patch 32 minus the
even-patch asymmetry (centers sit at index 16 of 0..31: the window is
[c-16, c+15]).

This turns inference into large NHWC convs —
~140k MACs/voxel/view instead of ~6.6M, and no gathers at all. Equality
with the patch path is pinned by tests/test_fcn.py.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from subcort_tpu.models.triplanar import (DEFAULT_SPEC, TriPlanarSpec,
                                          _prelu)

RF = 31  # receptive field of the dense branch (patch 32, even-centered)
HALF = 16

# f32 matmul/conv precision for this inference-only evaluator: HIGHEST,
# i.e. f32 convs and dots without TF32. On the GPU, XLA runs HIGH and
# DEFAULT as TF32 (10-bit mantissa), and the three-pass dot algorithms
# (BF16_BF16_F32_X3/X6, TF32_TF32_F32_X3) leave the convs at TF32 too.
# Measured on an H100 80GB HBM3 at 700 W, MNI bench scan (bench.py
# make_scan, 204,403 candidate voxels, seeded weights): HIGHEST 33.1 ms of
# device time with labels equal to the patch engine at 0.999995; HIGH
# 11.3 ms but only 0.99876 of labels equal to HIGHEST; the three-pass
# algorithms 13.6-17.3 ms at 0.99924. Only HIGHEST holds the FCN == patch
# engine gate (>= 0.9999), so the exact path stays exact; bf16 is the
# explicit fast opt-in (compute_dtype).
CONV_PRECISION = lax.Precision.HIGHEST


def _conv_dil(x, w, dil):
    return lax.conv_general_dilated(
        x, w, window_strides=(1, 1), padding="VALID",
        rhs_dilation=(dil, dil),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32,  # f32 accumulation in bf16 mode
        precision=CONV_PRECISION).astype(x.dtype)


def _dense_fcn(x, w, b):
    """Head matmul at CONV_PRECISION (the training stack's _dense stays
    HIGHEST — checkpoint-parity numerics are its contract, not speed)."""
    out = lax.dot_general(x, w, (((1,), (0,)), ((), ())),
                          precision=CONV_PRECISION,
                          preferred_element_type=jnp.float32)
    return out.astype(x.dtype) + b


def _pool_dil(x, dil):
    """max over 2 taps `dil` apart, stride 1 (dense form of k2-s2 pooling)."""
    return lax.reduce_window(
        x, -jnp.inf, lax.max,
        window_dimensions=(1, 2, 2, 1), window_strides=(1, 1, 1, 1),
        window_dilation=(1, dil, dil, 1), padding="VALID")


def _bn(x, bn):
    return (x - bn["mean"]) * (bn["inv_std"] * bn["gamma"]) + bn["beta"]


def dense_branch_features(bp, slab: jnp.ndarray,
                          spec: TriPlanarSpec = DEFAULT_SPEC) -> jnp.ndarray:
    """One branch evaluated densely.

    slab: (B, H+RF, W+RF, 1) image planes (normalized intensities, with the
    16-voxel patch context included). Returns (B, H, W, fc_conv) per-pixel
    branch features.
    """
    x = slab
    dils = (1, 1, 2, 2, 4)
    for i, d in zip(range(1, 6), dils):
        x = _conv_dil(x, bp[f"conv{i}"]["w"], d)
        x = _bn(x, bp[f"bn{i}"])
        x = _prelu(x, bp[f"prelu{i}"])
        if i == 2:
            x = _pool_dil(x, 1)
        elif i == 4:
            x = _pool_dil(x, 2)
    # dense 540->180 as 3x3 dilation-4 conv: our d1 rows are (h, w, c)
    # flatten order, so the reshape below is exactly the HWIO kernel.
    w = bp["d1"]["w"].reshape(3, 3, -1, bp["d1"]["w"].shape[1])
    x = _conv_dil(x, w, 4) + bp["d1"]["b"]
    return _prelu(x, bp["prelu_d1"])


@partial(jax.jit, static_argnames=("want_probs", "spec", "head_chunk",
                                   "probs_dtype"))
def fcn_forward_slab(params, slab: jnp.ndarray, atlas_vecs: jnp.ndarray,
                     want_probs: bool = False,
                     spec: TriPlanarSpec = DEFAULT_SPEC,
                     head_chunk: int = 65536,
                     probs_dtype=jnp.float32,
                     gather_idx=None, norm=None,
                     cand_bits=None, isbg_bits=None):
    """Dense tri-planar forward over a pre-cut slab.

    Args:
      slab: (bx+RF, by+RF, bz+RF) normalized intensities covering the bbox
        plus its 16/15-voxel patch context (zero where outside the volume —
        exactly the patch path's padding semantics). Shipping only the slab
        instead of the whole padded volume cuts the host->device transfer
        ~10x for typical subcortical ROIs. With ``norm`` =
        (scale (2,), lo (3,), hi (3,)) the slab arrives RAW (narrow-integer
        NIfTI voxels, half the wire bytes) and is normalized here with the
        identical (x - mean) * inv_std float32 arithmetic, zeroing voxels
        outside [lo, hi) (outside the source volume) — bit-exact with the
        host-normalized path.
      atlas_vecs: (M, C) prior vectors, background-fixed on host; any float
        dtype (float16 halves the transfer; cast up here) or fixed-point
        uint8/uint16. M = bx*by*bz in C-order (x-major) when dense
        (``gather_idx``/``cand_bits`` both None); ``gather_idx.shape[0]``
        rows (candidate voxels only) with explicit ``gather_idx``; with
        ``cand_bits`` only the NON-BACKGROUND prior rows (lexicographic
        candidate order, padded to their own ladder rung) — the bg rows
        are reconstructed below from ``isbg_bits``.
      gather_idx: optional (M,) int32 linear indices into the bbox voxel
        axis (C-order). When given, the branch features are gathered on
        device and the head MLP runs ONLY at those voxels — candidate sets
        are usually ~5x sparser than their bbox, so this cuts head FLOPs and
        the prior upload + probability readback by the same factor. The
        scatter-back only ever reads candidate voxels, so results are
        identical (tests/test_fcn.py pins this).
      cand_bits: optional (ceil(bx*by*bz / 8),) uint8 — the candidate mask
        over the bbox, C-order, LITTLE-endian bit packing (np.packbits
        bitorder='little'). The engine's compacted wire: ~1 bit/bbox-voxel
        replaces the 4-byte/candidate ``gather_idx`` upload (~1 MB -> ~80 kB
        on an MNI scan); the indices are recovered here with one
        nonzero(size=M) — candidate order is EXACTLY the host's
        np.nonzero (lexicographic) order, so host scatter needs no
        permutation. Mutually exclusive with ``gather_idx``.
      isbg_bits: required with ``cand_bits``: (M/8,) uint8, little-endian
        packed per-candidate background flags (padded to M with 1s). M is
        the padded candidate count (ladder rung — static). Prior row j is
        the constant e_{C-1} pattern where set (the per-sample bg fix-up of
        base.py:392-394 / pure-background atlas voxels — typically most of
        the dilated candidate shell), else the next row of ``atlas_vecs``
        in order. Bit-exact: quantize(e14) == the pattern in every wire
        dtype (tests/test_fcn.py pins reconstruction == uncompacted).

    Returns (labels, probs-or-dummy): labels (bx,by,bz) uint8 and probs
    (bx*by*bz, C) without gather_idx; labels (M,) and probs (M, C) with.
    feature[x, y, z] == branch(patch centered at bbox voxel (x, y, z)).
    The head MLP runs as a lax.scan over voxel chunks to bound HBM temps.
    """
    if norm is not None:
        # scal stays float32 regardless of the compute dtype: normalization
        # must match the host path's f32 arithmetic exactly, THEN cast
        # (normalizing in bf16 would quantize raw voxel values first, ~5x
        # the error of f32-normalize-then-cast). ``out`` is a zero-size
        # compute-dtype carrier.
        scal, lo, hi, out = norm
        x = (slab.astype(jnp.float32) - scal[0]) * scal[1]
        mask = None
        for ax in range(3):
            ii = lax.broadcasted_iota(jnp.int32, slab.shape, ax)
            m = (ii >= lo[ax]) & (ii < hi[ax])
            mask = m if mask is None else mask & m
        slab = jnp.where(mask, x, jnp.zeros((), x.dtype)).astype(out.dtype)

    bx = slab.shape[0] - RF
    by = slab.shape[1] - RF
    bz = slab.shape[2] - RF
    if cand_bits is not None:
        # Bitmask sparse wire (lossless): recover the (M,) lexicographic
        # candidate indices from the packed bbox mask, and rebuild the full
        # (M, C) prior row set from the compacted non-bg rows + packed bg
        # flags. All integer/select ops, replacing ~1 MB of h2d.
        assert gather_idx is None and isbg_bits is not None
        shifts = jnp.arange(8, dtype=jnp.uint8)
        cb = (((cand_bits[:, None] >> shifts) & 1) != 0).reshape(-1)
        m_pad = isbg_bits.shape[0] * 8
        gather_idx = jnp.nonzero(cb, size=m_pad, fill_value=0)[0].astype(
            jnp.int32)
        isb = (((isbg_bits[:, None] >> shifts) & 1) != 0).reshape(-1)
        rank = jnp.clip(jnp.cumsum((~isb).astype(jnp.int32)) - 1,
                        0, atlas_vecs.shape[0] - 1)
        c = atlas_vecs.shape[1]
        one = {jnp.dtype(jnp.uint8): 255,
               jnp.dtype(jnp.uint16): 65535}.get(
                   jnp.dtype(atlas_vecs.dtype), 1)
        bg_row = jnp.concatenate(
            [jnp.zeros((c - 1,), atlas_vecs.dtype),
             jnp.full((1,), one, atlas_vecs.dtype)])
        atlas_vecs = jnp.where(isb[:, None], bg_row[None, :],
                               jnp.take(atlas_vecs, rank, axis=0))
    if atlas_vecs.dtype == jnp.uint8:  # quantized prior transfer
        atlas_vecs = atlas_vecs.astype(slab.dtype) * (1.0 / 255.0)
    elif atlas_vecs.dtype == jnp.uint16:
        # fixed-point wire default: dequantize in f32 (65535 is not bf16-
        # representable) then cast to the compute dtype
        atlas_vecs = (atlas_vecs.astype(jnp.float32)
                      * (1.0 / 65535.0)).astype(slab.dtype)
    else:
        atlas_vecs = atlas_vecs.astype(slab.dtype)

    # axial: batch over z, planes (x, y); the z batch needs no halo
    ax_in = jnp.transpose(slab[:, :, HALF:HALF + bz], (2, 0, 1))[..., None]
    fa = dense_branch_features(params["axial"], ax_in, spec)      # (bz, bx, by, F)
    fa = jnp.transpose(fa, (1, 2, 0, 3))                          # (bx, by, bz, F)

    # coronal: batch over y, planes (x, z)
    co_in = jnp.transpose(slab[:, HALF:HALF + by, :], (1, 0, 2))[..., None]
    fc = dense_branch_features(params["coronal"], co_in, spec)    # (by, bx, bz, F)
    fc = jnp.transpose(fc, (1, 0, 2, 3))                          # (bx, by, bz, F)

    # sagittal: batch over x, planes (y, z)
    sa_in = slab[HALF:HALF + bx, :, :][..., None]
    fs = dense_branch_features(params["sagittal"], sa_in, spec)   # (bx, by, bz, F)

    feats = jnp.concatenate([fa, fc, fs], axis=-1)                # (bx, by, bz, 3F)
    n = bx * by * bz
    feats = feats.reshape(n, feats.shape[-1])
    if gather_idx is not None:
        feats = jnp.take(feats, gather_idx, axis=0)               # (M, 3F)
    m = feats.shape[0]

    # pad voxel axis to a chunk multiple for the scanned head
    chunk = min(head_chunk, m) if m else head_chunk
    n_chunks = max(1, -(-m // chunk))
    pad = n_chunks * chunk - m
    feats = jnp.pad(feats, ((0, pad), (0, 0)))
    atlas = jnp.pad(atlas_vecs, ((0, pad), (0, 0)))
    feats = feats.reshape(n_chunks, chunk, -1)
    atlas = atlas.reshape(n_chunks, chunk, -1)

    h = params["head"]

    def head(carry, inp):
        f, at = inp
        y = _prelu(_dense_fcn(f, h["fc1"]["w"], h["fc1"]["b"]), h["prelu_f1"])
        y = jnp.concatenate([y, at.astype(y.dtype)], axis=1)
        y = _prelu(_dense_fcn(y, h["fc2"]["w"], h["fc2"]["b"]), h["prelu_f2"])
        logits = _dense_fcn(y, h["out"]["w"], h["out"]["b"])
        lab = jnp.argmax(logits, axis=1).astype(jnp.uint8)
        if want_probs:
            pr = jax.nn.softmax(logits, axis=-1)
            # uint8 quantization happens AFTER the scan in one vectorized
            # op over the stacked (N, 15) probabilities
            pr = (pr.astype(jnp.float32)
                  if jnp.dtype(probs_dtype) == jnp.uint8
                  else pr.astype(probs_dtype))
        else:
            pr = jnp.zeros((), jnp.float32)
        return carry, (lab, pr)

    _, (labels, probs) = lax.scan(head, None, (feats, atlas))
    labels = labels.reshape(-1)[:m]
    if gather_idx is None:
        labels = labels.reshape(bx, by, bz)
    if want_probs:
        probs = probs.reshape(-1, probs.shape[-1])[:m]
        if jnp.dtype(probs_dtype) == jnp.uint8:
            # 1/255-step readback — half the bytes of f16 over the slow
            # host link; the host dequantizes
            probs = jnp.round(probs * 255.0).astype(jnp.uint8)
    return labels, probs


def slab_flops(bbox_dims: Tuple[int, int, int], m_rows: int = None,
               spec: TriPlanarSpec = DEFAULT_SPEC, n_classes: int = 15) -> int:
    """Analytic FLOP count (2 x MACs) of one ``fcn_forward_slab`` call.

    Counts the three dense à-trous branches over their (batch, plane+halo)
    extents plus the head MLP over ``m_rows`` voxels (``None`` = dense head,
    every bbox voxel). Matches the module docstring's ~140k MACs/voxel/view:
    per interior pixel the branch costs 9*(20 + 400 + 800 + 1600 + 2400
    + 10800) = 144,180 MACs. BN/PReLU/pool element-wise ops are excluded
    (memory-bound, not matrix work)."""
    bx, by, bz = (int(d) for d in bbox_dims)
    fc = spec.fc_conv
    # (batch axis, plane dims) per view — the fcn_forward_slab transposes
    views = ((bz, bx, by), (by, bx, bz), (bx, by, bz))
    convs = [(1, 20, 1), (20, 20, 1), (20, 40, 2), (40, 40, 2), (40, 60, 4)]
    total = 0
    for b, h, w in views:
        p, q = h + RF, w + RF
        for i, (cin, cout, d) in enumerate(convs, start=1):
            p -= 2 * d
            q -= 2 * d
            total += 2 * b * p * q * cin * cout * 9
            if i == 2:      # maxpool k2 s1 dil1
                p -= 1
                q -= 1
            elif i == 4:    # maxpool k2 s1 dil2
                p -= 2
                q -= 2
        p -= 8              # dense 540->fc as 3x3 dil-4 conv
        q -= 8
        total += 2 * b * p * q * 60 * fc * 9
        assert (p, q) == (h, w), "receptive-field accounting drifted"
    m = bx * by * bz if m_rows is None else int(m_rows)
    f3 = 3 * fc
    total += 2 * m * (f3 * f3 + (f3 + n_classes) * 270 + 270 * n_classes)
    return total


def fcn_forward_bbox(params, padded_vol: jnp.ndarray,
                     bbox_origin, bbox_shape: Tuple[int, int, int],
                     atlas_vecs: jnp.ndarray, want_probs: bool = False,
                     spec: TriPlanarSpec = DEFAULT_SPEC,
                     head_chunk: int = 65536):
    """Convenience wrapper over :func:`fcn_forward_slab` that cuts the slab
    out of a pad_volume()-padded volume (padded index = original + HALF, so
    the slab for origin (x0,y0,z0) starts at padded (x0,y0,z0))."""
    bx, by, bz = bbox_shape
    x0 = int(bbox_origin[0]); y0 = int(bbox_origin[1]); z0 = int(bbox_origin[2])
    slab = jax.lax.dynamic_slice(padded_vol, (x0, y0, z0),
                                 (bx + RF, by + RF, bz + RF))
    return fcn_forward_slab(params, slab, atlas_vecs, want_probs, spec,
                            head_chunk)
