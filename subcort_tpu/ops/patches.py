"""Tri-planar patch gather — the framework's core data-engine kernel.

The reference materializes patches on the host, one numpy slice per center
(cnn_cort/base.py:272-308 ``get_patches``: pad by patch_half, then a Python
loop of ~10^5-10^6 slice ops per scan — its #1 hot loop, SURVEY.md §3).
This design inverts it: the *padded volume lives in device memory* (~60 MB)
and patch extraction is a vectorized gather executed on device, fused by XLA
with the conv forward that consumes it. No patch tensor ever crosses the
host↔device boundary.

Semantics parity with ``get_patches`` (verified by tests against a direct
numpy re-implementation):

- even-size centering: a patch for center ``c`` spans ``[c - p//2,
  c + (p - p//2))`` per axis (Py2 integer division, base.py:300);
- zero padding outside the volume (base.py:302-303);
- view axis mapping (base.py:293-298): axial = (x, y) plane at fixed z,
  coronal = (x, z) at fixed y, sagittal = (y, z) at fixed x.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

PATCH = 32
HALF = PATCH // 2


def pad_volume(vol: jnp.ndarray, half: int = HALF) -> jnp.ndarray:
    """Zero-pad a 3D volume by ``half`` on both sides of every axis.

    One padded copy serves all three views: padded index = original + half.
    """
    return jnp.pad(vol, ((half, half), (half, half), (half, half)))


def gather_triplanar(padded: jnp.ndarray, centers: jnp.ndarray,
                     patch: int = PATCH) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Gather (axial, coronal, sagittal) patch stacks for a batch of centers.

    Args:
      padded: (X+2h, Y+2h, Z+2h) volume from :func:`pad_volume`.
      centers: (N, 3) int32 voxel coordinates in *original* volume space.
      patch: 2D patch edge (even; reference default 32).

    Returns three (N, patch, patch) arrays. The window for center ``c``
    starts at padded index ``c`` (= original ``c - half`` + pad offset
    ``half``), reproducing the reference's centering exactly.
    """
    half = patch // 2
    cx, cy, cz = centers[:, 0], centers[:, 1], centers[:, 2]
    offs = jnp.arange(patch, dtype=centers.dtype)
    xs = cx[:, None] + offs                # (N, patch) window along x
    ys = cy[:, None] + offs
    zs = cz[:, None] + offs
    xc = cx + half                          # fixed (center) padded index
    yc = cy + half
    zc = cz + half

    axial = padded[xs[:, :, None], ys[:, None, :], zc[:, None, None]]
    coronal = padded[xs[:, :, None], yc[:, None, None], zs[:, None, :]]
    sagittal = padded[xc[:, None, None], ys[:, :, None], zs[:, None, :]]
    return axial, coronal, sagittal


def gather_atlas_vectors(atlas: jnp.ndarray, centers: jnp.ndarray,
                         bg_channel: int = 14) -> jnp.ndarray:
    """Per-center 15-vector from the prior volume, with background fix-up.

    Reference: base.py:388-394 — gather ``atlas[x, y, z, :]`` and, where a
    sample's prior sums to 0 (outside every registered structure), set the
    background channel to 1. (The train-time variant at base.py:214-216 is
    buggy — NameError on ``v`` — the per-sample version is the intended
    semantics and is what we implement for both paths.)
    """
    vec = atlas[centers[:, 0], centers[:, 1], centers[:, 2], :]
    empty = jnp.sum(vec, axis=1) == 0
    onehot_bg = jnp.zeros_like(vec).at[:, bg_channel].set(1.0)
    return jnp.where(empty[:, None], onehot_bg, vec)


# ----------------------------------------------------------------- numpy twin
def gather_triplanar_np(vol: np.ndarray, centers: np.ndarray,
                        patch: int = PATCH):
    """Host/numpy twin of :func:`gather_triplanar` (for data prep without a
    device and for tests). Identical semantics."""
    half = patch // 2
    padded = np.pad(vol, half)
    centers = np.asarray(centers)
    cx, cy, cz = centers[:, 0], centers[:, 1], centers[:, 2]
    offs = np.arange(patch)
    xs = cx[:, None] + offs
    ys = cy[:, None] + offs
    zs = cz[:, None] + offs
    axial = padded[xs[:, :, None], ys[:, None, :], (cz + half)[:, None, None]]
    coronal = padded[xs[:, :, None], (cy + half)[:, None, None], zs[:, None, :]]
    sagittal = padded[(cx + half)[:, None, None], ys[:, :, None], zs[:, None, :]]
    return axial, coronal, sagittal
