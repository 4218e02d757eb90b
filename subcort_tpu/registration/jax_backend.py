"""Device-side resampling backend.

A pure-JAX twin of ``tools/reg_resample`` (trilinear pull-resampling through
either a world affine or a SUBCORT_CPP B-spline control grid — see
native/src/geometry.hpp for the transform contracts). Used to warp the
15 prior channels on device in one fused program, and as a differentiable
resampler for future on-device registration.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from subcort_tpu.io import load_nii

# every einsum below contracts f32 coordinates/displacements that feed the
# transform.nii cross-runtime contract (native/src/geometry.hpp) and the
# FFD/affine losses; the GPU's default f32 matmul precision is TF32 (~3
# decimal digits), so pin HIGHEST like the model's convs — the contraction
# dims here are tiny (3-4 or the control-point count), so exactness is
# effectively free.
_EXACT = lax.Precision.HIGHEST


class CppGrid(NamedTuple):
    """Control-point displacement grid (matches geometry.hpp::CppGrid)."""
    disp: jnp.ndarray       # (ncx, ncy, ncz, 3) world displacements
    spacing: object         # per-axis (sx, sy, sz) in reference voxel units
                            # (a scalar is accepted and means isotropic)
    ref_affine: np.ndarray  # (4, 4)


def spacing3(spacing) -> Tuple[float, float, float]:
    """Normalize a control spacing to a per-axis (sx, sy, sz) tuple.

    NiftyReg's ``reg_f3d -sx`` is millimetres *per axis*; on anisotropic
    voxels (e.g. clinical 1x1x3 mm) a single voxel-unit scalar would make
    the grid 3x denser along z than requested (VERDICT r3 missing-3), so
    spacing is per-axis everywhere. Scalars mean isotropic."""
    arr = np.asarray(spacing, np.float64).reshape(-1)
    if arr.size == 1:
        arr = np.repeat(arr, 3)
    if arr.size != 3:
        raise ValueError(f"spacing must be scalar or length-3, got {spacing!r}")
    return tuple(float(s) for s in arr)


def downsample2(vol, affine=None):
    """Half-resolution 2x2x2 mean pool (odd tails dropped); numpy or jax
    arrays alike. With ``affine``, also returns the half-res grid's world
    affine in the SAME world frame: columns double (voxels are 2x coarser)
    and the origin shifts to the 2x2x2 cell centroid. One implementation
    for every registration pyramid (affine + both FFD backends' levels) so
    coordinate-frame fixes cannot land in one copy and miss another."""
    x, y, z = (s - s % 2 for s in vol.shape)
    v = vol[:x, :y, :z].reshape(x // 2, 2, y // 2, 2, z // 2, 2).mean((1, 3, 5))
    if affine is None:
        return v
    a = np.asarray(affine, np.float64).copy()
    a[:3, 3] += 0.5 * a[:3, :3].sum(1)
    a[:3, :3] *= 2.0
    return v, a


def load_cpp_grid(path: str, ref_affine: np.ndarray) -> CppGrid:
    """Read a transform.nii written by reg_f3d (5D (ncx,ncy,ncz,1,3)).

    Per-axis spacing is recovered column-wise: the grid sform's column j is
    the reference column j scaled by spacing_j (geometry.hpp::save_cpp)."""
    img = load_nii(path)
    if img.data.ndim != 5 or img.data.shape[3] != 1 or img.data.shape[4] != 3:
        raise ValueError(f"{path}: not a SUBCORT_CPP control grid")
    disp = np.asarray(img.data[:, :, :, 0, :], np.float32)
    ra = np.asarray(ref_affine)
    sp = tuple(
        float(np.linalg.norm(img.affine[:3, j]) /
              (np.linalg.norm(ra[:3, j]) or 1.0))
        for j in range(3))
    if not all(s > 0.0 for s in sp):
        # a zeroed sform column means this 5D NIfTI is not a control grid;
        # spacing 0 would divide by zero downstream (silent all-background
        # resamples) — geometry.hpp::load_cpp applies the same guard
        raise ValueError(f"{path}: not a SUBCORT_CPP grid (zero spacing {sp})")
    return CppGrid(jnp.asarray(disp), sp, ra)


def _bspline_weights(t: jnp.ndarray):
    t2, t3 = t * t, t * t * t
    return jnp.stack([(1 - 3 * t + 3 * t2 - t3) / 6.0,
                      (4 - 6 * t2 + 3 * t3) / 6.0,
                      (1 + 3 * t + 3 * t2 - 3 * t3) / 6.0,
                      t3 / 6.0], axis=-1)


def _trilinear(vol: jnp.ndarray, coords: jnp.ndarray) -> jnp.ndarray:
    """vol (X,Y,Z[,C]); coords (..., 3) voxel coordinates; zeros outside."""
    shape = jnp.asarray(vol.shape[:3])
    c0 = jnp.floor(coords)
    f = coords - c0
    c0 = c0.astype(jnp.int32)
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                ci = c0 + jnp.asarray([dx, dy, dz])
                w = ((f[..., 0] if dx else 1 - f[..., 0]) *
                     (f[..., 1] if dy else 1 - f[..., 1]) *
                     (f[..., 2] if dz else 1 - f[..., 2]))
                inb = jnp.all((ci >= 0) & (ci < shape), axis=-1)
                cc = jnp.clip(ci, 0, shape - 1)
                v = vol[cc[..., 0], cc[..., 1], cc[..., 2]]
                if vol.ndim == 4:
                    w = w[..., None]
                    inb = inb[..., None]
                out = out + jnp.where(inb, w * v, 0.0)
    return out


def _ref_world_coords(ref_shape: Tuple[int, int, int], ref_affine) -> jnp.ndarray:
    gx, gy, gz = jnp.meshgrid(jnp.arange(ref_shape[0]), jnp.arange(ref_shape[1]),
                              jnp.arange(ref_shape[2]), indexing="ij")
    vox = jnp.stack([gx, gy, gz, jnp.ones_like(gx)], axis=-1).astype(jnp.float32)
    return jnp.einsum("ij,xyzj->xyzi", jnp.asarray(ref_affine, jnp.float32),
                      vox, precision=_EXACT)[..., :3]


@partial(jax.jit, static_argnames=("ref_shape",))
def _resample_affine(flo, affine, flo_inv, ref_affine, ref_shape):
    w = _ref_world_coords(ref_shape, ref_affine)
    fw = jnp.einsum("ij,xyzj->xyzi",
                    jnp.asarray(affine, jnp.float32)[:3, :],
                    jnp.concatenate([w, jnp.ones(w.shape[:-1] + (1,))], axis=-1),
                    precision=_EXACT)
    fv = jnp.einsum("ij,xyzj->xyzi",
                    jnp.asarray(flo_inv, jnp.float32)[:3, :],
                    jnp.concatenate([fw, jnp.ones(fw.shape[:-1] + (1,))], axis=-1),
                    precision=_EXACT)
    return _trilinear(flo, fv)


def resample_through_affine(flo: np.ndarray, flo_affine: np.ndarray,
                            affine: np.ndarray, ref_shape, ref_affine) -> np.ndarray:
    """Pull-resample ``flo`` (3D or 4D multichannel) into the reference grid
    through a world affine (flo_world = A . ref_world)."""
    flo_inv = np.linalg.inv(np.asarray(flo_affine))
    out = _resample_affine(jnp.asarray(np.asarray(flo, np.float32)),
                           np.asarray(affine, np.float32), flo_inv,
                           np.asarray(ref_affine, np.float32),
                           tuple(int(s) for s in ref_shape))
    return np.asarray(out)


def _bspline_axis_matrix(n: int, spacing, nc: int,
                         vox_offset: float = 0.0) -> jnp.ndarray:
    """Dense (n, nc) cubic B-spline evaluation matrix for one axis: row v
    holds the 4 basis weights of voxel v against the clamped control
    lattice (clip-accumulated at the edges, matching the gather loop this
    replaces). Dense-banded on purpose: nc is tiny (~20-40), so the three
    per-axis contractions are matmuls instead of 64 serialized gathers.

    ``vox_offset`` shifts this level's voxel coordinates into the canonical
    (finest-level) lattice frame — the half-resolution pyramid level maps
    coarse voxel v to fine voxel 2v+0.5, so it evaluates at
    u=(v+0.25)/(sp/2) (vox_offset=0.25); 0 = the canonical frame itself."""
    u = (jnp.arange(n, dtype=jnp.float32) + vox_offset) / spacing
    b = jnp.floor(u).astype(jnp.int32)
    w = _bspline_weights(u - b)  # (n, 4)
    W = jnp.zeros((n, nc), jnp.float32)
    for a in range(4):
        W = W + w[:, a, None] * jax.nn.one_hot(
            jnp.clip(b + a, 0, nc - 1), nc, dtype=jnp.float32)
    return W


def bspline_dense_disp(disp: jnp.ndarray, spacing, shape,
                       vox_offset: float = 0.0) -> jnp.ndarray:
    """(ncx,ncy,ncz,3) control displacements -> (X,Y,Z,3) displacement at
    every reference voxel, as three separable tensor contractions.

    Mathematically identical to the naive 64-term gather accumulation
    (cubic B-spline tensor product, control i at voxel (i-1)*spacing_axis)
    but cheaper: 12 effective taps instead of 64, no gathers, and the
    contractions are matmuls. ``spacing`` is
    per-axis (scalar = isotropic); may be traced or static."""
    if isinstance(spacing, (tuple, list)) or getattr(spacing, "ndim", 0):
        sx, sy, sz = spacing[0], spacing[1], spacing[2]
    else:
        sx = sy = sz = spacing
    ncx, ncy, ncz = disp.shape[:3]
    Wx = _bspline_axis_matrix(shape[0], sx, ncx, vox_offset)
    Wy = _bspline_axis_matrix(shape[1], sy, ncy, vox_offset)
    Wz = _bspline_axis_matrix(shape[2], sz, ncz, vox_offset)
    t = jnp.einsum("xa,abck->xbck", Wx, disp, precision=_EXACT)
    t = jnp.einsum("yb,xbck->xyck", Wy, t, precision=_EXACT)
    return jnp.einsum("zc,xyck->xyzk", Wz, t, precision=_EXACT)


@partial(jax.jit, static_argnames=("ref_shape",))
def _resample_cpp(flo, disp, spacing, flo_inv, ref_affine, ref_shape):
    d = bspline_dense_disp(disp, spacing, ref_shape)
    w = _ref_world_coords(ref_shape, ref_affine)
    fw = w + d
    fv = jnp.einsum("ij,xyzj->xyzi",
                    jnp.asarray(flo_inv, jnp.float32)[:3, :],
                    jnp.concatenate([fw, jnp.ones(fw.shape[:-1] + (1,))], axis=-1),
                    precision=_EXACT)
    return _trilinear(flo, fv)


def resample_through_cpp(flo: np.ndarray, flo_affine: np.ndarray,
                         grid: CppGrid, ref_shape, ref_affine) -> np.ndarray:
    """Pull-resample through a B-spline control grid (all channels fused —
    the reference's 15-subprocess loop becomes one device program)."""
    flo_inv = np.linalg.inv(np.asarray(flo_affine))
    out = _resample_cpp(jnp.asarray(np.asarray(flo, np.float32)), grid.disp,
                        jnp.asarray(spacing3(grid.spacing), jnp.float32),
                        flo_inv, np.asarray(ref_affine, np.float32),
                        tuple(int(s) for s in ref_shape))
    return np.asarray(out)
