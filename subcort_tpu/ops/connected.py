"""Connected-component labeling.

Reference counterpart: ``scipy.ndimage.label`` inside
``post_process_segmentation`` (base.py:469). Two implementations:

- :func:`label_components_np` — host path via scipy (default; fast enough
  at 14 calls/scan).
- :func:`label_components_device` — device path: iterative min-label
  propagation (6-connectivity, matching scipy's default structuring
  element) under ``lax.while_loop``. Each voxel starts with its linear
  index; every sweep takes the min over itself and its 6 in-mask
  neighbors; fixpoint = connected components labeled by their minimum
  linear index, then densified to 1..n on the host. XLA fuses a sweep
  into a handful of shifted-pad ops; convergence needs O(component
  diameter) sweeps, so sweeps are batched (``sweeps_per_check``) between
  convergence checks to amortize the reduction.

Correctness guarantee: ``_propagate_min`` returns a converged flag (the
while_loop exits either at fixpoint or at the sweep cap), and
:func:`label_components_device` falls back to scipy with a warning when a
pathological (serpentine, diameter > sweeps_per_check*max_checks)
component exceeds the cap — no input can silently mislabel.
"""

from __future__ import annotations

import warnings
from functools import partial

import numpy as np
from scipy import ndimage

import jax
import jax.numpy as jnp
from jax import lax


def label_components_np(mask: np.ndarray):
    """scipy 6-connectivity labeling: (labels int32, num)."""
    labels, num = ndimage.label(mask)
    return labels.astype(np.int32), int(num)


@partial(jax.jit, static_argnames=("sweeps_per_check", "max_checks"))
def _propagate_min(mask: jnp.ndarray, sweeps_per_check: int = 32,
                   max_checks: int = 64):
    """Min-label propagation to fixpoint (or the sweep cap).

    Returns (labels, converged): labels = per-voxel component root (the
    component's minimum linear index; -1 outside the mask), converged =
    False iff the final check still observed a change — i.e. the result
    may be unconverged and the caller must not trust it.
    """
    shape = mask.shape
    n = mask.size
    init = jnp.where(
        mask, jnp.arange(n, dtype=jnp.int32).reshape(shape), jnp.int32(n))

    big = jnp.int32(n)

    def sweep(lab):
        def shifted(axis, direction):
            pad = [(0, 0)] * lab.ndim
            if direction > 0:
                pad[axis] = (1, 0)
                sl = [slice(None)] * lab.ndim
                sl[axis] = slice(0, shape[axis])
            else:
                pad[axis] = (0, 1)
                sl = [slice(None)] * lab.ndim
                sl[axis] = slice(1, shape[axis] + 1)
            return jnp.pad(lab, pad, constant_values=big)[tuple(sl)]

        m = lab
        for axis in range(lab.ndim):
            m = jnp.minimum(m, shifted(axis, +1))
            m = jnp.minimum(m, shifted(axis, -1))
        return jnp.where(mask, m, big)

    def body(state):
        lab, _, it = state
        new = lab
        for _ in range(sweeps_per_check):
            new = sweep(new)
        return new, jnp.any(new != lab), it + 1

    def cond(state):
        _, changed, it = state
        return jnp.logical_and(changed, it < max_checks)

    lab, changed, _ = lax.while_loop(
        cond, body, (init, jnp.bool_(True), jnp.int32(0)))
    # `changed` True at exit means the cap fired mid-propagation
    return jnp.where(mask, lab, -1), jnp.logical_not(changed)


def label_components_device(mask: np.ndarray, *, sweeps_per_check: int = 32,
                            max_checks: int = 64):
    """On-device connected components; same contract as :func:`label_components_np`
    (labels densified to 1..num in scan order of component minimum index).

    Falls back to scipy (with a warning) if propagation did not reach its
    fixpoint within ``sweeps_per_check * max_checks`` sweeps — only
    adversarial serpentine shapes get there; anatomical components have
    diameters orders of magnitude below the default 2048-sweep budget.
    """
    mask_np = np.asarray(mask, bool)
    roots_j, converged = _propagate_min(jnp.asarray(mask_np),
                                        sweeps_per_check=sweeps_per_check,
                                        max_checks=max_checks)
    if not bool(converged):
        warnings.warn(
            "device connected-components hit the sweep cap "
            f"({sweeps_per_check * max_checks} sweeps) before convergence; "
            "falling back to scipy.ndimage.label")
        return label_components_np(mask_np)
    roots = np.asarray(roots_j)
    # vectorized densify: unique roots (ascending == scan order of the
    # component minimum) -> contiguous ids; inverse maps every voxel
    uniq, inv = np.unique(roots, return_inverse=True)
    has_bg = uniq.size and uniq[0] == -1
    ids = np.arange(1 - int(has_bg), uniq.size + 1 - int(has_bg),
                    dtype=np.int32)
    if has_bg:
        ids[0] = 0
    out = ids[inv].reshape(mask_np.shape)
    return out, int(uniq.size - int(has_bg))
