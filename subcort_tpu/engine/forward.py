"""The shared chunked-forward scan body for patch-engine inference.

One implementation of (tri-planar gather -> cast -> CNN forward ->
argmax / deferred-quantization probs), scanned over fixed-size center
chunks, used by both the single-device path
(engine.infer._forward_centers) and the shard_map'd multi-device path
(parallel.infer_sharded). Reference counterpart: the
per-batch ``net.predict`` / ``net.predict_proba`` loop of
cnn_cort/base.py:421-440. Extracted so the two call sites cannot drift.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from subcort_tpu.models import apply as model_apply
from subcort_tpu.models.triplanar import DEFAULT_SPEC, TriPlanarSpec


def scan_forward_centers(params, padded_vol, centers, atlas_vecs,
                         chunk: int, want_probs: bool,
                         spec: TriPlanarSpec = DEFAULT_SPEC,
                         probs_dtype: str = "float32",
                         compute_dtype: str = "float32"):
    """Classify ``centers`` (N, 3) against the device-resident ``padded_vol``.

    N must be a multiple of ``chunk`` (callers pad with sentinel rows that
    clamp harmlessly and drop the outputs). The engine ships ``padded_vol``
    already cast to ``compute_dtype`` (a gather does no arithmetic, so
    cast-then-gather equals gather-then-cast; the cast below is then a
    no-op). Returns ((N,) uint8 labels, (N, C) probs in ``probs_dtype`` —
    uint8 quantization happens after the scan in one vectorized op).
    """
    from subcort_tpu.ops import gather_triplanar

    n_chunks = centers.shape[0] // chunk
    cs = centers.reshape(n_chunks, chunk, 3)
    av = atlas_vecs.reshape(n_chunks, chunk, -1)
    cd = jnp.dtype(compute_dtype)

    def body(carry, inp):
        c, at = inp
        ax, co, sa = (v.astype(cd) for v in gather_triplanar(padded_vol, c))
        # priors always arrive f32 — cast, else the atlas branch + head
        # silently promote back to f32
        at = at.astype(cd)
        probs = model_apply(params, {"axial": ax, "coronal": co,
                                     "sagittal": sa, "atlas": at}, spec=spec)
        labels = jnp.argmax(probs, axis=1).astype(jnp.uint8)
        if want_probs:
            pr = (probs.astype(jnp.float32)
                  if jnp.dtype(probs_dtype) == jnp.uint8
                  else probs.astype(probs_dtype))
        else:
            pr = jnp.zeros((), jnp.float32)
        return carry, (labels, pr)

    _, (labels, probs) = jax.lax.scan(body, None, (cs, av))
    labels = labels.reshape(-1)
    if want_probs:
        probs = probs.reshape(-1, probs.shape[-1])
        if jnp.dtype(probs_dtype) == jnp.uint8:
            probs = jnp.round(probs * 255.0).astype(jnp.uint8)
    return labels, probs
