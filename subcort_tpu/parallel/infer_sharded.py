"""Voxel-parallel multi-chip inference (SURVEY.md §2.5: the one parallelism
that maps — the candidate-voxel axis sharded across the device mesh).

The per-scan device program (tri-planar gather -> CNN forward) is wrapped in
``jax.shard_map``: the padded volume and parameters are replicated (the
volume is ~60 MB, the model 3.5 MB — both trivial per chip), the centers and
prior vectors are sharded over the ``('data',)`` mesh, and each chip scans
its local shard. No collectives are needed on the hot path; results come
back voxel-sharded and the host assembles the label volume.

The scan body is the shared engine.forward.scan_forward_centers, so the
multi-device path runs exactly the single-device gather and forward.

Reached from the product surface via ``segment_volume(engine='patch',
devices=...)`` (engine/infer.py), i.e. the ``data_parallel`` config knob.
Tested on the 8-device virtual CPU mesh in CI (bit-equal to the
single-device scan); ``dryrun_multichip`` asserts the same parity.
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from subcort_tpu.engine.forward import scan_forward_centers
from subcort_tpu.models.triplanar import DEFAULT_SPEC, TriPlanarSpec


# program cache: jax.jit caches executables per *callable*, and shard_map
# returns a fresh callable each time — without this, every scan re-traced
# and recompiled. Keyed by everything that changes the traced program.
_PROGRAM_CACHE: dict = {}


def _sharded_program(mesh: Mesh, chunk: int, want_probs: bool,
                     probs_dtype: str, spec: TriPlanarSpec,
                     compute_dtype: str = "float32"):
    # probs_dtype is dead when probs aren't requested — canonicalize it so a
    # caller-side default change can't silently fork the program cache
    if not want_probs:
        probs_dtype = "uint8"
    key = (tuple(d.id for d in mesh.devices.flat), mesh.axis_names,
           chunk, want_probs, probs_dtype, spec, compute_dtype)
    fn = _PROGRAM_CACHE.get(key)
    if fn is None:
        fn = jax.jit(
            jax.shard_map(
                partial(scan_forward_centers, chunk=chunk,
                        want_probs=want_probs, spec=spec,
                        probs_dtype=probs_dtype, compute_dtype=compute_dtype),
                mesh=mesh,
                in_specs=(P(), P(), P("data"), P("data")),
                out_specs=(P("data"), P("data") if want_probs else P()),
            ),
        )
        _PROGRAM_CACHE[key] = fn
    return fn


def predict_labels_sharded(params, padded_vol, centers: np.ndarray,
                           vecs: np.ndarray, mesh: Mesh, chunk: int = 2048,
                           spec: TriPlanarSpec = DEFAULT_SPEC,
                           want_probs: bool = False,
                           probs_dtype: str = "uint8",
                           compute_dtype: str = "float32"):
    """Classify candidate voxels across all mesh devices.

    centers (N, 3) / vecs (N, 15) are padded to ndev*chunk granularity,
    split over the mesh, and each device runs the jitted local scan.
    Returns (N,) uint8 labels, plus (N, 15) probabilities in ``probs_dtype``
    when ``want_probs`` (None otherwise). The jitted program is cached
    module-level, so repeated scans on the same mesh reuse the executable.
    """
    ndev = mesh.devices.size
    n = centers.shape[0]
    gran = ndev * chunk
    # pow2-bucket the per-device chunk count (same recompile-avoidance as
    # the single-device path; sentinel rows clamp harmlessly)
    n_chunks = 1 << int(np.ceil(np.log2(max(-(-n // gran), 1))))
    pad = n_chunks * gran - n
    centers_p = np.concatenate([np.asarray(centers, np.int32),
                                np.zeros((pad, 3), np.int32)], axis=0)
    vecs_p = np.concatenate([np.asarray(vecs, np.float32),
                             np.zeros((pad, vecs.shape[1]), np.float32)], axis=0)

    fn = _sharded_program(mesh, chunk, want_probs, probs_dtype, spec,
                          compute_dtype)
    params_r = jax.device_put(params, NamedSharding(mesh, P()))
    vol_r = jax.device_put(padded_vol, NamedSharding(mesh, P()))
    centers_s = jax.device_put(centers_p, NamedSharding(mesh, P("data")))
    vecs_s = jax.device_put(vecs_p, NamedSharding(mesh, P("data")))
    labels, probs = fn(params_r, vol_r, centers_s, vecs_s)
    labels = np.asarray(labels)[:n]
    return labels, (np.asarray(probs)[:n] if want_probs else None)
