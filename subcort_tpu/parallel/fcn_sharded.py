"""SPMD dense-FCN inference — ONE sharded device program for the flagship
evaluator (VERDICT r4 weak-3).

``segment_volume(engine='fcn', devices=...)`` fans sub-slabs out from a host
thread (per-device dispatch loop): correct, and the per-slab uploads
pipeline against compute. But with several devices the host dispatch loop
becomes the bottleneck the patch path's shard_map (infer_sharded.py)
already avoids.
This module gives the dense evaluator the same one-program treatment:

    the candidate bbox is split along its largest axis into ndev equal
    sub-slabs (+RF halo each); slabs, prior vectors and gather indices are
    stacked on a leading device axis and sharded over the ('data',) mesh;
    params are replicated; ONE jitted shard_map program runs
    models.fcn.fcn_forward_slab per shard — no collectives on the hot path,
    host scatter afterwards.

The per-shard row budget is the max over shards (pow2-bucketed, like the
single-device path), padded with background-pattern prior rows the device
reconstructs anyway — real candidate rows are bit-identical to the
single-device evaluator (pinned by tests/test_parallel.py and
``dryrun_multichip``). SURVEY.md §2.5: voxel-axis parallelism is the one
that maps; this is its dense-engine form.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from subcort_tpu.models.fcn import RF, fcn_forward_slab
from subcort_tpu.models.triplanar import DEFAULT_SPEC, TriPlanarSpec


def _local_fcn(params, slabs, vecs, cand, isbg, scal, los, his, *,
               want_probs: bool, spec: TriPlanarSpec, probs_dtype: str,
               raw_wire: bool, dev_dtype: str):
    """Per-device shard program: one sub-slab through the dense evaluator."""
    norm = None
    if raw_wire:
        norm = (scal, los[0], his[0], jnp.zeros((), jnp.dtype(dev_dtype)))
    labels, probs = fcn_forward_slab(
        params, slabs[0], vecs[0], want_probs, spec,
        probs_dtype=probs_dtype, norm=norm,
        cand_bits=cand[0], isbg_bits=isbg[0])
    return labels[None], (probs[None] if want_probs else probs)


# program cache: shard_map returns a fresh callable each call and jax.jit
# caches per callable — same recompile trap (and fix) as infer_sharded.py
_PROGRAM_CACHE: dict = {}


def _spmd_program(mesh: Mesh, want_probs: bool, probs_dtype: str,
                  spec: TriPlanarSpec, raw_wire: bool, dev_dtype: str):
    if not want_probs:
        probs_dtype = "uint8"  # dead arg: don't fork the program cache
    key = (tuple(d.id for d in mesh.devices.flat), mesh.axis_names,
           want_probs, probs_dtype, spec, raw_wire, dev_dtype)
    fn = _PROGRAM_CACHE.get(key)
    if fn is None:
        fn = jax.jit(jax.shard_map(
            partial(_local_fcn, want_probs=want_probs, spec=spec,
                    probs_dtype=probs_dtype, raw_wire=raw_wire,
                    dev_dtype=dev_dtype),
            mesh=mesh,
            in_specs=(P(), P("data"), P("data"), P("data"), P("data"), P(),
                      P("data"), P("data")),
            out_specs=(P("data"), P("data") if want_probs else P()),
        ))
        _PROGRAM_CACHE[key] = fn
    return fn


def fcn_run_spmd(params, image: np.ndarray, stats, atlas: np.ndarray,
                 lo, dims, shape, centers: np.ndarray,
                 label_vol: np.ndarray, prob_vol, want_probs: bool,
                 spec: TriPlanarSpec, prior_dtype, probs_dtype,
                 dev_dtype, mesh: Mesh) -> None:
    """Segment the candidate bbox with ONE sharded program over ``mesh``,
    scattering results into ``label_vol`` / ``prob_vol`` (same contract as
    engine.infer._fcn_run_bboxes, which remains the host-fan-out twin)."""
    from subcort_tpu.engine.infer import (_bg_prior_pattern, _dequantize_probs,
                                          _fcn_slab_inputs, _round_up_pow2)

    ndev = int(mesh.devices.size)
    axis = int(np.argmax(dims))
    step = -(-int(dims[axis]) // ndev)
    n_classes = atlas.shape[-1]
    bg_row = _bg_prior_pattern(n_classes, prior_dtype)

    # uniform per-shard prep (sub-regions may overhang the bbox/volume edge;
    # the slab cut zero-fills and no candidates live there)
    shards = []
    for d in range(ndev):
        sub_lo = np.asarray(lo, np.int32).copy()
        sub_lo[axis] += d * step
        sub_dims = list(int(v) for v in dims)
        sub_dims[axis] = step
        slab, vecs, cs, wire, norm = _fcn_slab_inputs(
            image, stats, atlas, sub_lo, tuple(sub_dims), shape, spec,
            prior_dtype, centers, force_sparse=True)
        if slab is None:  # no candidates in this shard: placeholder
            bx, by, bz = sub_dims
            raw = image.dtype.kind in "iu" and image.dtype.itemsize <= 2
            slab = np.zeros((bx + RF, by + RF, bz + RF),
                            image.dtype if raw else np.float32)
            mean, std = stats
            norm = ((np.array([mean, 1.0 / std], np.float32),
                     np.zeros(3, np.int32), np.zeros(3, np.int32))
                    if raw else None)
            vecs = np.zeros((0, n_classes), bg_row.dtype)
            from subcort_tpu.engine.infer import SparseWire
            wire = SparseWire(
                np.zeros((-(-bx * by * bz // 8),), np.uint8),   # no candidates
                np.zeros((0,), np.uint8), 0)                    # grown below
            cs = np.zeros((0, 3), np.int32)
        shards.append((slab, vecs, cs, wire, norm))

    if all(len(s[2]) == 0 for s in shards):
        return  # no candidates anywhere in this bbox: nothing to run

    raw_wire = shards[0][4] is not None

    # common row budgets across shards: padded candidate rows M (ladder rung
    # of the max shard) and shipped prior rows V (max compacted prefix) —
    # a shard's rows beyond its own counts are bg-flagged bitmask padding /
    # bg-pattern prior padding, dropped by the per-shard scatter below.
    # cand_bits lengths already match (equal sub_dims per shard).
    M = _round_up_pow2(max(s[3].m_pad for s in shards))
    V = max(1, max(s[1].shape[0] for s in shards))
    slabs = np.stack([s[0] for s in shards])
    cand = np.stack([s[3].cand_bits for s in shards])
    isbg = np.stack([  # pad to M/8 bytes with 0xFF (all-bg flags)
        np.pad(s[3].isbg_bits, (0, M // 8 - s[3].isbg_bits.shape[0]),
               constant_values=255)
        for s in shards])
    vecs = np.stack([
        np.concatenate([s[1], np.broadcast_to(
            bg_row, (V - s[1].shape[0], n_classes)).copy()])
        for s in shards])
    if raw_wire:
        scal = jnp.asarray(shards[0][4][0])
        los = np.stack([s[4][1] for s in shards])
        his = np.stack([s[4][2] for s in shards])
    else:
        scal = jnp.zeros((2,), jnp.float32)
        los = np.zeros((ndev, 3), np.int32)
        his = np.zeros((ndev, 3), np.int32)
        slabs = slabs.astype(jnp.dtype(dev_dtype), copy=False)

    fn = _spmd_program(mesh, want_probs, jnp.dtype(probs_dtype).name, spec,
                       raw_wire, jnp.dtype(dev_dtype).name)
    rep = NamedSharding(mesh, P())
    shd = NamedSharding(mesh, P("data"))
    labels_d, probs_d = fn(
        jax.device_put(params, rep), jax.device_put(slabs, shd),
        jax.device_put(vecs, shd), jax.device_put(cand, shd),
        jax.device_put(isbg, shd), jax.device_put(scal, rep),
        jax.device_put(los, shd), jax.device_put(his, shd))

    labels_h = np.asarray(labels_d)
    probs_h = np.asarray(probs_d) if want_probs else None
    for d, (_, _, cs, _, _) in enumerate(shards):
        m = len(cs)
        if m == 0:
            continue
        label_vol[cs[:, 0], cs[:, 1], cs[:, 2]] = labels_h[d, :m]
        if want_probs:
            prob_vol[cs[:, 0], cs[:, 1], cs[:, 2]] = \
                _dequantize_probs(probs_h[d])[:m]
