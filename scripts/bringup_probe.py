#!/usr/bin/env python
"""GPU measurements behind three bring-up choices: the FCN's f32
contraction precision, the training conv lowering, and whether the plain
XLA patch gather needs a hand-written kernel.

Runs on one NVIDIA GPU and exits non-zero without one. Prints one JSON line
per measurement, each with the card's name and power limit:

  fcn_precision  FCN slab device time at each f32 contraction precision on
                 the MNI bench scan (bench.py::make_scan), with label and
                 probability agreement against Precision.HIGHEST and label
                 agreement with the patch engine
  train_conv     one train step at batch 256 with lax (cuDNN) convs against
                 im2col convs, single-step and inside the K=32 scan
  gather_share   the XLA gather's share of device time in one train step and
                 one patch-engine chunk, from a jax.profiler trace (and from
                 timing the gather alone)

Usage:
    python scripts/bringup_probe.py [--out DIR] [--only NAME[,NAME]]
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def timed(fn, *args, repeats: int = 20) -> float:
    """Mean seconds per call after one warm-up call, synced with
    block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / repeats


def trace_ops(fn, args, trace_dir: str, repeats: int = 5) -> dict:
    """Device time per XLA op name over ``repeats`` calls of ``fn``.

    Reads the ``XLA Ops`` line of every GPU plane of the profiler trace, or
    where a plane has none, its ``Stream`` lines (kernel names); returns
    {op name: total ns}."""
    import jax
    from jax.profiler import ProfileData

    jax.block_until_ready(fn(*args))
    shutil.rmtree(trace_dir, ignore_errors=True)
    with jax.profiler.trace(trace_dir):
        for _ in range(repeats):
            out = fn(*args)
        jax.block_until_ready(out)
    path = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                     recursive=True)[0]
    ops: dict = {}
    lines_seen = set()
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        lines_seen.update(f"{plane.name}|{line.name}" for line in lines)
        pick = [l for l in lines if l.name == "XLA Ops"] or \
            [l for l in lines if l.name.startswith("Stream")]
        for line in pick:
            for ev in line.events:
                ops[ev.name] = ops.get(ev.name, 0.0) + ev.duration_ns
    if not ops:
        raise RuntimeError(f"no GPU op events; lines: {sorted(lines_seen)}")
    return ops


def gather_summary(ops: dict) -> dict:
    total = sum(ops.values())
    gather = sum(v for k, v in ops.items() if "gather" in k.lower())
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:12]
    return {"device_ns": total, "gather_ns": gather,
            "gather_share": gather / total if total else None,
            "top_ops": [[k, v] for k, v in top]}


# --------------------------------------------------------------- fcn precision
def probe_fcn_precision(info: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import lax
    from scipy import ndimage

    from bench import make_scan
    from subcort_tpu.engine.infer import (_bbox_of, _fcn_slab_inputs,
                                          segment_volume)
    from subcort_tpu.models import fcn, init_params
    from subcort_tpu.models.triplanar import DEFAULT_SPEC
    from subcort_tpu.ops import normalize_stats

    image, atlas, roi = make_scan(np.random.default_rng(0))
    params = jax.device_put(init_params(jax.random.key(0)))
    centers = np.stack(np.nonzero(ndimage.binary_dilation(roi, iterations=10)),
                       axis=1).astype(np.int32)
    sel = tuple(centers.T)
    lo, dims = _bbox_of(centers, image.shape)
    slab, vecs, _, wire, norm = _fcn_slab_inputs(
        image, normalize_stats(image), atlas, lo, dims, image.shape,
        DEFAULT_SPEC, np.uint16, centers)
    scal, nlo, nhi = norm
    staged = dict(
        slab=jax.device_put(slab), vecs=jax.device_put(vecs),
        cand_bits=jax.device_put(wire.cand_bits),
        isbg_bits=jax.device_put(wire.isbg_bits),
        norm=(jax.device_put(scal), jax.device_put(nlo), jax.device_put(nhi),
              jnp.zeros((), jnp.float32)))

    def device_call(p):
        return fcn.fcn_forward_slab(
            p, staged["slab"], staged["vecs"], want_probs=False,
            spec=DEFAULT_SPEC, probs_dtype="uint8",
            cand_bits=staged["cand_bits"], isbg_bits=staged["isbg_bits"],
            norm=staged["norm"])[0]

    patch_labels, _ = segment_volume(params, image, atlas, centers,
                                     engine="patch")
    default_prec = fcn.CONV_PRECISION
    ref = None
    for name in ("HIGHEST", "HIGH", "DEFAULT", "BF16_BF16_F32_X3",
                 "BF16_BF16_F32_X6", "TF32_TF32_F32_X3"):
        prec = getattr(lax.Precision, name, name)
        fcn.CONV_PRECISION = prec
        jax.clear_caches()
        rec = {"probe": "fcn_precision", "precision": name, **info}
        try:
            labels, probs = segment_volume(params, image, atlas, centers,
                                           engine="fcn", want_probs=True,
                                           probs_dtype=np.float32)
            rec["device_seconds"] = timed(device_call, params)
        except Exception as e:  # an algorithm XLA cannot lower for a conv
            rec["error"] = f"{type(e).__name__}: {str(e)[:300]}"
            emit(rec)
            continue
        if ref is None:
            ref = labels[sel], probs[sel]
        rec.update(
            candidate_voxels=int(len(centers)),
            labels_equal_highest=float((labels[sel] == ref[0]).mean()),
            prob_maxabs_vs_highest=float(np.abs(probs[sel] - ref[1]).max()),
            patch_agreement=float((labels[sel] == patch_labels[sel]).mean()))
        emit(rec)
    fcn.CONV_PRECISION = default_prec
    jax.clear_caches()


# ------------------------------------------------------------- train + gather
def _train_inputs(batch: int, k: int):
    import jax
    import numpy as np

    rng = np.random.default_rng(0)
    shape = (181, 217, 181)
    vols = rng.standard_normal(
        (2,) + tuple(s + 32 for s in shape)).astype(np.float32)

    def centers(n):
        return np.stack([rng.integers(0, 2, n)] +
                        [rng.integers(0, s, n) for s in shape],
                        axis=1).astype(np.int32)

    one = (centers(batch), rng.integers(0, 15, batch).astype(np.int32),
           rng.random((batch, 15)).astype(np.float32))
    multi = (centers(batch * k).reshape(k, batch, 4),
             rng.integers(0, 15, (k, batch)).astype(np.int32),
             rng.random((k, batch, 15)).astype(np.float32))
    put = jax.device_put
    return put(vols), [put(x) for x in one], [put(x) for x in multi]


def probe_train_conv(info: dict, out: str) -> None:
    import jax
    import optax

    from subcort_tpu.engine.train import (gather_triplanar_subjects,
                                          make_train_multistep,
                                          make_train_step)
    from subcort_tpu.models import init_params
    from subcort_tpu.models.triplanar import DEFAULT_SPEC

    batch, k = 256, 32
    vols, (c, l, a), (ck, lk, ak) = _train_inputs(batch, k)
    opt = optax.adam(1e-3)
    key = jax.random.key(1)
    losses = {}
    for impl in ("xla", "im2col"):
        spec = dataclasses.replace(DEFAULT_SPEC, conv_impl=impl)
        params = jax.device_put(init_params(jax.random.key(0), spec))
        state = opt.init(params)
        step = make_train_step(opt, spec)
        multi = make_train_multistep(opt, spec)
        losses[impl] = float(step(params, state, vols, c, l, a, key)[2])
        rec = {"probe": "train_conv", "conv_impl": impl, "batch": batch,
               "step_seconds": timed(step, params, state, vols, c, l, a, key),
               "scan_step_seconds": timed(multi, params, state, vols, ck, lk,
                                          ak, key, repeats=5) / k,
               "loss": losses[impl], **info}
        ops = trace_ops(step, (params, state, vols, c, l, a, key),
                        os.path.join(out, f"trace_train_{impl}"))
        rec.update(gather_summary(ops))
        emit(rec)

    gather = jax.jit(lambda v, cc: gather_triplanar_subjects(v, cc))
    emit({"probe": "gather_share", "path": "train_step_gather_alone",
          "batch": batch, "gather_seconds": timed(gather, vols, c),
          "loss_rel_diff_xla_vs_im2col":
              abs(losses["xla"] - losses["im2col"]) / abs(losses["xla"]),
          **info})


def probe_patch_chunk(info: dict, out: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from subcort_tpu.engine.infer import DEFAULT_CHUNK, _forward_centers
    from subcort_tpu.models import init_params
    from subcort_tpu.ops import gather_triplanar, pad_volume

    rng = np.random.default_rng(0)
    shape = (181, 217, 181)
    padded = jax.device_put(pad_volume(jnp.asarray(
        rng.standard_normal(shape).astype(np.float32))))
    n = DEFAULT_CHUNK
    centers = jax.device_put(np.stack([rng.integers(0, s, n) for s in shape],
                                      axis=1).astype(np.int32))
    vecs = jax.device_put(rng.random((n, 15)).astype(np.float32))
    params = jax.device_put(init_params(jax.random.key(0)))

    def chunk_fn(p, v, c, a):
        return _forward_centers(p, v, c, a, n, False)[0]

    rec = {"probe": "gather_share", "path": "patch_chunk", "chunk": n,
           "chunk_seconds": timed(chunk_fn, params, padded, centers, vecs),
           "gather_seconds": timed(jax.jit(gather_triplanar), padded,
                                   centers), **info}
    rec.update(gather_summary(trace_ops(
        chunk_fn, (params, padded, centers, vecs),
        os.path.join(out, "trace_patch_chunk"))))
    emit(rec)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "probe"))
    ap.add_argument("--only", default="fcn_precision,train_conv,patch_chunk")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bringup_probe: needs an NVIDIA GPU, found {jax.devices()}",
              file=sys.stderr)
        return 1
    from subcort_tpu.utils import enable_compilation_cache
    enable_compilation_cache()
    os.makedirs(args.out, exist_ok=True)
    info = {"card": card(), "device_kind": dev.device_kind}
    only = set(args.only.split(","))
    if "fcn_precision" in only:
        probe_fcn_precision(info)
    if "train_conv" in only:
        probe_train_conv(info, args.out)
    if "patch_chunk" in only:
        probe_patch_chunk(info, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
