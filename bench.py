#!/usr/bin/env python
"""Headline benchmark: full-scan voxelwise segmentation on one NVIDIA GPU.

Reproduces the reference's production inference configuration
(BASELINE.md workload 3: speedup_segmentation=True — atlas-ROI cropped
candidate set, pretrained miccai2012_v1 weights, 15-class labels) on an
MNI-sized synthetic scan, and reports per-scan wall-clock + voxel
throughput.

Baseline: the reference records no per-scan number (BASELINE.md); the
north-star target is < 5 s/scan on one GPU. ``vs_baseline`` is
therefore reported against that 5 s target (>1.0 = faster than target).
Needs a GPU: without one it exits non-zero before measuring anything.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

import jax  # noqa: E402

from subcort_tpu.utils import enable_compilation_cache  # noqa: E402

enable_compilation_cache()  # fresh-process runs reuse earlier compiles

from subcort_tpu.engine.infer import segment_volume  # noqa: E402
from subcort_tpu.models import load_theano_checkpoint, init_params  # noqa: E402

REF_CKPT = "/root/reference/nets/miccai2012_v1/miccai2012_v1.pkl"
TARGET_SECONDS = 5.0  # north-star: <5 s/scan on one GPU (BASELINE.md)


def make_scan(rng):
    """MNI-dimension synthetic T1 + prior atlas + subcortical ROI."""
    shape = (181, 217, 181)
    # int16 voxels: the dtype real T1 NIfTIs ship with — exercises the
    # raw-slab wire path (device-side normalization, half the h2d bytes)
    image = np.zeros(shape, np.int16)
    # brain-ish ellipsoid of nonzero intensities
    x, y, z = np.ogrid[:shape[0], :shape[1], :shape[2]]
    brain = (((x - 90) / 80.0) ** 2 + ((y - 108) / 95.0) ** 2
             + ((z - 90) / 78.0) ** 2) < 1.0
    image[brain] = (rng.random(int(brain.sum())) * 800 + 100).astype(np.int16)

    atlas = np.zeros(shape + (15,), np.float32)
    atlas[..., 14] = 1.0
    # subcortical blob: central region with structure priors
    roi = (((x - 90) / 28.0) ** 2 + ((y - 108) / 32.0) ** 2
           + ((z - 90) / 26.0) ** 2) < 1.0
    n_roi = int(roi.sum())
    pri = rng.random((n_roi, 15)).astype(np.float32)
    pri /= pri.sum(1, keepdims=True)
    atlas[roi] = pri
    return image, atlas, roi


def main():
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py: needs an NVIDIA GPU, JAX found {jax.devices()}")
    rng = np.random.default_rng(0)
    image, atlas, roi = make_scan(rng)

    if os.path.exists(REF_CKPT):
        params = load_theano_checkpoint(REF_CKPT)
    else:  # fall back so the bench runs standalone
        params = init_params(jax.random.key(0))
    params = jax.device_put(params)

    # candidate voxels: dilated subcortical ROI (reference crop semantics)
    from scipy import ndimage
    b_mask = ndimage.binary_dilation(roi, iterations=10)
    centers = np.stack(np.nonzero(b_mask), axis=1).astype(np.int32)
    n_vox = centers.shape[0]

    from subcort_tpu.engine.postprocess import post_process_segmentation

    # warm-up: compile the device programs (first compile excluded, as the
    # reference's Theano compile would be)
    labels, _ = segment_volume(params, image, atlas, centers)
    _ = segment_volume(params, image, atlas, centers, want_probs=True)

    # repeat-timing policy: each configuration runs REPEATS times; `value`
    # is the min and the median/n are reported alongside so artifact
    # readers can judge noise.
    REPEATS = max(1, int(os.environ.get("SUBCORT_BENCH_REPEATS", "9")))

    # headline: the reference's default production config
    # (speedup_segmentation=True + post_process=True, configuration.cfg).
    def run_exact():
        nonlocal labels
        labels, _ = segment_volume(params, image, atlas, centers)
        post_process_segmentation(None, labels, atlas_mask=roi)

    # secondary: fast profile — bfloat16 activations + uint8 prior
    # transfer (half the host->device bytes). Lossy by design; label
    # agreement vs the exact path is reported alongside.
    fast_kw = dict(compute_dtype="bfloat16", prior_dtype=np.uint8)
    labels_fast, _ = segment_volume(params, image, atlas, centers, **fast_kw)

    def run_fast():
        nonlocal labels_fast
        labels_fast, _ = segment_volume(params, image, atlas, centers,
                                        **fast_kw)
        post_process_segmentation(None, labels_fast, atlas_mask=roi)

    # secondary: + 15-class probability maps (out_probabilities=True)
    def run_probs():
        labels_p, _ = segment_volume(params, image, atlas, centers,
                                     want_probs=True)
        post_process_segmentation(None, labels_p, atlas_mask=roi)

    # run the three configurations INTERLEAVED so they sample the same
    # machine state, then take per-config min and median
    labels = None
    samples = {"exact": [], "fast": [], "probs": []}
    for _ in range(REPEATS):
        for name, fn in (("exact", run_exact), ("fast", run_fast),
                         ("probs", run_probs)):
            t0 = time.perf_counter()
            fn()
            samples[name].append(time.perf_counter() - t0)

    def stats(name):
        ts = sorted(samples[name])
        return ts[0], ts[len(ts) // 2]

    per_scan, per_scan_med = stats("exact")
    fast_per_scan, fast_med = stats("fast")
    with_probs, with_probs_med = stats("probs")

    # ---- device-time split (VERDICT r4 missing-3): this times the SAME
    # jitted slab programs the headline configs run, but with all inputs
    # pre-staged on device. Sync is one small (M,) uint8 label readback
    # after `repeats` queued executions, so the per-call number carries
    # <=1/8 of one ~0.5 MB readback — an upper bound on device time.
    import jax.numpy as jnp

    from subcort_tpu.engine.infer import _bbox_of, _fcn_slab_inputs
    from subcort_tpu.models.fcn import fcn_forward_slab, slab_flops
    from subcort_tpu.models.triplanar import DEFAULT_SPEC
    from subcort_tpu.ops import normalize_stats

    nstats = normalize_stats(image)
    lo, dims = _bbox_of(centers, image.shape)

    def time_device(p, dev_dtype, prior_dtype, repeats=8):
        # prior dtypes mirror the configs above (exact: uint16, fast: uint8)
        # so these are the already-compiled headline programs — no fresh
        # compile is triggered here
        slab, vecs, _, wire, norm = _fcn_slab_inputs(
            image, nstats, atlas, lo, dims, image.shape, DEFAULT_SPEC,
            prior_dtype, centers)
        slab_d = jax.device_put(jnp.asarray(slab))
        vecs_d = jax.device_put(jnp.asarray(vecs))
        cand_d = jax.device_put(jnp.asarray(wire.cand_bits))
        isbg_d = jax.device_put(jnp.asarray(wire.isbg_bits))
        if norm is not None:
            scal, nlo, nhi = norm
            norm_d = (jax.device_put(jnp.asarray(scal)),
                      jax.device_put(jnp.asarray(nlo)),
                      jax.device_put(jnp.asarray(nhi)),
                      jnp.zeros((), dev_dtype))
        else:
            norm_d = None
            slab_d = jax.device_put(jnp.asarray(slab, dev_dtype))
        args = dict(want_probs=False, spec=DEFAULT_SPEC, probs_dtype="uint8",
                    cand_bits=cand_d, isbg_bits=isbg_d, norm=norm_d)
        lab, _ = fcn_forward_slab(p, slab_d, vecs_d, **args)
        np.asarray(lab)  # warm-up (compile-cache hit) + queue drain
        t0 = time.perf_counter()
        for _ in range(repeats):
            lab, _ = fcn_forward_slab(p, slab_d, vecs_d, **args)
        np.asarray(lab)
        return (time.perf_counter() - t0) / repeats, int(wire.m_pad)

    device_f32, m_rows = time_device(params, jnp.float32, np.uint16)
    params_bf16 = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.bfloat16), params)
    device_bf16, _ = time_device(params_bf16, jnp.bfloat16, np.uint8)
    # FLOPs actually executed on device: dense à-trous branches over the
    # align-16 bbox + head MLP over the pow2-padded gathered rows
    flops = slab_flops(dims, m_rows=m_rows)

    # quality canary: the two independent engines (dense à-trous vs XLA
    # patch gather) must agree at scale — catches silent numerical drift
    labels_patch, _ = segment_volume(params, image, atlas, centers,
                                     engine="patch")
    sel = centers[:, 0], centers[:, 1], centers[:, 2]
    agreement = float((labels[sel] == labels_patch[sel]).mean())

    # independent oracle canary: the pure-numpy Lasagne-semantics forward
    # (tests/lasagne_oracle.py, the same functional oracle the parity tests
    # pin against) on a voxel sample of this full-scale scan. Drift common
    # to both JAX engines (e.g. in the model itself) would pass the
    # engine-agreement check but fail here.
    oracle_agreement = None
    if os.path.exists(REF_CKPT):
        sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tests"))
        import lasagne_oracle as oracle

        from subcort_tpu.ops import normalize_nonzero
        from subcort_tpu.ops.patches import gather_triplanar_np

        raw = oracle.load_raw(REF_CKPT)
        # 256 samples ≈ 90 s of float64 numpy — enough resolution to flag
        # drift (1 disagreement = 0.996) without dominating bench wall-clock
        n_oracle = int(os.environ.get("SUBCORT_BENCH_ORACLE_N", "256"))
        sub = centers[rng.choice(n_vox, size=n_oracle, replace=False)]
        norm, _, _ = normalize_nonzero(image)
        ax, co, sa = gather_triplanar_np(norm, sub)
        vec = atlas[sub[:, 0], sub[:, 1], sub[:, 2]].astype(np.float32).copy()
        empty = vec.sum(1) == 0
        vec[empty] = 0.0
        vec[empty, 14] = 1.0
        want = oracle.forward(raw, ax[:, None], co[:, None], sa[:, None],
                              vec).argmax(1)
        got = labels[sub[:, 0], sub[:, 1], sub[:, 2]]
        oracle_agreement = float((got == want).mean())

    print(json.dumps({
        "metric": "per_scan_segmentation_wallclock",
        "value": round(per_scan, 4),
        "fcn_vs_patch_agreement": round(agreement, 6),
        "oracle_agreement": (round(oracle_agreement, 6)
                             if oracle_agreement is not None else None),
        "unit": "seconds",
        "vs_baseline": round(TARGET_SECONDS / per_scan, 3),
        "median_seconds": round(per_scan_med, 4),
        "n_repeats": REPEATS,
        "voxels_per_sec_per_chip": int(n_vox / per_scan),
        # device/host split: device_seconds times the identical jitted slab
        # program with pre-staged inputs; host_wire_seconds is the remainder
        # of the headline number (transfers + host prep + post-process)
        "device_seconds": round(device_f32, 4),
        "bf16_device_seconds": round(device_bf16, 4),
        "host_wire_seconds": round(per_scan - device_f32, 4),
        "est_flops_per_scan": int(flops),
        "with_prob_maps_seconds": round(with_probs, 4),
        "with_prob_maps_median": round(with_probs_med, 4),
        "bf16_fast_seconds": round(fast_per_scan, 4),
        "bf16_fast_median": round(fast_med, 4),
        "bf16_fast_agreement": round(
            float((labels[sel] == labels_fast[sel]).mean()), 6),
        "candidate_voxels": int(n_vox),
        "volume_shape": list(image.shape),
        "includes_post_process": True,
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
        "checkpoint": "miccai2012_v1" if os.path.exists(REF_CKPT) else "random-init",
    }))


if __name__ == "__main__":
    main()
