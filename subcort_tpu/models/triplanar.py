"""Tri-planar voxelwise CNN — functional JAX implementation.

Architecture parity target (reference: cnn_cort/nets.py:159-231, verified
against the shipped ``miccai2012_v1.pkl``):

Three identical 2D branches (axial / coronal / sagittal), input (N, 32, 32, 1):

    conv 3x3 x20 -> BN -> PReLU    (32->30)
    conv 3x3 x20 -> BN -> PReLU    (30->28)
    maxpool 2                      (28->14)
    conv 3x3 x40 -> BN -> PReLU    (14->12)
    conv 3x3 x40 -> BN -> PReLU    (12->10)
    maxpool 2                      (10->5)
    conv 3x3 x60 -> BN -> PReLU    (5->3)
    dropout 0.5
    dense 540->180 -> PReLU

Head: concat(3x180) -> dropout -> FC 540->540 -> PReLU -> dropout ->
concat(+15 atlas) -> FC 555->270 -> PReLU -> FC 270->15 -> softmax.
Total params: 883,455.

Lasagne semantics preserved exactly (for checkpoint-level parity):

- ``batch_norm(Conv2D(...))`` strips the conv bias; convs are W-only
  (nets.py:171 et al. — the pickle confirms 1 param per conv).
- Lasagne Conv2D ``flip_filters=True`` is a *true* convolution; JAX convs are
  cross-correlations, so imported kernels are spatially flipped (importer.py).
- BN stores (beta, gamma, mean, inv_std); inference computes
  ``(x - mean) * inv_std * gamma + beta`` with the *stored* inv_std
  (epsilon is baked in at train time; Lasagne default eps=1e-4).
- ``prelu(layer)`` replaces the wrapped layer's nonlinearity with identity
  and appends a ParametricRectifier: f(x) = max(x,0) + alpha*min(x,0),
  alpha per channel (conv) / per unit (dense).
- Dropout (p=0.5) is inverted dropout (train scales by 1/(1-p)); identity in
  inference mode.
- Dense-after-conv flattens in Lasagne's C-order over (channels, h, w); we
  run NHWC, so the importer permutes dense rows accordingly.

Design notes: NHWC layout, conv via ``lax.conv_general_dilated``, all dims
static, single fused jit. Weights live in ``param_dtype`` (float32);
activations can run in bfloat16 via ``compute_dtype``.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
from jax import lax

Params = Dict[str, Any]

VIEWS = ("axial", "coronal", "sagittal")


@dataclasses.dataclass(frozen=True)
class TriPlanarSpec:
    """Static hyper-parameters (reference defaults: nets.py:159-164)."""
    patch_size: int = 32
    num_channels: int = 1
    conv_filters: tuple = (20, 20, 40, 40, 60)
    fc_conv: int = 180          # per-branch dense width
    fc_fc: int = 540            # head FC1 width
    fc2: int = 270              # head FC2 width
    num_classes: int = 15
    atlas_dim: int = 15
    dropout_conv: float = 0.5
    dropout_fc: float = 0.5
    bn_epsilon: float = 1e-4    # Lasagne BatchNormLayer default
    bn_alpha: float = 1e-2      # Lasagne running-average coefficient
    # conv lowering: 'xla' = lax.conv_general_dilated (cuDNN; used for
    # inference); 'im2col' = static-slice + matmul (used for training, see
    # engine/train.py TRAIN_CONV_IMPL for the measurement behind it).
    conv_impl: str = "xla"

    @property
    def branch_flat(self) -> int:
        # after two 2x pools and five valid 3x3 convs: 32->30->28->14->12->10->5->3
        s = self.patch_size
        s = (s - 2 - 2) // 2
        s = (s - 2 - 2) // 2
        s = s - 2
        if s <= 0:
            raise ValueError(
                f"patch_size={self.patch_size} too small for the conv stack "
                f"(two 2x pools + five valid 3x3 convs need >= 24)")
        return s * s * self.conv_filters[4]


DEFAULT_SPEC = TriPlanarSpec()


# --------------------------------------------------------------------------- init
def _glorot(key, shape, fan_in, fan_out, dtype):
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return jax.random.uniform(key, shape, dtype, -limit, limit)


def _init_branch(key, spec: TriPlanarSpec, dtype) -> Params:
    p: Params = {}
    keys = jax.random.split(key, 8)
    c_in = spec.num_channels
    for i, c_out in enumerate(spec.conv_filters, start=1):
        fan_in, fan_out = c_in * 9, c_out * 9
        p[f"conv{i}"] = {"w": _glorot(keys[i - 1], (3, 3, c_in, c_out), fan_in, fan_out, dtype)}
        p[f"bn{i}"] = {
            "beta": jnp.zeros((c_out,), dtype),
            "gamma": jnp.ones((c_out,), dtype),
            "mean": jnp.zeros((c_out,), dtype),
            "inv_std": jnp.ones((c_out,), dtype),
        }
        p[f"prelu{i}"] = jnp.full((c_out,), 0.25, dtype)
        c_in = c_out
    flat = spec.branch_flat
    p["d1"] = {
        "w": _glorot(keys[5], (flat, spec.fc_conv), flat, spec.fc_conv, dtype),
        "b": jnp.zeros((spec.fc_conv,), dtype),
    }
    p["prelu_d1"] = jnp.full((spec.fc_conv,), 0.25, dtype)
    return p


def init_params(key: jax.Array, spec: TriPlanarSpec = DEFAULT_SPEC,
                dtype=jnp.float32) -> Params:
    """Fresh parameters with Lasagne-default initializers.

    GlorotUniform for conv/dense W, zero biases, PReLU alpha=0.25, BN
    (beta=0, gamma=1, mean=0, inv_std=1) — matching what ``build_model``
    (nets.py:127-255) starts from.
    """
    ka, kc, ks, k1, k2, k3 = jax.random.split(key, 6)
    concat = 3 * spec.fc_conv
    head = {
        "fc1": {
            "w": _glorot(k1, (concat, spec.fc_fc), concat, spec.fc_fc, dtype),
            "b": jnp.zeros((spec.fc_fc,), dtype),
        },
        "prelu_f1": jnp.full((spec.fc_fc,), 0.25, dtype),
        "fc2": {
            "w": _glorot(k2, (spec.fc_fc + spec.atlas_dim, spec.fc2),
                         spec.fc_fc + spec.atlas_dim, spec.fc2, dtype),
            "b": jnp.zeros((spec.fc2,), dtype),
        },
        "prelu_f2": jnp.full((spec.fc2,), 0.25, dtype),
        "out": {
            "w": _glorot(k3, (spec.fc2, spec.num_classes), spec.fc2, spec.num_classes, dtype),
            "b": jnp.zeros((spec.num_classes,), dtype),
        },
    }
    return {
        "axial": _init_branch(ka, spec, dtype),
        "coronal": _init_branch(kc, spec, dtype),
        "sagittal": _init_branch(ks, spec, dtype),
        "head": head,
    }


def num_params(params: Params) -> int:
    return sum(int(x.size) for x in jax.tree_util.tree_leaves(params))


# --------------------------------------------------------------------------- ops
def _prelu(x, alpha):
    return jnp.maximum(x, 0) + alpha * jnp.minimum(x, 0)


def _conv2d_valid(x, w):
    """NHWC valid cross-correlation (kernels pre-flipped by the importer).

    Precision HIGHEST: the GPU's default f32 conv runs in TF32 (a 10-bit
    mantissa), which is too loose for checkpoint-level parity with the
    Theano reference; bfloat16 mode is the explicit opt-in via
    Options.compute_dtype.
    """
    # preferred_element_type=f32 only when x is f32: with bf16 operands the
    # conv TRANSPOSE rule rejects the f32 cotangent against bf16 kernels
    # (lax.conv requires matching dtypes), which breaks mixed-precision
    # training through this path. bf16 convs accumulate in f32 inside the
    # conv regardless, so dropping the annotation loses nothing there.
    pet = jnp.float32 if x.dtype == jnp.float32 else None
    return lax.conv_general_dilated(
        x, w, window_strides=(1, 1), padding="VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=pet,
        precision=lax.Precision.HIGHEST,
    ).astype(x.dtype)


def _dense(x, w, b):
    out = lax.dot_general(x, w, (((1,), (0,)), ((), ())),
                          precision=lax.Precision.HIGHEST,
                          preferred_element_type=jnp.float32)
    return out.astype(x.dtype) + b


def _conv2d_valid_im2col(x, w):
    """3x3 valid conv as 9 static slices + one matmul.

    Same math as :func:`_conv2d_valid` (tolerances: float reassociation
    only). All forward/backward ops are slices, pads and dot_generals.
    (h, w) tap order matches the HWIO kernel layout.

    Layout: taps are concatenated on the CHANNEL axis — (tap, channel)
    order, identical to the (kh, kw, c) kernel flatten — and the
    contraction runs over that last dim directly, keeping (N, oh, ow) as
    untouched batch dims, so no relayout copy is needed.
    """
    n, h, wd, c = x.shape
    kh, kw, _, o = w.shape
    oh, ow = h - kh + 1, wd - kw + 1
    taps = [x[:, i:i + oh, j:j + ow, :] for i in range(kh) for j in range(kw)]
    patches = jnp.concatenate(taps, axis=-1)             # (N, oh, ow, 9C)
    rhs = w.reshape(kh * kw * c, o)
    out = lax.dot_general(patches, rhs, (((3,), (0,)), ((), ())),
                          precision=lax.Precision.HIGHEST,
                          preferred_element_type=jnp.float32)
    return out.astype(x.dtype)


def _conv(x, w, impl: str):
    return _conv2d_valid_im2col(x, w) if impl == "im2col" else _conv2d_valid(x, w)


def _maxpool2(x):
    """2x2 max pool, stride 2, floor mode (Lasagne MaxPool2DLayer default)."""
    return lax.reduce_window(
        x, -jnp.inf if jnp.issubdtype(x.dtype, jnp.floating) else jnp.iinfo(x.dtype).min,
        lax.max, (1, 2, 2, 1), (1, 2, 2, 1), "VALID")


def _bn_inference(x, bn):
    scale = bn["inv_std"] * bn["gamma"]
    return (x - bn["mean"]) * scale + bn["beta"]


def _bn_train(x, bn, spec: TriPlanarSpec, axes):
    """Batch statistics over ``axes``; returns (y, batch_mean, batch_inv_std)."""
    mean = jnp.mean(x, axis=axes)
    var = jnp.var(x, axis=axes)
    inv_std = lax.rsqrt(var + spec.bn_epsilon)
    y = (x - mean) * (inv_std * bn["gamma"]) + bn["beta"]
    return y, mean, inv_std


def _dropout(x, rate, rng):
    keep = 1.0 - rate
    mask = jax.random.bernoulli(rng, keep, x.shape)
    return jnp.where(mask, x / keep, 0.0).astype(x.dtype)


# --------------------------------------------------------------------------- fwd
def apply_branch(bp: Params, x: jnp.ndarray, spec: TriPlanarSpec = DEFAULT_SPEC,
                 train: bool = False, rng: Optional[jax.Array] = None,
                 new_stats: Optional[dict] = None) -> jnp.ndarray:
    """One 2D branch: (N, ps, ps, 1) -> (N, fc_conv).

    In train mode, batch statistics are used for BN and, if ``new_stats`` is
    passed (a dict), per-layer (mean, inv_std) are recorded for the EMA
    update in the caller.
    """
    for i in (1, 2, 3, 4, 5):
        x = _conv(x, bp[f"conv{i}"]["w"], spec.conv_impl)
        if train:
            x, m, s = _bn_train(x, bp[f"bn{i}"], spec, axes=(0, 1, 2))
            if new_stats is not None:
                new_stats[f"bn{i}"] = (m, s)
        else:
            x = _bn_inference(x, bp[f"bn{i}"])
        x = _prelu(x, bp[f"prelu{i}"])
        if i in (2, 4):
            x = _maxpool2(x)
    if train:
        rng, sub = jax.random.split(rng)
        x = _dropout(x, spec.dropout_conv, sub)
    # Flatten. NHWC flatten order is (h, w, c); the importer permutes the
    # reference's (c, h, w)-ordered dense rows to match, so no transpose here.
    x = x.reshape(x.shape[0], -1)
    x = _dense(x, bp["d1"]["w"], bp["d1"]["b"])
    return _prelu(x, bp["prelu_d1"])


def apply(params: Params, batch: Dict[str, jnp.ndarray],
          spec: TriPlanarSpec = DEFAULT_SPEC, train: bool = False,
          rng: Optional[jax.Array] = None, return_logits: bool = False,
          batch_stats_out: Optional[dict] = None) -> jnp.ndarray:
    """Full forward pass.

    ``batch`` accepts either framework keys ('axial','coronal','sagittal',
    'atlas') or the reference's nolearn input names ('in1'..'in4',
    base.py:425-428). Patch arrays may be (N, ps, ps) or (N, ps, ps, 1);
    the reference's NCHW (N, 1, ps, ps) is also accepted and transposed.

    Returns softmax probabilities (or logits if ``return_logits``).
    """
    def _get(k_new, k_ref):
        x = batch.get(k_new, batch.get(k_ref))
        if x is None:
            raise KeyError(f"batch missing input '{k_new}'/'{k_ref}'")
        return x

    def _patches(x):
        x = jnp.asarray(x)
        if x.ndim == 3:
            x = x[..., None]
        elif x.ndim == 4 and x.shape[1] == spec.num_channels and x.shape[-1] != spec.num_channels:
            x = jnp.transpose(x, (0, 2, 3, 1))  # NCHW (reference layout) -> NHWC
        return x

    xa = _patches(_get("axial", "in1"))
    xc = _patches(_get("coronal", "in2"))
    xs = _patches(_get("sagittal", "in3"))
    atlas = jnp.asarray(_get("atlas", "in4"))

    rngs = jax.random.split(rng, 5) if train else [None] * 5
    stats = {v: {} for v in VIEWS} if batch_stats_out is not None else {v: None for v in VIEWS}

    fa = apply_branch(params["axial"], xa, spec, train, rngs[0], stats["axial"])
    fc = apply_branch(params["coronal"], xc, spec, train, rngs[1], stats["coronal"])
    fs = apply_branch(params["sagittal"], xs, spec, train, rngs[2], stats["sagittal"])
    if batch_stats_out is not None:
        batch_stats_out.update(stats)

    h = params["head"]
    x = jnp.concatenate([fa, fc, fs], axis=1)
    if train:
        x = _dropout(x, spec.dropout_fc, rngs[3])
    x = _prelu(_dense(x, h["fc1"]["w"], h["fc1"]["b"]), h["prelu_f1"])
    if train:
        x = _dropout(x, spec.dropout_fc, rngs[4])
    # Atlas prior joins here *without* dropout: the reference builds an atlas
    # dropout layer then immediately overwrites it with a plain InputLayer
    # (nets.py:222-223), so atlas dropout is effectively disabled.
    x = jnp.concatenate([x, atlas.astype(x.dtype)], axis=1)
    x = _prelu(_dense(x, h["fc2"]["w"], h["fc2"]["b"]), h["prelu_f2"])
    logits = _dense(x, h["out"]["w"], h["out"]["b"])
    if return_logits:
        return logits
    return jax.nn.softmax(logits, axis=-1)


def update_bn_ema(params: Params, batch_stats: dict,
                  spec: TriPlanarSpec = DEFAULT_SPEC) -> Params:
    """Exponential-moving-average update of stored BN (mean, inv_std).

    Lasagne BatchNormLayer keeps running averages with coefficient
    ``alpha`` (default 1e-2): stored = (1-alpha)*stored + alpha*batch.
    """
    a = spec.bn_alpha
    new = jax.tree_util.tree_map(lambda x: x, params)  # shallow-ish copy
    for view in VIEWS:
        for name, (m, s) in batch_stats.get(view, {}).items():
            bn = dict(new[view][name])
            bn["mean"] = (1 - a) * bn["mean"] + a * m
            bn["inv_std"] = (1 - a) * bn["inv_std"] + a * s
            new[view] = {**new[view], name: bn}
    return new


# Convenience jitted entry points -------------------------------------------------
@partial(jax.jit, static_argnames=("return_logits",))
def predict_proba(params: Params, batch: Dict[str, jnp.ndarray],
                  return_logits: bool = False) -> jnp.ndarray:
    """Jitted inference: softmax probabilities (reference: net.predict_proba)."""
    return apply(params, batch, train=False, return_logits=return_logits)


@jax.jit
def predict(params: Params, batch: Dict[str, jnp.ndarray]) -> jnp.ndarray:
    """Jitted inference: argmax class ids (reference: net.predict)."""
    return jnp.argmax(apply(params, batch, train=False, return_logits=True), axis=-1)


@partial(jax.jit, static_argnames=("chunk",))
def predict_proba_chunked(params: Params, batch: Dict[str, jnp.ndarray],
                          chunk: int = 8192) -> jnp.ndarray:
    """Memory-bounded inference over an arbitrarily large patch batch.

    The reference feeds 100k-patch batches to ``net.predict`` (base.py:379,
    425), which nolearn silently re-chunks at batch 128 on host. Here the
    whole batch stays in HBM and a ``lax.scan`` over ``chunk``-sized
    micro-batches bounds activation temps (a monolithic 100k forward needs
    ~7 GB for conv1 activations alone). The input is
    zero-padded to a chunk multiple; padded rows are computed and discarded
    — shapes stay static for XLA.
    """
    def std(x, d=3):
        x = jnp.asarray(x)
        if x.ndim == d:
            x = x[..., None] if d == 3 else x
        elif d == 3 and x.ndim == 4 and x.shape[1] == 1 and x.shape[-1] != 1:
            x = jnp.transpose(x, (0, 2, 3, 1))
        return x

    xa = std(batch.get("axial", batch.get("in1")))
    xc = std(batch.get("coronal", batch.get("in2")))
    xs = std(batch.get("sagittal", batch.get("in3")))
    at = jnp.asarray(batch.get("atlas", batch.get("in4")))

    n = xa.shape[0]
    n_chunks = max(1, -(-n // chunk))
    pad = n_chunks * chunk - n

    def prep(x):
        x = jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))
        return x.reshape((n_chunks, chunk) + x.shape[1:])

    xa, xc, xs, at = prep(xa), prep(xc), prep(xs), prep(at)

    def body(carry, inp):
        a, c, s, v = inp
        probs = apply(params, {"axial": a, "coronal": c, "sagittal": s,
                               "atlas": v}, train=False)
        return carry, probs

    _, probs = lax.scan(body, None, (xa, xc, xs, at))
    return probs.reshape(n_chunks * chunk, -1)[:n]
