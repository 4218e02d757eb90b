"""Theano/Lasagne checkpoint importer/exporter.

The reference ships its trained model as a Python-2 pickle of an OrderedDict
mapping Lasagne layer names to parameter lists
(``nets/miccai2012_v1/miccai2012_v1.pkl``, written by nolearn SaveWeights,
nets.py:155,239). This module converts that format to/from this framework's
params pytree, handling every representational difference:

- Lasagne ``Conv2DLayer`` defaults to ``flip_filters=True`` (true
  convolution); JAX convs are cross-correlations -> kernels are flipped
  spatially on import and stored OIHW -> HWIO for the NHWC layout.
- Lasagne BN parameter order is [beta, gamma, mean, inv_std]; inv_std is
  stored directly (eps baked in).
- Dense-after-conv rows are ordered C-style over (channels, h, w) in
  Lasagne's NCHW world; our NHWC flatten is (h, w, c), so d1's weight rows
  are permuted on import.
- The reference spells sagittal 'saggital' (nets.py:202-212); mapped here.

Layer-name contract (pickle keys, verified against the shipped checkpoint):
``{view}_ch_conv{i}`` / ``{view}_ch_conv{i}_bn`` / ``{view}_ch_prelu{i}`` /
``{view}_d1`` / ``{view}_prelu_d1`` / ``FC1`` / ``prelu_f1`` / ``fc_2`` /
``prelu_f2`` / ``out_layer``.
"""

from __future__ import annotations

import collections
import pickle
from typing import Any, Dict

import numpy as np

from subcort_tpu.models.triplanar import DEFAULT_SPEC, TriPlanarSpec

_REF_VIEW = {"axial": "axial", "coronal": "coronal", "sagittal": "saggital"}


def _conv_w_to_jax(w_oihw: np.ndarray) -> np.ndarray:
    """OIHW true-convolution kernel -> HWIO cross-correlation kernel."""
    w = np.asarray(w_oihw, dtype=np.float32)[:, :, ::-1, ::-1]  # flip H, W
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))  # -> HWIO


def _conv_w_from_jax(w_hwio: np.ndarray) -> np.ndarray:
    w = np.transpose(np.asarray(w_hwio, dtype=np.float32), (3, 2, 0, 1))
    return np.ascontiguousarray(w[:, :, ::-1, ::-1])


def _d1_w_to_jax(w: np.ndarray, spec: TriPlanarSpec) -> np.ndarray:
    """Permute dense rows from (c,h,w) C-order (NCHW flatten) to (h,w,c)."""
    c = spec.conv_filters[4]
    s = int(round((spec.branch_flat / c) ** 0.5))
    w = np.asarray(w, dtype=np.float32).reshape(c, s, s, -1)
    return np.ascontiguousarray(w.transpose(1, 2, 0, 3).reshape(spec.branch_flat, -1))


def _d1_w_from_jax(w: np.ndarray, spec: TriPlanarSpec) -> np.ndarray:
    c = spec.conv_filters[4]
    s = int(round((spec.branch_flat / c) ** 0.5))
    w = np.asarray(w, dtype=np.float32).reshape(s, s, c, -1)
    return np.ascontiguousarray(w.transpose(2, 0, 1, 3).reshape(spec.branch_flat, -1))


def load_theano_checkpoint(path: str, spec: TriPlanarSpec = DEFAULT_SPEC) -> Dict[str, Any]:
    """Read a reference-format pickle into a params pytree (numpy leaves).

    Works on the shipped py2 pickle (``encoding='latin1'``) and on pickles
    written by :func:`save_theano_checkpoint`.
    """
    with open(path, "rb") as fh:
        raw = pickle.load(fh, encoding="latin1")

    def branch(view: str) -> Dict[str, Any]:
        r = _REF_VIEW[view]
        p: Dict[str, Any] = {}
        for i in range(1, 6):
            (w,) = raw[f"{r}_ch_conv{i}"]
            beta, gamma, mean, inv_std = raw[f"{r}_ch_conv{i}_bn"]
            (alpha,) = raw[f"{r}_ch_prelu{i}"]
            p[f"conv{i}"] = {"w": _conv_w_to_jax(w)}
            p[f"bn{i}"] = {
                "beta": np.asarray(beta, np.float32),
                "gamma": np.asarray(gamma, np.float32),
                "mean": np.asarray(mean, np.float32),
                "inv_std": np.asarray(inv_std, np.float32),
            }
            p[f"prelu{i}"] = np.asarray(alpha, np.float32)
        w, b = raw[f"{r}_d1"]
        p["d1"] = {"w": _d1_w_to_jax(w, spec), "b": np.asarray(b, np.float32)}
        (alpha,) = raw[f"{r}_prelu_d1"]
        p["prelu_d1"] = np.asarray(alpha, np.float32)
        return p

    def dense(name: str) -> Dict[str, Any]:
        w, b = raw[name]
        return {"w": np.asarray(w, np.float32), "b": np.asarray(b, np.float32)}

    head = {
        "fc1": dense("FC1"),
        "prelu_f1": np.asarray(raw["prelu_f1"][0], np.float32),
        "fc2": dense("fc_2"),
        "prelu_f2": np.asarray(raw["prelu_f2"][0], np.float32),
        "out": dense("out_layer"),
    }
    return {
        "axial": branch("axial"),
        "coronal": branch("coronal"),
        "sagittal": branch("sagittal"),
        "head": head,
    }


def save_theano_checkpoint(params: Dict[str, Any], path: str,
                           spec: TriPlanarSpec = DEFAULT_SPEC) -> None:
    """Write a params pytree as a reference-format pickle (round-trip of
    :func:`load_theano_checkpoint`), including the parameterless layer keys
    the reference emits, so downstream reference tooling accepts the file."""
    out: "collections.OrderedDict[str, list]" = collections.OrderedDict()

    def np32(x):
        return np.asarray(x, dtype=np.float32)

    for view, inp in (("axial", "in1"), ("coronal", "in2"), ("sagittal", "in3")):
        r = _REF_VIEW[view]
        bp = params[view]
        out[inp] = []
        for i in range(1, 6):
            out[f"{r}_ch_conv{i}"] = [_conv_w_from_jax(bp[f"conv{i}"]["w"])]
            bn = bp[f"bn{i}"]
            out[f"{r}_ch_conv{i}_bn"] = [np32(bn["beta"]), np32(bn["gamma"]),
                                         np32(bn["mean"]), np32(bn["inv_std"])]
            out[f"{r}_ch_conv{i}_bn_nonlin"] = []
            out[f"{r}_ch_prelu{i}"] = [np32(bp[f"prelu{i}"])]
            if i == 2:
                out[f"{r}_max_pool_1"] = []
            if i == 4:
                out[f"{r}_max_pool_2"] = []
        out[f"{r}_l1drop"] = []
        out[f"{r}_d1"] = [_d1_w_from_jax(bp["d1"]["w"], spec), np32(bp["d1"]["b"])]
        out[f"{r}_prelu_d1"] = [np32(bp["prelu_d1"])]

    h = params["head"]
    out["elem_channels"] = []
    out["f1_drop"] = []
    out["FC1"] = [np32(h["fc1"]["w"]), np32(h["fc1"]["b"])]
    out["prelu_f1"] = [np32(h["prelu_f1"])]
    out["f2_drop"] = []
    out["in4"] = []
    out["elem_channels2"] = []
    out["fc_2"] = [np32(h["fc2"]["w"]), np32(h["fc2"]["b"])]
    out["prelu_f2"] = [np32(h["prelu_f2"])]
    out["out_layer"] = [np32(h["out"]["w"]), np32(h["out"]["b"])]

    with open(path, "wb") as fh:
        pickle.dump(out, fh, protocol=2)
