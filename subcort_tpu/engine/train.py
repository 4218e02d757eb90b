"""Training harness (layer L4/L5).

Reference counterpart: nolearn ``NeuralNet.fit`` as configured by
``build_model`` (cnn_cort/nets.py:127-255): categorical cross-entropy,
Adam(lr=1e-3 fixed, Lasagne defaults b1=.9 b2=.999 eps=1e-8), TrainSplit
holdout, per-epoch hooks [SaveWeights(only_best), SaveTrainingHistory,
EarlyStopping(patience)]. Quirks preserved/knobbed:

- the reference never wires ``options['batch_size']`` into NeuralNet, so
  nolearn's default 128 is what actually trains (SURVEY.md §2.3-5); the
  trainer honors ``options['batch_size']`` but ``batch_size=128`` gives the
  reference's effective behavior;
- nolearn's BatchIterator does NOT reshuffle between epochs (data is
  shuffled once up front) — ``shuffle_each_epoch`` defaults False to match;
- the rotation/flip augmentation iterator exists but is never activated in
  the reference (nets.py:41-124 defined, not passed); here it's
  ``augment=True`` — implemented on device, per-view independent choice of
  {rot180, flip, rot180+flip} on a random half of the batch, as the
  reference's transform specifies.

Patches are *gathered on device inside the jitted train step* from the
device-resident volume stack (no host patch tensors), batch sharded
over the ``('data',)`` mesh, BN uses batch stats with Lasagne's EMA
(alpha=1e-2) on (mean, inv_std). History is JSONL with the reference's
history-pickle keys (epoch, train_loss, valid_loss, valid_accuracy,
*_best flags, dur).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import time
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from subcort_tpu.config import Options
from subcort_tpu.engine.data import TrainingIndex
from subcort_tpu.models import apply as model_apply
from subcort_tpu.models import init_params, update_bn_ema
from subcort_tpu.models.importer import save_theano_checkpoint
from subcort_tpu.models.triplanar import DEFAULT_SPEC, TriPlanarSpec
from subcort_tpu.parallel import make_mesh, replicated, shard_batch

PATCH = 32

# conv lowering for training (TriPlanarSpec.conv_impl). Measured on an
# H100 80GB HBM3 at 700 W, batch 256, f32 at HIGHEST: inside the K=32
# multi-step scan that Trainer.fit runs, im2col takes 4.48 ms per step and
# lax (cuDNN) 4.77 ms; device time per step is 4.41 vs 4.45 ms. The lone
# step (the epoch's tail) favours lax, 4.94 vs 8.38 ms, but runs a few
# times per epoch at most.
TRAIN_CONV_IMPL = "im2col"
TRAIN_SPEC = dataclasses.replace(DEFAULT_SPEC, conv_impl=TRAIN_CONV_IMPL)


# ----------------------------------------------------------------- device gather
def gather_triplanar_subjects(volumes: jnp.ndarray, centers: jnp.ndarray,
                              patch: int = PATCH, pad: int = PATCH // 2):
    """Tri-planar gather from a stacked, pre-padded volume array.

    volumes: (S, X+2*pad, Y+2*pad, Z+2*pad); centers: (B, 4)
    [subject, x, y, z] in original coordinates. The window for center ``c``
    spans original ``[c - patch//2, c + patch - patch//2)``; in padded
    coordinates it starts at ``c + (pad - patch//2)``.
    """
    half = patch // 2
    s = centers[:, 0]
    base = pad - half
    cx = centers[:, 1] + base
    cy = centers[:, 2] + base
    cz = centers[:, 3] + base
    offs = jnp.arange(patch, dtype=centers.dtype)
    xs = cx[:, None] + offs
    ys = cy[:, None] + offs
    zs = cz[:, None] + offs
    xc, yc, zc = cx + half, cy + half, cz + half
    sb = s[:, None, None]
    axial = volumes[sb, xs[:, :, None], ys[:, None, :], zc[:, None, None]]
    coronal = volumes[sb, xs[:, :, None], yc[:, None, None], zs[:, None, :]]
    sagittal = volumes[sb, xc[:, None, None], ys[:, :, None], zs[:, None, :]]
    return axial, coronal, sagittal


def _augment_views(rng, ax, co, sa):
    """Reference Rotate_batch_Iterator semantics (nets.py:46-124): on the
    SAME uniformly-random exactly-half subset of the batch
    (np.random.choice(bs, bs/2, replace=False), nets.py:52), each view
    independently draws one of [rot180, flip(w), rot180+flip(w)] — the
    reference's augmented_x stack order with its per-view r_indices
    (nets.py:72-78). rot180+flip(w) composes to flip(h). Differentially
    pinned against a numpy reimplementation of the reference transform in
    tests/test_train.py::test_augmentation_matches_reference_transform."""
    b = ax.shape[0]
    k_sel, *k_views = jax.random.split(rng, 4)
    # exactly floor(b/2) samples, uniformly without replacement — a
    # Bernoulli(0.5) mask (≈half) is NOT the reference's selection law
    selected = jax.random.permutation(k_sel, jnp.arange(b)) < b // 2

    def one(view, key):
        r = jax.random.randint(key, (b,), 0, 3)
        rot180 = view[:, ::-1, ::-1]
        flip = view[:, :, ::-1]
        rot180_flip = rot180[:, :, ::-1]
        stacked = jnp.stack([rot180, flip, rot180_flip], axis=1)
        aug = jnp.take_along_axis(
            stacked, r[:, None, None, None], axis=1)[:, 0]
        return jnp.where(selected[:, None, None], aug, view)

    return (one(ax, k_views[0]), one(co, k_views[1]), one(sa, k_views[2]))


def _augment_intensity(rng, ax, co, sa, strength):
    """Intensity-robustness augmentation ([tpu] ``intensity_augment = S``,
    default 0.0 = off; the reference has no analogue, so the default
    preserves reference-exact training). Models the acquisition shifts the
    robustness gate (bench_robust.py) exercises: a smooth B1 bias field and
    a monotone (gamma) intensity remap act on a 32x32 patch, locally, as an
    affine gain/shift of the normalized intensities, and Rician magnitude
    noise acts as additive per-voxel noise at tissue-level SNR.

    Per sample: gain ~ U(1-S/4, 1+S/4) and shift ~ U(-S/5, S/5) are SHARED
    across the three views (they sample the same volume at the same center),
    while per-voxel Gaussian noise with per-sample sigma ~ U(0, 0.15*S) is
    drawn independently per view. Differentially pinned in
    tests/test_train.py::test_intensity_augmentation_matches_numpy."""
    b = ax.shape[0]
    k_gain, k_shift, k_sigma, k_ax, k_co, k_sa = jax.random.split(rng, 6)
    s = jnp.asarray(strength, ax.dtype)
    gain = 1.0 + jax.random.uniform(
        k_gain, (b, 1, 1), ax.dtype, -0.25, 0.25) * s
    shift = jax.random.uniform(k_shift, (b, 1, 1), ax.dtype, -0.2, 0.2) * s
    sigma = jax.random.uniform(k_sigma, (b, 1, 1), ax.dtype, 0.0, 0.15) * s

    def one(view, key):
        noise = jax.random.normal(key, view.shape, view.dtype)
        return view * gain + shift + noise * sigma

    return one(ax, k_ax), one(co, k_co), one(sa, k_sa)


# ----------------------------------------------------------------- step fns
def _step_impl(optimizer, spec, augment, params, opt_state, volumes,
               centers, labels, atlas, rng, compute_dtype=None,
               intensity_augment=0.0):
    rng_aug, rng_drop = jax.random.split(rng)

    # gather outside the differentiated function: patches are data, not
    # params
    ax, co, sa = gather_triplanar_subjects(volumes, centers,
                                           patch=spec.patch_size)
    if augment:
        ax, co, sa = _augment_views(rng_aug, ax, co, sa)
    if intensity_augment:
        # fold_in keeps rng_drop's stream identical to the knob-off run
        ax, co, sa = _augment_intensity(jax.random.fold_in(rng_aug, 7),
                                        ax, co, sa, intensity_augment)

    # mixed precision ([tpu] train_dtype=bfloat16): master params/optimizer
    # stay f32; the forward/backward runs in bf16 (same exponent range as
    # f32, so no loss scaling needed). Gradient of the cast is a
    # cast back, so value_and_grad returns f32 grads for the f32 master.
    cd = jnp.dtype(compute_dtype) if compute_dtype else None
    if cd is not None:
        ax, co, sa = ax.astype(cd), co.astype(cd), sa.astype(cd)
        atlas = atlas.astype(cd)

    def loss_fn(p):
        if cd is not None:
            p = jax.tree_util.tree_map(lambda x: x.astype(cd), p)
        stats = {}
        logits = model_apply(
            p, {"axial": ax, "coronal": co, "sagittal": sa, "atlas": atlas},
            spec=spec, train=True, rng=rng_drop, return_logits=True,
            batch_stats_out=stats)
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), labels).mean()
        return loss, stats

    (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    updates, opt_state = optimizer.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    params = update_bn_ema(params, stats, spec)
    return params, opt_state, loss


def make_train_step(optimizer, spec: TriPlanarSpec = DEFAULT_SPEC,
                    augment: bool = False, compute_dtype=None,
                    intensity_augment: float = 0.0):
    @jax.jit
    def train_step(params, opt_state, volumes, centers, labels, atlas, rng):
        return _step_impl(optimizer, spec, augment, params, opt_state,
                          volumes, centers, labels, atlas, rng,
                          compute_dtype=compute_dtype,
                          intensity_augment=intensity_augment)

    return train_step


def make_train_multistep(optimizer, spec: TriPlanarSpec = DEFAULT_SPEC,
                         augment: bool = False, compute_dtype=None,
                         intensity_augment: float = 0.0):
    """K optimizer steps per dispatch via lax.scan: one jit call per K
    batches amortizes the per-step host dispatch to ~1/K. Inputs are
    (K, B, ...) stacked batches.
    """
    @jax.jit
    def train_multistep(params, opt_state, volumes, centers_k, labels_k,
                        atlas_k, rng):
        rngs = jax.random.split(rng, centers_k.shape[0])

        def body(carry, inp):
            p, o = carry
            c, l, a, r = inp
            p, o, loss = _step_impl(optimizer, spec, augment, p, o,
                                    volumes, c, l, a, r,
                                    compute_dtype=compute_dtype,
                                    intensity_augment=intensity_augment)
            return (p, o), loss

        (params, opt_state), losses = jax.lax.scan(
            body, (params, opt_state), (centers_k, labels_k, atlas_k, rngs))
        return params, opt_state, losses

    return train_multistep


def make_eval_step(spec: TriPlanarSpec = DEFAULT_SPEC):
    @jax.jit
    def eval_step(params, volumes, centers, labels, atlas):
        ax, co, sa = gather_triplanar_subjects(volumes, centers,
                                               patch=spec.patch_size)
        logits = model_apply(
            params, {"axial": ax, "coronal": co, "sagittal": sa, "atlas": atlas},
            spec=spec, train=False, return_logits=True)
        per = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
        correct = jnp.sum(jnp.argmax(logits, axis=1) == labels)
        return per.sum(), correct

    return eval_step


# ----------------------------------------------------------------- split
def train_split_stratified(labels: np.ndarray, eval_size: float):
    """nolearn TrainSplit semantics (first fold of an unshuffled stratified
    k-fold, k = round(1/eval_size)): per class, the first ~1/k occurrences
    go to validation. Data has already been shuffled once up front
    (base.py:92-103), so this is effectively a random stratified split."""
    if eval_size <= 0:
        return np.arange(len(labels)), np.arange(0)
    k = max(2, int(round(1.0 / eval_size)))
    valid = np.zeros(len(labels), bool)
    for c in np.unique(labels):
        idx = np.flatnonzero(labels == c)
        n_valid = int(np.ceil(idx.size / k))
        valid[idx[:n_valid]] = True
    return np.flatnonzero(~valid), np.flatnonzero(valid)


# ----------------------------------------------------------------- trainer
class Trainer:
    """``NeuralNet.fit`` replacement with the reference's epoch protocol.

    Artifacts per experiment (reference: nets/<name>/, nets.py:140-156):
      <weights_path>/<name>/<name>.pkl           best-only weights
                                                 (Theano-compatible pickle)
      <weights_path>/<name>/<name>_history.jsonl per-epoch history
      <weights_path>/<name>/<name>_state.pkl     full resume state
                                                 (params+opt+epoch+rng)
    """

    def __init__(self, options: Options, spec: TriPlanarSpec = DEFAULT_SPEC,
                 weights_path: str = "nets", params=None,
                 augment: bool = False, shuffle_each_epoch: bool = False,
                 n_devices: Optional[int] = None,
                 lr_schedule: Optional[tuple] = None,
                 steps_per_call: int = 32,
                 intensity_augment: Optional[float] = None):
        self.options = options
        self.spec = dataclasses.replace(spec, conv_impl=TRAIN_CONV_IMPL)
        self.augment = augment
        self.intensity_augment = float(
            options.get("intensity_augment", 0.0)
            if intensity_augment is None else intensity_augment)
        self.shuffle_each_epoch = shuffle_each_epoch
        name = options["experiment"]
        self.exp_dir = os.path.join(weights_path, name)
        os.makedirs(self.exp_dir, exist_ok=True)
        self.weights_file = os.path.join(self.exp_dir, f"{name}.pkl")
        self.history_file = os.path.join(self.exp_dir, f"{name}_history.jsonl")
        self.state_file = os.path.join(self.exp_dir, f"{name}_state.pkl")

        # lr: fixed 1e-3 like the reference (nets.py:237). lr_schedule=(start,
        # stop) enables the linear decay of the reference's *unused*
        # AdjustVariable hook (nets.py:25-39), interpolated over max_epochs.
        if lr_schedule is not None:
            start, stop = lr_schedule
            steps = max(1, options["max_epochs"])
            lr = optax.linear_schedule(start, stop, steps)
            # per-epoch schedule driven by an epoch counter we inc manually
            self._lr_per_epoch = [float(lr(e)) for e in range(steps + 1)]
            self.optimizer = optax.inject_hyperparams(optax.adam)(
                learning_rate=start, b1=0.9, b2=0.999, eps=1e-8)
        else:
            self._lr_per_epoch = None
            self.optimizer = optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-8)
        self.rng_key = jax.random.key(options["seed"])
        if params is None:
            self.rng_key, sub = jax.random.split(self.rng_key)
            params = init_params(sub, spec)
        self.params = params
        self.opt_state = self.optimizer.init(params)
        self.epoch = 0
        self.best_valid_loss = float("inf")
        self.best_epoch = 0
        self.history = []

        ndev = n_devices if n_devices is not None else options["data_parallel"]
        self.mesh = make_mesh(max(1, ndev))
        self.steps_per_call = max(1, steps_per_call)
        td = str(options["train_dtype"]).strip()
        self.train_dtype = ("bfloat16" if td in ("bfloat16", "bf16")
                            else None)
        self._train_step = make_train_step(
            self.optimizer, self.spec, self.augment,
            compute_dtype=self.train_dtype,
            intensity_augment=self.intensity_augment)
        self._train_multi = make_train_multistep(
            self.optimizer, self.spec, self.augment,
            compute_dtype=self.train_dtype,
            intensity_augment=self.intensity_augment)
        self._eval_step = make_eval_step(self.spec)

        if options.bool("load_weights"):
            self._try_resume()

    # -------------------------------------------------------------- persistence
    def _try_resume(self):
        """Warm start (nets.py:248-253 semantics: silent pass on missing)."""
        if os.path.exists(self.state_file):
            with open(self.state_file, "rb") as fh:
                st = pickle.load(fh)
            self.params = jax.tree_util.tree_map(jnp.asarray, st["params"])
            self.opt_state = jax.tree_util.tree_map(
                lambda x: jnp.asarray(x) if isinstance(x, np.ndarray) else x,
                st["opt_state"])
            self.epoch = st["epoch"]
            self.best_valid_loss = st["best_valid_loss"]
            self.best_epoch = st["best_epoch"]
            self.rng_key = jax.random.wrap_key_data(jnp.asarray(st["rng_key"]))
            if os.path.exists(self.history_file):
                with open(self.history_file) as fh:
                    self.history = [json.loads(l) for l in fh if l.strip()]
            if self.options["net_verbose"]:
                print(f"    --> resumed at epoch {self.epoch} from {self.state_file}")
        elif os.path.exists(self.weights_file):
            from subcort_tpu.models.importer import load_theano_checkpoint
            try:
                self.params = jax.tree_util.tree_map(
                    jnp.asarray, load_theano_checkpoint(self.weights_file, self.spec))
                self.opt_state = self.optimizer.init(self.params)
                if self.options["net_verbose"]:
                    print("    --> loading weights from", self.weights_file)
            except Exception:
                pass  # reference behavior: bare try/except around warm start

    def _save_state(self):
        to_np = partial(jax.tree_util.tree_map,
                        lambda x: np.asarray(x) if hasattr(x, "shape") else x)
        st = {
            "params": to_np(self.params),
            "opt_state": to_np(self.opt_state),
            "epoch": self.epoch,
            "best_valid_loss": self.best_valid_loss,
            "best_epoch": self.best_epoch,
            "rng_key": np.asarray(jax.random.key_data(self.rng_key)),
        }
        tmp = self.state_file + ".tmp"
        with open(tmp, "wb") as fh:
            pickle.dump(st, fh)
        os.replace(tmp, self.state_file)

    # -------------------------------------------------------------- epoch loop
    def fit(self, index: TrainingIndex, max_epochs: Optional[int] = None):
        """Train until max_epochs or early stopping; returns history list."""
        opts = self.options
        max_epochs = max_epochs if max_epochs is not None else opts["max_epochs"]
        patience = opts["patience"]
        batch_size = opts["batch_size"]
        verbose = opts["net_verbose"]

        train_idx, valid_idx = train_split_stratified(
            index.labels, opts["train_split"])

        centers = index.centers
        labels = index.labels.astype(np.int32)
        atlas = index.atlas

        volumes = jax.device_put(index.volumes, replicated(self.mesh))

        ndev = self.mesh.devices.size
        # validation is forward-only: batch big to amortize per-dispatch
        # overhead
        eval_bs = max(batch_size, 2048)
        shuffle_rng = np.random.default_rng(opts["seed"] + 1)

        while self.epoch < max_epochs:
            self.epoch += 1
            t0 = time.time()
            if self._lr_per_epoch is not None:
                lr = self._lr_per_epoch[min(self.epoch - 1,
                                            len(self._lr_per_epoch) - 1)]
                self.opt_state.hyperparams["learning_rate"] = jnp.asarray(lr)
            order = train_idx
            if self.shuffle_each_epoch:
                order = shuffle_rng.permutation(train_idx)

            # ---- train epoch: K batches per dispatch, single-step tail
            from jax.sharding import NamedSharding, PartitionSpec as P
            group_sh = NamedSharding(self.mesh, P(None, "data"))
            losses = []
            bs_step = batch_size * ndev
            K = self.steps_per_call
            n_full = (len(order) // bs_step) * bs_step
            n_grouped = (n_full // (bs_step * K)) * bs_step * K
            for i in range(0, n_grouped, bs_step * K):
                sl = order[i:i + bs_step * K]
                ck = jax.device_put(centers[sl].reshape(K, bs_step, -1), group_sh)
                lk = jax.device_put(labels[sl].reshape(K, bs_step), group_sh)
                ak = jax.device_put(atlas[sl].reshape(K, bs_step, -1), group_sh)
                self.rng_key, sub = jax.random.split(self.rng_key)
                self.params, self.opt_state, ls = self._train_multi(
                    self.params, self.opt_state, volumes, ck, lk, ak, sub)
                losses.append(ls)
            for i in range(n_grouped, n_full, bs_step):
                sl = order[i:i + bs_step]
                b = shard_batch(
                    {"centers": centers[sl], "labels": labels[sl],
                     "atlas": atlas[sl]}, self.mesh)
                self.rng_key, sub = jax.random.split(self.rng_key)
                self.params, self.opt_state, loss = self._train_step(
                    self.params, self.opt_state, volumes,
                    b["centers"], b["labels"], b["atlas"], sub)
                losses.append(loss)
            train_loss = (float(np.mean(np.concatenate(
                [np.atleast_1d(np.asarray(l)) for l in losses])))
                if losses else float("nan"))

            # ---- validation
            vloss, vcorrect, vcount = 0.0, 0, 0
            for i in range(0, len(valid_idx), eval_bs):
                sl = valid_idx[i:i + eval_bs]
                m = len(sl)
                ls, cs = self._eval_step(
                    self.params, volumes, jnp.asarray(centers[sl]),
                    jnp.asarray(labels[sl]), jnp.asarray(atlas[sl]))
                vloss += float(ls)
                vcorrect += int(cs)
                vcount += m
            valid_loss = vloss / max(vcount, 1)
            valid_acc = vcorrect / max(vcount, 1)
            dur = time.time() - t0

            improved = valid_loss < self.best_valid_loss
            if improved:
                self.best_valid_loss = valid_loss
                self.best_epoch = self.epoch
                # SaveWeights(only_best=True): reference-format pickle
                save_theano_checkpoint(
                    jax.tree_util.tree_map(np.asarray, self.params),
                    self.weights_file, self.spec)

            rec = {
                "epoch": self.epoch,
                "train_loss": train_loss,
                "valid_loss": valid_loss,
                "valid_accuracy": valid_acc,
                "train_loss_best": bool(train_loss <= min(
                    [h["train_loss"] for h in self.history] + [train_loss])),
                "valid_loss_best": bool(improved),
                "valid_accuracy_best": bool(valid_acc >= max(
                    [h["valid_accuracy"] for h in self.history] + [valid_acc])),
                "dur": dur,
            }
            self.history.append(rec)
            with open(self.history_file, "a") as fh:
                fh.write(json.dumps(rec) + "\n")
            # reference-format mirror: nolearn SaveTrainingHistory wrote a
            # pickle of the per-epoch dict list (nets.py:156) — downstream
            # tooling that reads <name>_history.pkl keeps working.
            with open(self.history_file.replace("_history.jsonl",
                                                "_history.pkl"), "wb") as fh:
                pickle.dump(self.history, fh, protocol=2)
            self._save_state()

            if verbose:
                print(f"  epoch {self.epoch:4d}  train_loss {train_loss:.5f}  "
                      f"valid_loss {valid_loss:.5f}  valid_acc {valid_acc:.5f}  "
                      f"{'*' if improved else ' '}  {dur:.1f}s")

            # EarlyStopping(patience): stop when no improvement for `patience`
            if self.epoch >= self.best_epoch + patience:
                if verbose:
                    print(f"  early stopping: best epoch {self.best_epoch} "
                          f"(valid_loss {self.best_valid_loss:.5f})")
                break

        return self.history
