"""Config system (layer L1).

Preserves the reference's ``configuration.cfg`` contract bit-for-bit
(reference: cnn_cort/load_options.py:11-59, configuration.cfg:1-23):

- INI file with ``[database]`` and ``[model]`` sections, same key names.
- Booleans arrive as the *strings* ``'True'``/``'False'`` and the reference
  compares them as strings (e.g. base.py:374 ``options['debug'] == 'True'``).
  We accept both spellings and real booleans, and expose typed accessors.
- ``mode = cpu | cudaN`` selected the Theano device in the reference
  (load_options.py:54-57). Here it maps onto the JAX platform; see
  :func:`select_platform`.

Internally everything is a typed :class:`Options` dataclass; a dict-style
``options['patch_size']`` view is kept so workload code reads like the
reference API without string-typed fragility.
"""

from __future__ import annotations

import configparser
import dataclasses
import os
import re
from typing import Any, Iterator, Mapping


def _as_bool(v: Any) -> bool:
    """String-boolean tolerance: the reference keeps booleans as 'True'/'False'."""
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        return v.strip().lower() in ("true", "1", "yes", "on")
    return bool(v)


@dataclasses.dataclass
class Options(Mapping[str, Any]):
    """Typed options with the reference's flat-dict key contract.

    Key names follow cnn_cort/load_options.py:24-51 exactly so that code
    written against the reference's ``options`` dict ports over unchanged.
    """

    # [database]
    experiment: str = "experiment"
    train_folder: str = ""
    test_folder: str = ""           # reference key: inference_folder in the cfg
    output_folder: str = ""
    current_scan: str = ""
    t1_name: str = "T1.nii.gz"
    roi_name: str = "gt_15_classes.nii.gz"
    out_name: str = "out_seg.nii.gz"
    save_tmp: bool = True

    # [model]
    mode: str = "cuda"              # cuda | cudaN | gpu | cpu
    patch_size: tuple = (32, 32)
    weight_paths: str | None = None
    train_split: float = 0.25
    max_epochs: int = 100
    patience: int = 20
    batch_size: int = 256
    test_batch_size: int = 100000
    net_verbose: int = 1
    load_weights: bool = True
    randomize_train: bool = True
    debug: bool = True
    out_probabilities: bool = False
    post_process: bool = True
    crop: bool = True               # reference cfg key: speedup_segmentation

    # --- framework extensions, the cfg's [tpu] section (no reference
    #     analogue; defaults preserve reference behavior) ---------------------
    seed: int = 42                  # replaces the reference's unseeded RNG (base.py:322-328)
    compute_dtype: str = "float32"  # float32 | bfloat16 for the forward pass
    data_parallel: int = 1          # number of mesh devices for DP
    use_fcn: bool = True            # à-trous fully-convolutional fast path
    bugcompat_postprocess_argmax: bool = False  # reproduce base.py:474 quirk (§2.3-7)
    dilate_crop_iters: int = 10     # base.py:369 binary_dilation(iterations=10)
    prior_dtype: str = "uint16"     # host->device prior wire: uint16 (fixed-point, most accurate) | float16 | uint8 | float32
    probs_dtype: str = "uint8"      # device->host probability readback wire: uint8 (1/255-step fixed-point, half the bytes — labels are computed on device and unaffected) | float16 | float32 for full-precision prob maps
    cc_backend: str = "scipy"       # post-process connected components: scipy | device
    folder_pipeline: bool = False   # pipelined folder sweep: prefetch the next scan's host prep + async writeback (bit-identical results; pays only with spare host cores)
    fcn_max_bbox_voxels: int = 6_000_000  # dense-evaluator sub-slab budget
    fcn_spmd: bool = True           # multi-device FCN: one sharded SPMD program over the ('data',) mesh (False: host sub-bbox fan-out — pipelines per-slab uploads)
    debug_nans: bool = False        # jax_debug_nans: raise on first NaN (debug only)
    reg_backend: str = "native"     # deformable registration: native (C++) | jax (on-device)
    reg_similarity: str = "nmi"     # deformable-stage cost: nmi (default — the reference's reg_f3d is NiftyReg's NMI-driven FFD, base.py:516-521) | ssd (opt-in; wins on same-protocol pairs)
    train_dtype: str = "float32"    # training forward/backward: float32 | bfloat16 (f32 master)
    intensity_augment: float = 0.0  # train-time intensity-robustness augmentation strength S (0 = off = reference-exact; 2.0 = the strength bench_robust.py validated); per-sample gain/shift shared across views + per-voxel noise — hardens the CNN against bias-field/remap/Rician covariate shift (see engine/train.py::_augment_intensity)

    # ------------------------------------------------------------------ dict view
    def __getitem__(self, key: str) -> Any:
        if not hasattr(self, key):
            raise KeyError(key)
        return getattr(self, key)

    def __setitem__(self, key: str, value: Any) -> None:
        if not hasattr(self, key):
            raise KeyError(key)
        setattr(self, key, value)

    def __iter__(self) -> Iterator[str]:
        return iter(f.name for f in dataclasses.fields(self))

    def __len__(self) -> int:
        return len(dataclasses.fields(self))

    # ------------------------------------------------------------- typed helpers
    def bool(self, key: str) -> bool:
        return _as_bool(self[key])

    def asdict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


def load_options(user_config: configparser.RawConfigParser | str | os.PathLike) -> Options:
    """Map a ``configuration.cfg`` into :class:`Options`.

    Mirrors cnn_cort/load_options.py:11-59 (same keys, same sections, same
    defaults), minus its side effect of mutating ``THEANO_FLAGS`` — platform
    selection is explicit here via :func:`select_platform`.

    Deliberate deviation (pinned in tests/test_config.py): the reference
    raises ``NoOptionError`` on any missing cfg key (bare ``get``,
    load_options.py:24-51); here missing keys fall back to the documented
    defaults so partial configs work. Present keys are read with identical
    semantics.

    Accepts either an already-read RawConfigParser (reference calling
    convention, train_model.py:23-26) or a path to the cfg file.
    """
    if not isinstance(user_config, configparser.RawConfigParser):
        path = os.fspath(user_config)
        cfg = configparser.RawConfigParser()
        with open(path) as fh:
            cfg.read_file(fh)
        user_config = cfg

    g = user_config.get
    gi = user_config.getint
    gf = user_config.getfloat

    def opt(section: str, key: str, default: Any, conv=None) -> Any:
        if user_config.has_option(section, key):
            raw = g(section, key)
            return conv(raw) if conv else raw
        return default

    ps = int(opt("model", "patch_size", 32, int))
    o = Options(
        experiment=opt("model", "name", "experiment").strip(),
        train_folder=opt("database", "train_folder", ""),
        test_folder=opt("database", "inference_folder", ""),
        t1_name=opt("database", "t1_name", "T1.nii.gz"),
        roi_name=opt("database", "roi_name", "gt_15_classes.nii.gz"),
        save_tmp=_as_bool(opt("database", "save_tmp", True)),
        mode=opt("model", "mode", "cuda").strip(),
        patch_size=(ps, ps),
        train_split=float(opt("model", "train_split", 0.25, float)),
        max_epochs=int(opt("model", "max_epochs", 100, int)),
        patience=int(opt("model", "patience", 20, int)),
        batch_size=int(opt("model", "batch_size", 256, int)),
        test_batch_size=int(opt("model", "test_batch_size", 100000, int)),
        net_verbose=int(opt("model", "net_verbose", 1, int)),
        load_weights=_as_bool(opt("model", "load_weights", True)),
        debug=_as_bool(opt("model", "debug", True)),
        out_probabilities=_as_bool(opt("model", "out_probabilities", False)),
        post_process=_as_bool(opt("model", "post_process", True)),
        crop=_as_bool(opt("model", "speedup_segmentation", True)),
        # framework extensions (optional keys in a [tpu] section)
        seed=int(opt("tpu", "seed", 42, int)),
        compute_dtype=opt("tpu", "compute_dtype", "float32").strip(),
        data_parallel=int(opt("tpu", "data_parallel", 1, int)),
        use_fcn=_as_bool(opt("tpu", "use_fcn", True)),
        bugcompat_postprocess_argmax=_as_bool(
            opt("tpu", "bugcompat_postprocess_argmax", False)),
        dilate_crop_iters=int(opt("tpu", "dilate_crop_iters", 10, int)),
        prior_dtype=opt("tpu", "prior_dtype", "uint16").strip(),
        probs_dtype=opt("tpu", "probs_dtype", "uint8").strip(),
        cc_backend=opt("tpu", "cc_backend", "scipy").strip(),
        folder_pipeline=_as_bool(opt("tpu", "folder_pipeline", False)),
        fcn_max_bbox_voxels=int(opt("tpu", "fcn_max_bbox_voxels",
                                    6_000_000, int)),
        fcn_spmd=_as_bool(opt("tpu", "fcn_spmd", True)),
        debug_nans=_as_bool(opt("tpu", "debug_nans", False)),
        reg_backend=opt("tpu", "reg_backend", "native").strip(),
        reg_similarity=opt("tpu", "reg_similarity", "nmi").strip(),
        train_dtype=opt("tpu", "train_dtype", "float32").strip(),
        intensity_augment=float(opt("tpu", "intensity_augment", 0.0, float)),
    )
    return o


def select_platform(options: Options) -> None:
    """Map the reference's ``mode`` to the JAX platform.

    The reference selected its backend by exporting ``THEANO_FLAGS``
    (load_options.py:54-57). The JAX analogue is ``JAX_PLATFORMS``; it only
    takes effect if set before the first backend initialization, so call
    this at process start (the CLI does). An already-set ``JAX_PLATFORMS``
    wins. ``cuda``/``cudaN``/``gpu`` select the GPU with no CPU fallback:
    a run that asked for the GPU fails at start-up when it has none.
    """
    mode = options.mode.strip().lower()
    if mode == "cpu":
        platform = "cpu"
    elif mode == "gpu" or re.fullmatch(r"cuda\d*", mode):
        platform = "cuda"
    else:
        raise ValueError(f"mode = {options.mode!r} is not supported; use "
                         "cuda, cudaN, gpu or cpu")
    os.environ.setdefault("JAX_PLATFORMS", platform)


def print_options(options: Options) -> None:
    """Reference-compatible options dump (load_options.py:62-72)."""
    print("-" * 50)
    print(" ")
    for k in options:
        print(k, ":", options[k])
    print("-" * 50)
