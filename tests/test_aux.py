"""Auxiliary subsystems: LR schedule hook parity, multi-host helpers,
compilation cache, device connected components already in test_parallel."""

import os

import numpy as np
import pytest

import jax

from subcort_tpu.config import Options
from subcort_tpu.engine import Trainer
from subcort_tpu.models.triplanar import TriPlanarSpec
from subcort_tpu.parallel.distributed import all_hosts_mean, host_shard
from subcort_tpu.utils import enable_compilation_cache

TINY = TriPlanarSpec(patch_size=24)
_REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def _tiny_index(rng, n=64, s=2, extent=16):
    from subcort_tpu.engine import TrainingIndex
    half = TINY.patch_size // 2
    vols = rng.standard_normal((s,) + (extent + 2 * half,) * 3).astype(np.float32)
    centers = np.stack([rng.integers(0, s, n)] +
                       [rng.integers(0, extent, n) for _ in range(3)], 1).astype(np.int32)
    return TrainingIndex(vols, centers, rng.integers(0, 15, n).astype(np.int32),
                         rng.random((n, 15)).astype(np.float32),
                         [f"s{i}" for i in range(s)])


def test_lr_schedule_adjustvariable_parity(tmp_path, rng):
    """The reference defines (but never wires) AdjustVariable(start, stop)
    linear decay (nets.py:25-39); here it's an opt-in that must actually
    change the learning rate across epochs."""
    opts = Options(experiment="lr1", batch_size=16, max_epochs=3, patience=10,
                   train_split=0.25, net_verbose=0, load_weights=False, seed=2)
    tr = Trainer(opts, spec=TINY, weights_path=str(tmp_path / "nets"),
                 lr_schedule=(0.03, 0.001))
    hist = tr.fit(_tiny_index(rng))
    assert len(hist) == 3
    assert np.isfinite(hist[-1]["train_loss"])
    lr_now = float(tr.opt_state.hyperparams["learning_rate"])
    assert lr_now < 0.03  # decayed from start


def test_host_shard_partition():
    items = list(range(10))
    shards = [host_shard(items, process_index=i, process_count=3)
              for i in range(3)]
    assert sorted(sum(shards, [])) == items
    assert all(len(s) in (3, 4) for s in shards)


def test_all_hosts_mean_single_host():
    assert abs(all_hosts_mean(0.84) - 0.84) < 1e-6


_CACHE_OPTIONS = ("jax_compilation_cache_dir",
                  "jax_persistent_cache_min_compile_time_secs",
                  "jax_persistent_cache_min_entry_size_bytes")


@pytest.fixture()
def restore_cache_config():
    """enable_compilation_cache sets process-global jax options; put them
    back so the rest of this worker's tests compile as before."""
    saved = {k: getattr(jax.config, k) for k in _CACHE_OPTIONS}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_enable_compilation_cache_idempotent(restore_cache_config,
                                              monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    enable_compilation_cache()
    enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == _REPO_CACHE
    x = jax.numpy.ones((8, 8))
    assert float((x @ x).sum()) == 512.0


@pytest.mark.parametrize("env_dir", [False, True],
                         ids=["repo_default", "env_dir"])
def test_enable_compilation_cache_directory(env_dir, tmp_path,
                                            restore_cache_config,
                                            monkeypatch):
    """JAX_COMPILATION_CACHE_DIR, where set, is JAX's own: the code sets no
    directory of its own. Otherwise the cache is <repo>/.jax_cache."""
    before = str(tmp_path / "preset")
    jax.config.update("jax_compilation_cache_dir", before)
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == (
        before if env_dir else _REPO_CACHE)
    assert jax.config.jax_persistent_cache_min_entry_size_bytes == 0


def test_profile_trace_writes_trace(tmp_path):
    from subcort_tpu.utils import profile_trace

    with profile_trace(str(tmp_path / "trace")):
        x = jax.numpy.ones((16, 16))
        (x @ x).block_until_ready()
    files = [os.path.join(r, f) for r, _, fs in os.walk(tmp_path / "trace")
             for f in fs]
    assert files, "no trace artifacts written"
    # no-op mode must not create anything
    with profile_trace(None):
        pass


def test_bench_train_smoke(capsys):
    """bench_train.py at toy scale: one JSON line with the contract keys."""
    import json
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench_train

    bench_train.main(["--samples", "512", "--epochs", "2", "--batch", "64"])
    line = [l for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")][-1]
    rec = json.loads(line)
    assert rec["metric"] == "train_epoch_wallclock"
    assert rec["value"] > 0 and rec["vs_baseline"] > 0
    assert rec["samples_per_sec_per_chip"] > 0
