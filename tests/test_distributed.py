"""Two-process jax.distributed smoke test (SURVEY.md §2.5 DCN plan).

The reference is strictly single-process; multi-host subject-parallel
sweeps are an addition of this framework (parallel/distributed.py). This test runs
the real thing in CI: two OS processes, a local coordinator, gloo CPU
collectives — initialize() / host_shard() / all_hosts_mean() end to end.
It caught a real bug: all_hosts_mean's original device_put of the full
global array asserts value equality across processes, which a host-local
scalar violates by construction.
"""

import os
import socket
import subprocess
import sys
import textwrap

_WORKER = textwrap.dedent("""
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    pid = int(sys.argv[1])
    coord = sys.argv[2]
    os.environ["SUBCORT_NUM_PROCESSES"] = "2"  # exercise the env fallback

    from subcort_tpu.parallel.distributed import (all_hosts_mean, host_shard,
                                                  initialize)
    initialize(coordinator_address=coord, process_id=pid)
    assert jax.process_count() == 2, jax.process_count()
    assert jax.process_index() == pid, jax.process_index()
    assert len(jax.devices()) == 4, jax.devices()      # 2 hosts x 2 devices
    assert len(jax.local_devices()) == 2

    # deterministic strided subject sharding, no overlap across hosts
    items = [f"scan{i}" for i in range(10)]
    mine = host_shard(items)
    assert mine == items[pid::2], mine

    # cross-host scalar reduction: hosts hold 10.0 and 11.0 -> mean 10.5
    m = all_hosts_mean(float(10 + pid))
    assert abs(m - 10.5) < 1e-6, m

    # initialize() is idempotent (no-op on the already-initialized runtime)
    initialize(coordinator_address=coord, process_id=pid)
    print("DISTRIBUTED_OK", pid, flush=True)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_initialize_shard_and_reduce():
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + env.get("PYTHONPATH", "").split(os.pathsep))
    # the subprocess must pick its own platform before any jax import
    env.pop("JAX_PLATFORMS", None)

    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(i), coord],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-2000:]}"
        assert f"DISTRIBUTED_OK {i}" in out


def test_initialize_single_process_is_noop():
    # num_processes <= 1 (default env) must not touch jax.distributed
    from subcort_tpu.parallel.distributed import initialize
    initialize()  # would raise on a second real initialize in-process


def test_segment_folder_shards_subjects_per_host(tmp_path, monkeypatch):
    """Under a multi-process launch, each host segments its strided slice of
    the subject list (subject-level DCN parallelism, SURVEY §2.5)."""
    import jax
    import numpy as np

    from subcort_tpu.config import Options
    from subcort_tpu.engine.infer import SegmentationEngine
    from subcort_tpu.io import NiftiImage, save_nii

    for i in range(5):
        d = tmp_path / f"s{i:02d}"
        d.mkdir()
        save_nii(NiftiImage(np.ones((4, 4, 4), np.float32)),
                 str(d / "T1.nii.gz"))

    opts = Options()
    opts["test_folder"] = str(tmp_path)
    opts["debug"] = False
    eng = SegmentationEngine(params={}, options=opts)

    seen = []
    monkeypatch.setattr(eng, "segment_scan", lambda p: seen.append(p) or 0.0)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    times = eng.segment_folder()
    # host 1 of 2 gets the odd-index subjects (strided, deterministic)
    assert sorted(times) == ["s01", "s03"]
    assert all("T1.nii.gz" in p for p in seen) and len(seen) == 2

    # single-process launches are unchanged
    seen.clear()
    monkeypatch.setattr(jax, "process_count", lambda: 1)
    times = eng.segment_folder()
    assert sorted(times) == [f"s{i:02d}" for i in range(5)]
