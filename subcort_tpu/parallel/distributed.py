"""Multi-host (DCN) support: subject-level data parallelism.

The reference is strictly single-process (SURVEY.md §2.5). For fleet-scale
sweeps over many subjects, the natural decomposition is subject-level: each
host segments its own slice of the subject list on its local chips (ICI),
with no cross-host traffic on the hot path — DCN is touched only by
``jax.distributed`` initialization and any final metric reduction.

Usage (same invocation on every host):

    from subcort_tpu.parallel.distributed import initialize, host_shard
    initialize()                     # env-driven or explicit
    my_scans = host_shard(all_scan_paths)
    for path in my_scans:
        engine.segment_scan(path)
"""

from __future__ import annotations

import os
from typing import Optional, Sequence


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize with env fallbacks; no-op if single-host
    or already initialized."""
    import jax

    if num_processes is None:
        num_processes = int(os.environ.get("SUBCORT_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return
    if jax.distributed.is_initialized():
        return  # idempotent: a second initialize would raise
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def host_shard(items: Sequence, process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> list:
    """The slice of ``items`` this host owns (strided, deterministic)."""
    import jax

    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    return [it for i, it in enumerate(items) if i % pc == pi]


def all_hosts_mean(value: float) -> float:
    """Mean of a host-local scalar across processes (e.g. per-host Dice).

    Uses a tiny jitted sum over a globally sharded array; safe on a single
    host too. The global array is assembled from per-device shards with
    ``make_array_from_single_device_arrays`` — a plain ``device_put`` of the
    full array would assert the same value on every process, which is
    exactly what a host-local scalar is not (caught by the 2-process CI
    smoke test, tests/test_distributed.py).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    import numpy as np

    devs = np.asarray(jax.devices())
    mesh = Mesh(devs, ("all",))
    n = devs.size
    shard = jnp.full((1,), value / n, jnp.float32)
    arr = jax.make_array_from_single_device_arrays(
        (n,), NamedSharding(mesh, P("all")),
        [jax.device_put(shard, d) for d in jax.local_devices()])
    return float(jax.jit(jnp.sum)(arr))
