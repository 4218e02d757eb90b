"""Runtime utilities: compilation cache, timers, profiling hooks."""

from __future__ import annotations

import contextlib
import os
import time


_REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compilation_cache() -> None:
    """Enable JAX's persistent compilation cache.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its cache
    there and nothing else is configured here. Otherwise the cache lives at
    the fixed in-checkout path ``<repo>/.jax_cache`` (git-ignored): the path
    is part of the cache key, so a directory that moves never hits. Safe to
    call multiple times.
    """
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", _REPO_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    # cache everything, including programs the backend marks non-cacheable
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """``jax.profiler.trace`` wrapper (SURVEY.md §5 tracing plan): captures a
    device+host trace viewable in TensorBoard/Perfetto. No-op when
    ``log_dir`` is falsy, so call sites can pass the CLI flag through."""
    if not log_dir:
        yield
        return
    import jax

    os.makedirs(log_dir, exist_ok=True)
    with jax.profiler.trace(log_dir):
        yield
    print(f"[profile] trace written to {log_dir}")


def enable_nan_checks() -> None:
    """Debug-mode NaN detection (SURVEY.md §5 sanitizer plan): every jit
    output is checked and the first NaN raises with the offending
    computation. Costly — a debug flag, not a production default."""
    import jax

    jax.config.update("jax_debug_nans", True)


@contextlib.contextmanager
def timer(label: str, sink=None):
    """Wall-clock timer context; appends (label, seconds) to sink if given."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink.append((label, dt))
    else:
        print(f"[timer] {label}: {dt:.3f}s")
