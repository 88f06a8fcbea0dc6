"""Profiling helpers (SURVEY.md §5 tracing obligation).

The reference's observability is a chrono around each solve published as
`/debug/mpc_time` (``QuatMpc.cpp:257-261``). The equivalents here are:

- `trace(...)`: context manager around `jax.profiler` writing a TensorBoard-
  readable trace directory (kernel timeline, device memory, fusion views);
- `timed(...)`: wall-clock timing of a jitted callable, each call ended by
  `block_until_ready`, with a measured no-op dispatch floor reported beside
  it and subtracted from the p50/p99;
- `annotate(name)`: `jax.profiler.TraceAnnotation` passthrough for marking
  solver phases inside traces.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import jax
import numpy as np


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Capture a jax.profiler device trace around a code block."""
    jax.profiler.start_trace(log_dir, create_perfetto_link=create_perfetto_link)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region that shows up on the trace timeline."""
    return jax.profiler.TraceAnnotation(name)


def measure_dispatch_floor(iters: int = 10) -> float:
    """Median seconds for a no-op jitted call (the per-dispatch round trip)."""
    import jax.numpy as jnp

    x = jnp.zeros((8,))
    f = jax.jit(lambda v: v[0] + 1.0)
    out = f(x)
    jax.block_until_ready(out)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = f(x)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def timed(fn: Callable, *args, iters: int = 10, subtract_floor: bool = True) -> dict:
    """Benchmark a jitted callable: {'p50_s', 'p99_s', 'floor_s', 'raw_p50_s'}.

    The returned p50/p99 subtract the dispatch floor (the honest on-device
    time); raw_p50_s keeps the end-to-end wall clock.
    """
    floor = measure_dispatch_floor() if subtract_floor else 0.0
    out = fn(*args)
    jax.block_until_ready(out)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    raw = np.asarray(ts)
    return {
        "p50_s": float(max(np.percentile(raw, 50) - floor, 0.0)),
        "p99_s": float(max(np.percentile(raw, 99) - floor, 0.0)),
        "floor_s": floor,
        "raw_p50_s": float(np.percentile(raw, 50)),
    }
