"""Wall-clock timing of jitted calls on the accelerator.

``jax.block_until_ready`` is a real fence on a GPU: it returns when the
result buffers exist.  So a call is timed as: warm up (compiles, fills
caches), then ``reps`` single calls each fenced with ``block_until_ready``,
and the median is reported with its quartiles.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import jax


def time_call(f: Callable, *args, reps: int = 20, warmup: int = 2) -> dict:
    """Per-call wall time of ``f(*args)`` in seconds:
    ``{"median", "q1", "q3", "n"}`` over ``reps`` fenced calls, and
    ``"first"``, the first warm-up call (compilation included)."""
    start = time.perf_counter()
    jax.block_until_ready(f(*args))
    first = time.perf_counter() - start
    for _ in range(warmup - 1):
        jax.block_until_ready(f(*args))
    ts = []
    for _ in range(reps):
        start = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - start)
    q = statistics.quantiles(ts, n=4) if len(ts) > 1 else ts * 3
    return {"median": statistics.median(ts), "q1": q[0], "q3": q[2],
            "n": len(ts), "first": first}


def median_time(f: Callable, *args, reps: int = 20, warmup: int = 2) -> float:
    """Median per-call wall time of ``f(*args)`` in seconds."""
    return time_call(f, *args, reps=reps, warmup=warmup)["median"]
