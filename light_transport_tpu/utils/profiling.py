"""Profiling: step timers and throughput counters.

The reference brackets renders with ``time.time()`` prints and per-row
progress prints (SURVEY.md §5); here: a per-step wall timer, ``timed``
(which block-until-ready's its result), steady-state throughput split
from compile time (the reference notebooks do this split by hand —
ray-tracing.ipynb cells 12/14), and an optional ``jax.profiler`` trace hook.
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from typing import Callable, Optional

import jax


class StepTimer:
    """Accumulates per-step wall times; reports steps/sec.

    JAX dispatch is asynchronous: ``step()`` times whatever runs inside
    the with-block, so the caller must block on device work themselves
    (``jax.block_until_ready(out)`` inside the block, or wrap the call in
    :func:`timed`) — otherwise only enqueue latency is recorded and the
    reported throughput is meaninglessly inflated."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    @property
    def total(self) -> float:
        return sum(self.times)

    def steps_per_sec(self, units_per_step: float = 1.0) -> float:
        return len(self.times) * units_per_step / max(self.total, 1e-12)


def timed(fn: Callable, *args, **kwargs):
    """Run fn, block on the result, return (result, seconds)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    out = jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def compile_and_steady(fn: Callable, *args, repeats: int = 3):
    """Measure first-call (compile-inclusive) and best steady-state time —
    the split the reference notebooks annotate by hand."""
    _, t_compile = timed(fn, *args)
    best = float("inf")
    for _ in range(repeats):
        _, t = timed(fn, *args)
        best = min(best, t)
    return t_compile, best


def gpu_name_and_power_limit() -> str:
    """``name, power.limit`` of each visible NVIDIA card, one line per card,
    exactly as ``nvidia-smi`` prints them.  A card set below its maximum
    power runs slower under load, so every recorded time carries this
    line.  Raises when ``nvidia-smi`` is missing or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """jax.profiler trace scope (no-op when logdir is None)."""
    if logdir is None:
        yield
        return
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
