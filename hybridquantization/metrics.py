"""Observability: stage timers, throughput counters, profiler hooks.

The reference's entire observability surface was stdout wall-clock labels
(HybridQuantization.addPerfLabel, HybridQuantization.java:259-263) and an
every-10-iterations ETA (ImageManipulation.java:546-551). This module keeps
that parity (StageTimer prints the same style of labels) and adds
accelerator tooling: Mpix/s / iters/s counters and `jax.profiler` trace capture.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import jax


@dataclass
class StageTimer:
    """Named stage wall-clock labels (addPerfLabel parity)."""

    verbose: bool = True
    stages: dict = field(default_factory=dict)
    _t0: float = field(default_factory=time.time)

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.time()
        try:
            yield
        finally:
            elapsed = time.time() - start
            self.stages[name] = self.stages.get(name, 0.0) + elapsed
            if self.verbose:
                print(f"{name} : {elapsed * 1000:.0f}ms")

    def total(self) -> float:
        return time.time() - self._t0


@dataclass
class Throughput:
    """Megapixels/s and iterations/s counters (the BASELINE metrics)."""

    pixels: int = 0
    iterations: int = 0
    seconds: float = 0.0

    def add(self, pixels: int, iterations: int, seconds: float) -> None:
        self.pixels += pixels
        self.iterations += iterations
        self.seconds += seconds

    @property
    def mpix_per_s(self) -> float:
        return self.pixels / self.seconds / 1e6 if self.seconds else 0.0

    @property
    def iters_per_s(self) -> float:
        return self.iterations / self.seconds if self.seconds else 0.0


@contextlib.contextmanager
def profiler_trace(logdir: str | None):
    """Capture a jax.profiler trace around a region (no-op when logdir None)."""
    if not logdir:
        yield
        return
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def block_until_ready(tree):
    """Convenience for timing: wait for all arrays in a pytree."""
    return jax.block_until_ready(tree)


def timeit(fn, *args, warmup: int = 1, iters: int = 5) -> float:
    """Median wall-clock seconds of fn(*args) with device sync."""
    for _ in range(warmup):
        block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
