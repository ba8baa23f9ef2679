"""Timing/metrics helpers (SURVEY.md §5: the steps/sec + frame-ms counters
the reference lacks)."""

from __future__ import annotations

import time

import jax

__all__ = ["time_fn", "Timer"]


def time_fn(fn, *args, reps: int = 5, warmup: int = 1, **kwargs) -> float:
    """Median wall-clock seconds per call, each ending when the device has
    finished (``jax.block_until_ready``)."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    jax.block_until_ready(out)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


class Timer:
    """Accumulating section timer."""

    def __init__(self):
        self.sections: dict[str, float] = {}

    def section(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                timer.sections[name] = timer.sections.get(name, 0.0) + (
                    time.perf_counter() - self.t0
                )

        return _Ctx()
