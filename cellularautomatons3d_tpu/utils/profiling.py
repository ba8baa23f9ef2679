"""Profiling hooks (SURVEY.md §5: the reference has none beyond
performance.now(); here: jax.profiler traces + section timing).

Usage::

    with profile_trace("trace_dir"):       # device trace for XProf/Perfetto
        engine.step(100)

    stats = profile_engine(engine, steps=50, frames=10)
"""

from __future__ import annotations

import contextlib
import time

import jax


__all__ = ["profile_trace", "profile_engine"]


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a jax.profiler device trace (viewable in XProf/TensorBoard)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def profile_engine(engine, steps: int = 50, frames: int = 5) -> dict:
    """Wall-clock engine stats; every timed section ends in
    ``jax.block_until_ready``."""
    engine.step(1)
    jax.block_until_ready(engine.state)
    t0 = time.perf_counter()
    engine.step(steps)
    jax.block_until_ready(engine.state)
    step_s = (time.perf_counter() - t0) / steps

    frame = engine.render()
    jax.block_until_ready(frame)
    t0 = time.perf_counter()
    for _ in range(frames):
        frame = engine.render()
    jax.block_until_ready(frame)
    frame_s = (time.perf_counter() - t0) / frames

    return {
        "steps_per_sec": 1.0 / step_s,
        "step_ms": step_s * 1e3,
        "frame_ms": frame_s * 1e3,
        "fps": 1.0 / frame_s,
        "grid_size": engine.config.grid_size,
        "resolution": (engine.config.width, engine.config.height),
        "pipeline": engine.config.pipeline,
    }
