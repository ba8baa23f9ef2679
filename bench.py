#!/usr/bin/env python
"""Benchmark: ms per iteration of the fused production loop on a CUDA GPU.

One iteration is one 256³ CA generation plus one fully composed 1080p frame
(trace + shade + temporal EMA + light cube + gamma,
``renderer_fast.make_fused_loop``), chained on the device.  K iterations
run in one jitted program and the timing ends in ``jax.block_until_ready``.
The growth rule would densify the scene over K generations, so the pinned
line restores the 80-step scene every 10 frames (``reset_every``): every
iteration still performs a full CA step + composed frame, and the scene
stays in the canonical generation-81-90 band.  The dense line pins the
scene at generations 231-240 the same way.

Fails without a GPU.  Prints progress on stderr and exactly one JSON line
on stdout, with the device and the card's power limit beside the numbers.
"""

import json
import subprocess
import sys
import time

import jax

from cellularautomatons3d_tpu.utils.compile_cache import enable_compile_cache

import cellularautomatons3d_tpu as ca
from cellularautomatons3d_tpu.ops.loop import make_multi_step
from cellularautomatons3d_tpu.render import renderer_fast as RFW
from cellularautomatons3d_tpu.render.renderer import RenderStatic
from cellularautomatons3d_tpu.utils.parity import frame_params

GRID = 256
WIDTH, HEIGHT = 1920, 1080
K = 100
_T0 = time.time()


def _stage(msg: str) -> None:
    print(f"[bench +{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a CUDA GPU; JAX found {dev.platform!r}")
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]

    spec = ca.AutomatonSpec.from_config(ca.EngineConfig(grid_size=GRID))
    seed = jax.numpy.asarray(ca.pack_grid(ca.seed_center(GRID)))
    s = RenderStatic(width=WIDTH, height=HEIGHT, grid_size=GRID)
    params = frame_params(WIDTH, HEIGHT)
    run = RFW.make_fused_loop(s, spec, K, reset_every=10)

    def timed_loop(state):
        for _ in range(2):  # compile, then a warm run
            t0 = time.perf_counter()
            out = run(state + 0, params, RFW.init_fast_history(WIDTH, HEIGHT))
            jax.block_until_ready(out)
        return (time.perf_counter() - t0) * 1000.0 / K

    pinned = make_multi_step(spec, 80)(seed + 0)
    combined_ms = timed_loop(pinned)
    _stage(f"pinned = {combined_ms:.3f} ms/iteration; dense scene...")
    dense_ms = timed_loop(make_multi_step(spec, 230)(seed + 0))
    _stage(f"dense = {dense_ms:.3f} ms/iteration; CA step alone...")

    run_steps = make_multi_step(spec, 1000)
    s2 = jax.block_until_ready(run_steps(pinned + 0))
    t0 = time.perf_counter()
    jax.block_until_ready(run_steps(s2))
    step_ms = (time.perf_counter() - t0) * 1000.0 / 1000

    print(json.dumps({
        "metric": "256^3 CA step + composed 1080p frame",
        "value": round(combined_ms, 4),
        "unit": "ms",
        "vs_baseline": round(16.0 / combined_ms, 3),
        "dense_scene_ms": round(dense_ms, 4),
        "step_ms": round(step_ms, 5),
        "frame_ms": round(combined_ms - step_ms, 4),
        "fps": round(1000.0 / combined_ms, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }))


if __name__ == "__main__":
    main()
