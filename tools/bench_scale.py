#!/usr/bin/env python
"""Scale and lighting benchmarks of the fused loop on a CUDA GPU (manual;
bench.py is the one-line headline).

Prints one JSON line per scenario, each ms per (CA step + composed 1080p
frame) in ``make_fused_loop`` with the scene pinned by ``reset_every``:
  512          512³ (BASELINE config 5 scale, one card)
  1024         1024³ (the reference's grid ceiling)
  gi           256³, one-bounce GI + 4 soft-shadow samples every frame
  gi_temporal  256³, one rotating GI slot + shadow sample per frame
Run: ``python tools/bench_scale.py [names...]`` (default: all).
"""

import json
import os
import subprocess
import sys
import time

# Runnable from anywhere: the package lives one level above tools/.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

import cellularautomatons3d_tpu as ca  # noqa: E402
from cellularautomatons3d_tpu.render import renderer_fast as RFW  # noqa: E402
from cellularautomatons3d_tpu.render.renderer import RenderStatic  # noqa: E402
from cellularautomatons3d_tpu.utils import parity  # noqa: E402
from cellularautomatons3d_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

WIDTH, HEIGHT = 1920, 1080
SCENARIOS = {
    "512": (512, 160, {}),
    "1024": (1024, 200, {}),
    "gi": (256, 80, dict(indirect_lighting=True, soft_shadow_samples=4)),
    "gi_temporal": (256, 80, dict(indirect_lighting=True,
                                  soft_shadow_samples=4, gi_temporal=True)),
}


def bench(name, card, k=20):
    grid, steps, lighting = SCENARIOS[name]
    spec = ca.AutomatonSpec.from_config(ca.EngineConfig(grid_size=grid))
    state = parity.grown_scene(grid, steps)
    s = RenderStatic(width=WIDTH, height=HEIGHT, grid_size=grid, **lighting)
    params = parity.frame_params(WIDTH, HEIGHT, light_radius=0.08)
    run = RFW.make_fused_loop(s, spec, k, reset_every=10)
    for _ in range(2):  # compile, then a warm run
        t0 = time.perf_counter()
        jax.block_until_ready(
            run(state + 0, params, RFW.init_fast_history(WIDTH, HEIGHT)))
    ms = (time.perf_counter() - t0) * 1000.0 / k
    dev = jax.devices()[0]
    print(json.dumps({
        "scenario": name, "grid": grid, "lighting": lighting,
        "value": round(ms, 4), "unit": "ms per (step + frame)",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }), flush=True)


if __name__ == "__main__":
    if jax.devices()[0].platform != "gpu":
        sys.exit("bench_scale.py needs a CUDA GPU")
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    for name in sys.argv[1:] or list(SCENARIOS):
        bench(name, card)
