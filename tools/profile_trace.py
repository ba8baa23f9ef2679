#!/usr/bin/env python
"""Capture a jax.profiler trace of the fused production loop on a GPU.

Writes the trace under --out (default ``chiprun_out/trace`` in the
checkout) and lists the ``.xplane.pb`` files; ``tools/xplane_summary.py``
aggregates their device-op durations.

Usage: python tools/profile_trace.py [--out DIR] [--frames K]
                                     [--mode headline|gi_temporal|gi]
                                     [--grid N]
"""

import argparse
import glob
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import jax  # noqa: E402

import cellularautomatons3d_tpu as ca  # noqa: E402
from cellularautomatons3d_tpu.render import renderer_fast as RFW  # noqa: E402
from cellularautomatons3d_tpu.render.renderer import RenderStatic  # noqa: E402
from cellularautomatons3d_tpu.utils import parity  # noqa: E402
from cellularautomatons3d_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

WIDTH, HEIGHT = 1920, 1080


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(_ROOT, "chiprun_out", "trace"))
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--mode", default="headline",
                    choices=("headline", "gi_temporal", "gi"))
    ap.add_argument("--grid", type=int, default=256)
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        sys.exit("profile_trace.py needs a CUDA GPU")
    enable_compile_cache()

    grid = args.grid
    spec = ca.AutomatonSpec.from_config(ca.EngineConfig(grid_size=grid))
    state = parity.grown_scene(grid, 80)
    lighting = {
        "headline": {},
        "gi": dict(indirect_lighting=True, soft_shadow_samples=4),
        "gi_temporal": dict(indirect_lighting=True, soft_shadow_samples=4,
                            gi_temporal=True),
    }[args.mode]
    s = RenderStatic(width=WIDTH, height=HEIGHT, grid_size=grid, **lighting)
    params = parity.frame_params(WIDTH, HEIGHT, light_radius=0.08)
    run = RFW.make_fused_loop(s, spec, args.frames, reset_every=10)
    jax.block_until_ready(
        run(state + 0, params, RFW.init_fast_history(WIDTH, HEIGHT)))

    with jax.profiler.trace(args.out):
        jax.block_until_ready(
            run(state + 0, params, RFW.init_fast_history(WIDTH, HEIGHT)))
    print("trace written to", args.out)
    print("xplane files:",
          glob.glob(args.out + "/**/*.xplane.pb", recursive=True))


if __name__ == "__main__":
    main()
