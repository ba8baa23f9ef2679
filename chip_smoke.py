#!/usr/bin/env python
"""Smoke run of the CA step + render loop on a CUDA GPU.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --cards 4   # four cards: the sharded 512^3 path only

Phases (one card): 1 device, 2 traversal kernel vs its jnp reference at
real widths, 3 the main path through ``Engine``, 4 the viewer's /frame
endpoint, 5 the fused loop timed with the kernel and with the plain XLA
traversal, 6 the GPU-marked tests.  Any failure exits non-zero; on success
the last line of stdout is one JSON object naming the device.  Without a
GPU it fails at phase 1 and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import traceback
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
W, H = 1920, 1080
_failures: list[str] = []


def _phase(name):
    def wrap(fn):
        def run(*a, **kw):
            print(f"== {name}", flush=True)
            t0 = time.perf_counter()
            try:
                fn(*a, **kw)
            except Exception:
                traceback.print_exc()
                _failures.append(name)
                print(f"FAIL {name}", flush=True)
            print(f"   ({time.perf_counter() - t0:.1f} s)", flush=True)
        return run
    return wrap


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def _require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _check_frame(frame, what):
    f = np.asarray(frame)
    _require(np.isfinite(f).all(), f"{what}: non-finite pixels")
    _require(f.max() > 0, f"{what}: all black")


# ------------------------------------------------------------------ phases


@_phase("2 kernels at real widths")
def phase_kernels(jax, ca):
    from cellularautomatons3d_tpu.render.renderer import RenderStatic
    from cellularautomatons3d_tpu.render.renderer_fast import (
        init_fast_history, make_fused_loop)
    from cellularautomatons3d_tpu.utils import parity

    cases = [
        ("256^3 pinned gen 85", RenderStatic(width=W, height=H, grid_size=256),
         lambda: (parity.grown_scene(256, 85), None, 2), {}),
        ("256^3 dense gen 230", RenderStatic(width=W, height=H, grid_size=256),
         lambda: (parity.grown_scene(256, 230), None, 2), {}),
        ("256^3 soft x4 + GI", RenderStatic(
            width=W, height=H, grid_size=256, soft_shadow_samples=4,
            indirect_lighting=True),
         lambda: (parity.grown_scene(256, 85), None, 2),
         dict(light_radius=0.08, elapsed_time=0.37)),
        ("1024^3 gen 80 + noise", RenderStatic(width=W, height=H,
                                               grid_size=1024),
         lambda: (parity.grown_scene(1024, 80)
                  | parity.sparse_noise(1024, 11), None, 2), {}),
        ("128^3 ages, 8 states", RenderStatic(width=W, height=H,
                                              grid_size=128),
         lambda: _aged(parity), {}),
    ]
    for name, s, make, extra in cases:
        vol, ages, states = make()
        m = parity.compare_traversals(s, vol, parity.frame_params(W, H, **extra),
                                      ages, states)
        ok = parity.within_tolerance(m)
        print(f"   {name}: {'ok' if ok else 'OUT OF TOLERANCE'} "
              f"hits={m['hits']} pixel_match={m['match']:.6f} "
              f"idx_match={m['idx_match']:.6f} "
              f"depth_max_err={m['depth_max_err']:.3e} "
              f"rgb_max_err={m['rgb_max_err']:.3e}", flush=True)
        _require(ok and m["hits"] > 0, f"{name} parity {m}")

    spec = ca.AutomatonSpec.from_config(ca.EngineConfig(grid_size=256))
    run = make_fused_loop(RenderStatic(width=W, height=H, grid_size=256),
                          spec, 30, reset_every=10)
    compiled = jax.jit(lambda st, p, h: run(st, p, h)).lower(
        parity.grown_scene(256, 80), parity.frame_params(W, H),
        init_fast_history(W, H)).compile()
    print(f"   fused loop 256^3/1080p memory_analysis: "
          f"{compiled.memory_analysis()}", flush=True)


def _aged(parity):
    ages = parity.grown_scene(128, 40, total_states=8)
    return ages[0] | ages[1] | ages[2], ages, 8


@_phase("3 main path (Engine)")
def phase_engine(jax, ca):
    eng = ca.Engine(grid_size=256, width=W, height=H)
    eng.step(80)
    jax.block_until_ready(eng.state)
    f0 = eng.render()
    eng.camera.rotate((0.0, 1.0, 0.0), 0.05)   # reprojection path
    f1 = eng.render()
    f2 = eng.render()
    for i, f in enumerate((f0, f1, f2)):
        _require(np.asarray(f).shape == (H, W, 3), f"render {i} shape")
        _check_frame(f, f"render {i}")
    t0 = time.perf_counter()
    f3 = eng.run_fused(30)
    jax.block_until_ready(f3)
    _check_frame(f3, "run_fused(30)")
    print(f"   step(80) + 3 render() + run_fused(30) ok; run_fused incl. "
          f"compile {time.perf_counter() - t0:.1f} s; "
          f"simulation_step={eng.simulation_step}", flush=True)
    ref = ca.Engine(grid_size=64, width=640, height=480, pipeline="reference")
    ref.step(20)
    _check_frame(ref.render(), "reference pipeline 64^3/640x480")
    print("   reference pipeline 64^3/640x480 ok", flush=True)


@_phase("4 served path (viewer /frame)")
def phase_served(jax, ca):
    from cellularautomatons3d_tpu.viewer.server import ViewerServer

    viewer = ViewerServer()
    httpd = viewer.make_server(port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/frame"
        for i in range(3):
            t0 = time.perf_counter()
            with urllib.request.urlopen(url, timeout=600) as r:
                body = r.read()
                ctype = r.headers.get("Content-Type")
            _require(ctype == "image/png" and body[:8] == b"\x89PNG\r\n\x1a\n",
                     f"/frame {i} is not a PNG")
            print(f"   /frame {i}: {len(body)} bytes PNG in "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join()


@_phase("5 kernel vs plain XLA traversal (fused loop)")
def phase_timing(jax, ca, card):
    from cellularautomatons3d_tpu.render.renderer import RenderStatic
    from cellularautomatons3d_tpu.render.renderer_fast import (
        init_fast_history, make_fused_loop)
    from cellularautomatons3d_tpu.utils import parity

    k = 10
    cells = [("256^3 pinned (gen 81-90)", 256, 80),
             ("256^3 dense (gen 231-240)", 256, 230),
             ("1024^3 (gen 81-90)", 1024, 80)]
    params = parity.frame_params(W, H)
    for name, n, steps in cells:
        spec = ca.AutomatonSpec.from_config(ca.EngineConfig(grid_size=n))
        state = parity.grown_scene(n, steps)
        s = RenderStatic(width=W, height=H, grid_size=n)
        runs = {t: make_fused_loop(dataclasses.replace(s, traversal=t), spec,
                                   k, reset_every=10)
                for t in ("kernel", "reference")}

        def once(t):
            out = runs[t](state + 0, params, init_fast_history(W, H))
            jax.block_until_ready(out)

        times = {"kernel": [], "reference": []}
        for t in runs:
            once(t)  # compile + warm
        for t in ("kernel", "reference", "reference", "kernel"):
            t0 = time.perf_counter()
            once(t)
            times[t].append((time.perf_counter() - t0) * 1e3 / k)
        kt, rt = np.mean(times["kernel"]), np.mean(times["reference"])
        print(f"   {name} @{W}x{H}, ms per (step + frame), K={k}: "
              f"kernel {kt:.3f} {times['kernel']}  "
              f"plain XLA {rt:.3f} {times['reference']}  "
              f"[{card}]", flush=True)


@_phase("6 GPU-marked tests")
def phase_tests(jax, ca):
    import pytest

    os.environ["JAX_PLATFORMS"] = "cuda"  # conftest keeps a non-CPU platform
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_gpu_kernel.py")])
    _require(rc == 0, f"pytest exit code {rc}")


@_phase("sharded 512^3 over 4 cards vs 1 card")
def phase_cards(jax, ca, cards):
    from cellularautomatons3d_tpu.utils import parity

    devs = jax.devices()
    _require(len(devs) >= cards, f"need {cards} devices, have {len(devs)}")
    common = dict(grid_size=512, width=W, height=H)
    em = ca.Engine(mesh_devices=cards, **common)
    e1 = ca.Engine(**common)
    print(f"   mesh {em.mesh.shape} over {[str(d) for d in em.mesh.devices]}")
    em.step(20)
    e1.step(20)
    for sh in em.state.addressable_shards:
        print(f"   state shard {sh.index} on {sh.device}", flush=True)
    _require(np.array_equal(np.asarray(em.state), np.asarray(e1.state)),
             "state after 20 steps differs")
    print("   20 steps: state bit-exact", flush=True)

    def compare(what, fm, f1):
        m = parity.frame_agreement(np.asarray(fm), np.asarray(f1),
                                   np.asarray(em.history.hit_idx),
                                   np.asarray(e1.history.hit_idx))
        print(f"   {what}: pixel_match={m['match']:.6f} "
              f"idx_match={m['idx_match']:.6f} "
              f"max_err={m['rgb_max_err']:.3e}", flush=True)
        _check_frame(fm, what)
        _require(m["match"] >= parity.MATCH_MIN, f"{what} frames differ")

    compare("render()", em.render(), e1.render())
    times, frames = [], []
    for eng in (em, e1):
        jax.block_until_ready(eng.run_fused(10))  # compile + warm
        t0 = time.perf_counter()
        frames.append(eng.run_fused(10))
        jax.block_until_ready(frames[-1])
        times.append((time.perf_counter() - t0) * 1e3 / 10)
    print(f"   run_fused(10) ms per (step + frame): {cards} cards "
          f"{times[0]:.3f}, 1 card {times[1]:.3f}", flush=True)
    _require(np.array_equal(np.asarray(em.state), np.asarray(e1.state)),
             "state after run_fused differs")
    print("   run_fused: state bit-exact", flush=True)
    compare("run_fused(10) last frame", *frames)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4 runs only the sharded 512^3 path on four cards")
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    try:
        import cellularautomatons3d_tpu as ca
        from cellularautomatons3d_tpu.utils.compile_cache import (
            enable_compile_cache)
    except ImportError as e:
        print(f"chip_smoke: the package is not importable here: {e}",
              file=sys.stderr)
        return 1

    print("== 1 device", flush=True)
    cache = enable_compile_cache()
    card = card_line()
    print(f"   platform={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())} jax={jax.__version__} "
          f"compile_cache={cache}", flush=True)
    print(f"   card: {card}", flush=True)

    if args.cards > 1:
        phase_cards(jax, ca, args.cards)
    else:
        phase_kernels(jax, ca)
        phase_engine(jax, ca)
        phase_served(jax, ca)
        phase_timing(jax, ca, card)
        phase_tests(jax, ca)
    if _failures:
        print(f"chip_smoke FAILED: {_failures}", file=sys.stderr)
        return 1
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
