"""Compiled traversal kernel vs the plain ``jnp`` reference on a CUDA GPU.

CPU runs cover the kernel in Pallas interpret mode; a miscompile of the
Triton route would slip through them.  These tests compare the compiled
kernel at real widths (1920x1080) and skip without a GPU; ``python
chip_smoke.py`` runs them on one.  Tolerances: ``utils/parity.py``.
"""

import dataclasses

import pytest

from cellularautomatons3d_tpu.render.renderer import RenderStatic
from cellularautomatons3d_tpu.utils import parity

W, H = 1920, 1080


def _check(m):
    assert m["hits"] > 0
    assert parity.within_tolerance(m), m


@pytest.mark.gpu
@pytest.mark.parametrize("steps", [85, 230], ids=["pinned", "dense"])
def test_compiled_256_matches_reference(steps):
    s = RenderStatic(width=W, height=H, grid_size=256)
    _check(parity.compare_traversals(
        s, parity.grown_scene(256, steps), parity.frame_params(W, H)))


@pytest.mark.gpu
def test_compiled_1024_matches_reference():
    n = 1024
    vol = parity.grown_scene(n, 80) | parity.sparse_noise(n, 11)
    s = RenderStatic(width=W, height=H, grid_size=n)
    _check(parity.compare_traversals(s, vol, parity.frame_params(W, H)))


@pytest.mark.gpu
def test_compiled_soft_shadows_and_gi_match_reference():
    s = RenderStatic(width=W, height=H, grid_size=256, soft_shadow_samples=4,
                     indirect_lighting=True)
    params = parity.frame_params(W, H, light_radius=0.08, elapsed_time=0.37)
    _check(parity.compare_traversals(s, parity.grown_scene(256, 85), params))


@pytest.mark.gpu
def test_compiled_age_fade_matches_reference():
    n = 128
    ages = parity.grown_scene(n, 40, total_states=8)
    vis = ages[0] | ages[1] | ages[2]
    s = RenderStatic(width=W, height=H, grid_size=n)
    _check(parity.compare_traversals(
        s, vis, parity.frame_params(W, H), ages, total_states=8))


@pytest.mark.gpu
def test_compiled_fused_loop_matches_reference():
    """The fused loop with each traversal: same state, frames in tolerance."""
    import numpy as np

    from cellularautomatons3d_tpu.models.automaton import AutomatonSpec
    from cellularautomatons3d_tpu.render.renderer_fast import (
        init_fast_history, make_fused_loop)
    from cellularautomatons3d_tpu.utils.config import EngineConfig

    spec = AutomatonSpec.from_config(EngineConfig(grid_size=256))
    state = parity.grown_scene(256, 80)
    s = RenderStatic(width=W, height=H, grid_size=256)
    params = parity.frame_params(W, H)
    outs = []
    for t in ("kernel", "reference"):
        run = make_fused_loop(dataclasses.replace(s, traversal=t), spec, 3)
        st, hist, frame = run(state + 0, params, init_fast_history(W, H))
        outs.append((np.asarray(st), np.asarray(hist.hit_idx),
                     np.asarray(frame)))
    (st_k, i_k, f_k), (st_r, i_r, f_r) = outs
    np.testing.assert_array_equal(st_k, st_r)
    m = parity.frame_agreement(f_k, f_r, i_k, i_r)
    assert m["match"] >= parity.MATCH_MIN, m
    assert np.isfinite(f_k).all()
