"""Temporally-amortized lighting (RenderStatic.gi_temporal).

The real-time GI mode evaluates ONE rotating soft-shadow sample and ONE
rotating GI slot per frame (scaled ×4 — an unbiased 1-of-4 estimator) and
lets the temporal EMA converge — the reference's own stochastic
accumulation pattern (its per-frame shadow ray is jittered and
accumulated, pathtraced_fragment_clustered.wgsl:644,429-471) applied to
the extended lighting of BASELINE config 4.

The core invariant: the UNIFORM AVERAGE of the temporal mode's per-frame
outputs over one full rotation equals the non-temporal (all-samples-
per-frame) output, because each rotated sample is bit-identical to the
corresponding static sample (soft_shadow_jitter's constant table;
lighting's dynamic layer indexing).
"""

import numpy as np
import jax.numpy as jnp

import cellularautomatons3d_tpu as ca
from cellularautomatons3d_tpu.render import renderer as R
from cellularautomatons3d_tpu.render.renderer import RenderStatic
from cellularautomatons3d_tpu.render.renderer_fast import trace_shaded
from cellularautomatons3d_tpu.utils import mat4

N = 32
W, H = 64, 32


def _scene():
    rng = np.random.default_rng(11)
    dense = np.zeros((N, N, N), np.uint8)
    blob = rng.random((10, 10, 10)) < 0.3
    dense[11:21, 11:21, 11:21] = blob
    return jnp.asarray(ca.pack_grid(dense))


def _params():
    view = mat4.initial_view_matrix()
    proj = mat4.initial_projection_matrix(W, H)
    return R.RenderParams(
        view_mat=jnp.asarray(view),
        prev_view_mat=jnp.asarray(view),
        prev_proj_view=jnp.asarray(mat4.multiply(proj, mat4.inverse(view))),
        elapsed_time=jnp.float32(0.37),
        cell_size=jnp.float32(0.85),
        temporal_alpha=jnp.float32(0.1),
        gamma=jnp.float32(2.0),
        roughness=jnp.float32(0.29),
        base_reflectivity=jnp.full((3,), 0.17, jnp.float32),
        material_color=jnp.zeros((3,), jnp.float32),
        light_pos=jnp.asarray([0.721, 1.0, 1.0], jnp.float32),
        light_magnitude=jnp.float32(5.0),
        show_depth_overlay=jnp.float32(0.0),
        light_radius=jnp.float32(0.08),
    )


def test_temporal_rotation_mean_equals_full_lighting():
    """Mean over a full 4-sample rotation of the temporal mode ==
    the non-temporal frame (soft_k=4 average + 4-slot GI sum)."""
    vol = _scene()
    params = _params()
    base = dict(
        width=W, height=H, grid_size=N,
        indirect_lighting=True, soft_shadow_samples=4,
    )
    s_full = RenderStatic(**base)
    s_temp = RenderStatic(**base, gi_temporal=True)

    rgb_full, depth_full, idx_full, _ = trace_shaded(s_full, vol, params)
    acc = jnp.zeros_like(rgb_full)
    for k in range(4):
        rgb_k, depth_k, idx_k, _ = trace_shaded(
            s_temp, vol, params, sample_idx=jnp.int32(k)
        )
        np.testing.assert_array_equal(np.asarray(idx_k), np.asarray(idx_full))
        np.testing.assert_array_equal(
            np.asarray(depth_k), np.asarray(depth_full)
        )
        acc = acc + rgb_k
    np.testing.assert_allclose(
        np.asarray(acc / 4.0), np.asarray(rgb_full), rtol=2e-5, atol=1e-6
    )


def test_single_slot_estimates_sum():
    """lighting_passes(gi_slot=i) == 4 × slot i's contribution: the mean of
    the four single-slot calls equals the full 4-slot call."""
    from cellularautomatons3d_tpu.render import lighting, traverse
    from cellularautomatons3d_tpu.render.renderer_fast import pixel_rays

    vol = _scene()
    p = _params()
    o = p.view_mat[:3, 3]
    uv, dirs = pixel_rays(p.view_mat, W, H)
    depth, idx, _ = traverse.trace_primary(
        vol, dirs, o, p.light_pos, p.cell_size, grid_size=N, shadow=False)
    q, origin, coords, found = lighting.hit_geometry(o, dirs, idx, depth, N)

    def gi(slot):
        return np.asarray(lighting.lighting_passes(
            vol, p, q, origin, coords, found, uv, grid_size=N, gi=True,
            gi_slot=slot)[1])

    full = gi(None)
    assert np.abs(full).max() > 0
    acc = sum(gi(jnp.int32(i)) for i in range(4))
    np.testing.assert_allclose(acc / 4.0, full, rtol=2e-5, atol=1e-6)


def test_temporal_fused_loop_matches_frame_sequence():
    """The fused loop with temporal soft shadows + GI (one occlusion launch
    per frame) must match iterating render_frame_fast, frame for frame."""
    from cellularautomatons3d_tpu.render.renderer import RenderParams
    from cellularautomatons3d_tpu.render.renderer_fast import (
        init_fast_history,
        make_fused_loop,
        render_frame_fast,
    )

    spec = ca.AutomatonSpec.from_config(ca.EngineConfig(grid_size=N))
    step = ca.make_step_fn(spec)
    st = _scene()
    view = mat4.initial_view_matrix()
    proj = mat4.initial_projection_matrix(W, H)
    proj_view = mat4.multiply(proj, mat4.inverse(view))
    params = RenderParams(
        view_mat=jnp.asarray(view),
        prev_view_mat=jnp.asarray(view),
        prev_proj_view=jnp.asarray(proj_view),
        elapsed_time=jnp.float32(0.37),
        cell_size=jnp.float32(0.85),
        temporal_alpha=jnp.float32(0.1),
        gamma=jnp.float32(2.0),
        roughness=jnp.float32(0.29),
        base_reflectivity=jnp.full((3,), 0.17, jnp.float32),
        material_color=jnp.zeros((3,), jnp.float32),
        light_pos=jnp.asarray([0.721, 1.0, 1.0], jnp.float32),
        light_magnitude=jnp.float32(5.0),
        show_depth_overlay=jnp.float32(0.0),
        light_radius=jnp.float32(0.08),
    )
    s = RenderStatic(
        width=W, height=H, grid_size=N,
        indirect_lighting=True, soft_shadow_samples=4, gi_temporal=True,
    )

    frames = 3
    run = make_fused_loop(s, spec, frames)
    st_out, hist_out, frame = run(st + 0, params, init_fast_history(W, H))

    st2 = st
    hist = init_fast_history(W, H)
    for i in range(frames):
        st2 = step(st2)
        frame2, _, hist = render_frame_fast(
            s, st2, params, hist, True, None, 2, None, None, jnp.int32(i)
        )
    np.testing.assert_array_equal(np.asarray(st_out), np.asarray(st2))
    np.testing.assert_array_equal(
        np.asarray(hist_out.hit_idx), np.asarray(hist.hit_idx)
    )
    np.testing.assert_allclose(
        np.asarray(frame), np.asarray(frame2), rtol=2e-3, atol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(hist_out.color, np.float32),
        np.asarray(hist.color, np.float32), rtol=2e-2, atol=2e-3,
    )


def test_engine_gi_temporal_smoke():
    """Engine wiring: gi_temporal renders finite frames and advances the
    sample counter; consecutive static frames differ (rotating samples)
    and accumulate through the EMA."""
    eng = ca.Engine(config=ca.EngineConfig(
        grid_size=N, width=W, height=H,
        indirect_lighting=True, soft_shadow_samples=2,
        light_radius=0.08, gi_temporal=True,
        random_initial_state=True, seed=3,
    ))
    f0 = np.asarray(eng.render())
    f1 = np.asarray(eng.render())
    assert np.isfinite(f0).all() and np.isfinite(f1).all()
    assert eng._render_count == 2
    assert (f0 >= 0).all() and (f1 >= 0).all()
