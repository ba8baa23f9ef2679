"""Fast-pipeline wrapper: temporal accumulation (static + moving camera).

The moving-camera path reprojects the hit point through the previous
view-projection matrix (getReprojectedUV, wgsl:473-487) and keeps history
when the stored hit-cell id matches (mixWithReprojectedColor, wgsl:429-471)
— round 1 discarded all history on motion.
"""

import numpy as np
import jax.numpy as jnp

import cellularautomatons3d_tpu as ca
from cellularautomatons3d_tpu.render import renderer as R
from cellularautomatons3d_tpu.render.renderer_fast import (
    FastHistory,
    init_fast_history,
    render_frame_fast,
)
from cellularautomatons3d_tpu.utils import mat4



N = 64
W_IMG, H_IMG = 128, 64


def make_params(view, prev_view=None, width=W_IMG, height=H_IMG):
    prev_view = view if prev_view is None else prev_view
    proj = mat4.initial_projection_matrix(width, height)
    prev_proj_view = mat4.multiply(proj, mat4.inverse(prev_view))
    return R.RenderParams(
        view_mat=jnp.asarray(view),
        prev_view_mat=jnp.asarray(prev_view),
        prev_proj_view=jnp.asarray(prev_proj_view),
        elapsed_time=jnp.float32(0.1),
        cell_size=jnp.float32(0.85),
        temporal_alpha=jnp.float32(0.1),
        gamma=jnp.float32(2.0),
        roughness=jnp.float32(0.29),
        base_reflectivity=jnp.full((3,), 0.17, jnp.float32),
        material_color=jnp.zeros((3,), jnp.float32),
        light_pos=jnp.asarray([0.721, 1.0, 1.0], jnp.float32),
        light_magnitude=jnp.float32(5.0),
        show_depth_overlay=jnp.float32(0.0),
    )


def scene():
    dense = np.zeros((N, N, N), np.uint8)
    dense[24:40, 24:40, 24:40] = 1
    return jnp.asarray(ca.pack_grid(dense))


STATIC = R.RenderStatic(
    width=W_IMG, height=H_IMG, grid_size=N, depth_samples=8, shadow_samples=4
)


def test_static_camera_ema_accumulates():
    packed = scene()
    view = mat4.initial_view_matrix()
    params = make_params(view)
    _, _, hist = render_frame_fast(STATIC, packed, params, init_fast_history(W_IMG, H_IMG))
    # Poison the history color where hits landed; EMA must pull toward it.
    hit = np.asarray(hist.hit_idx) >= 0
    assert hit.sum() > 0
    poisoned = FastHistory(
        color=jnp.where(jnp.asarray(hit)[..., None], jnp.ones((H_IMG, W_IMG, 3)), 0.0).astype(jnp.float16),
        hit_idx=hist.hit_idx,
    )
    _, _, hist2 = render_frame_fast(STATIC, packed, params, poisoned)
    out = np.asarray(hist2.color, np.float32)
    raw = np.asarray(hist.color, np.float32)
    # out = 1 + (raw - 1) * alpha, clipped — strictly above the raw sample.
    assert (out[hit] > raw[hit] + 0.1).mean() > 0.9


def test_panning_camera_keeps_history_via_reprojection():
    packed = scene()
    view_a = mat4.initial_view_matrix()
    # Small pan: rotate about y and nudge sideways — most of the block
    # stays on screen, so reprojection should validate many pixels.
    view_b = mat4.translate(mat4.rotate(view_a, (0, 1, 0), 0.05), (0.03, 0, 0))

    params_b = make_params(view_b, prev_view=view_a)
    _, _, fresh = render_frame_fast(
        STATIC, packed, params_b, init_fast_history(W_IMG, H_IMG), False
    )
    raw = np.asarray(fresh.color, np.float32)  # no history: raw sample
    hit = np.asarray(fresh.hit_idx) >= 0
    assert hit.sum() > 0

    # History rendered from camera A, poisoned to pure white on hits.
    _, _, hist_a = render_frame_fast(
        STATIC, packed, make_params(view_a), init_fast_history(W_IMG, H_IMG)
    )
    white_hist = FastHistory(
        color=jnp.where(
            (hist_a.hit_idx >= 0)[..., None], jnp.ones((H_IMG, W_IMG, 3)), 0.0
        ).astype(jnp.float16),
        hit_idx=hist_a.hit_idx,
    )
    _, _, moved = render_frame_fast(STATIC, packed, params_b, white_hist, False)
    out = np.asarray(moved.color, np.float32)

    pulled = (out[hit] > raw[hit] + 0.1).mean()
    # Reject-everything (round-1 behaviour) would give pulled == 0.
    assert pulled > 0.5, f"only {pulled:.2%} of hit pixels kept history"


def test_depth_overlay_not_in_history():
    packed = scene()
    params = make_params(mat4.initial_view_matrix())
    params = params._replace(show_depth_overlay=jnp.float32(1.0))
    frame, depth, hist = render_frame_fast(
        STATIC, packed, params, init_fast_history(W_IMG, H_IMG)
    )
    frame = np.asarray(frame)
    # Overlay visible in the presentation (left half red channel = depth)...
    left = frame[:, : W_IMG // 2]
    assert (left[..., 1:] == 0).all()
    # ...but history keeps the scene color (green/blue survive on hits).
    hcol = np.asarray(hist.color, np.float32)
    hit_left = np.asarray(hist.hit_idx[:, : W_IMG // 2]) >= 0
    assert hcol[:, : W_IMG // 2][hit_left][:, 1:].max() > 0


def test_fused_compose_loop_matches_frame_sequence():
    """The fused on-device loop must match iterating render_frame_fast
    frame for frame."""
    from cellularautomatons3d_tpu.render.renderer_fast import make_fused_loop

    spec = ca.AutomatonSpec.from_config(ca.EngineConfig(grid_size=N))
    step = ca.make_step_fn(spec)
    st = jnp.asarray(ca.pack_grid(ca.seed_center(N)))
    for _ in range(8):
        st = step(st)
    params = make_params(mat4.initial_view_matrix())

    frames = 3
    run = make_fused_loop(STATIC, spec, frames)
    st_out, hist_out, frame = run(
        st + 0, params, init_fast_history(W_IMG, H_IMG)
    )

    st2 = st
    hist = init_fast_history(W_IMG, H_IMG)
    for _ in range(frames):
        st2 = step(st2)
        frame2, _, hist = render_frame_fast(STATIC, st2, params, hist, True)
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
