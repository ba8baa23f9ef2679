"""Engine lifecycle tests: frame-loop cadence, live/restart parameter split,
checkpoint round trip (SURVEY.md §3.2, §3.3, §5)."""

import numpy as np
import pytest

import cellularautomatons3d_tpu as ca


def small_engine(**kw):
    kw.setdefault("grid_size", 32)
    kw.setdefault("width", 64)
    kw.setdefault("height", 48)
    kw.setdefault("depth_samples", 15)
    kw.setdefault("shadow_samples", 8)
    return ca.Engine(ca.EngineConfig(**kw))


def test_initial_state_center_seed():
    eng = small_engine()
    dense = eng.state_dense()
    assert dense.sum() == 1
    c = 32 // 2 - 1
    assert dense[c, c, c] == 1


def test_step_advances_counter_and_state():
    eng = small_engine()
    eng.step(3)
    assert eng.simulation_step == 3
    assert eng.state_dense().sum() > 1


def test_tick_cadence():
    # Default step duration 48 ms at 16.667 ms frames: step fires on the
    # 3rd frame (accumulated 50 ms ≥ 48), as in main_pathtraced.js:1838-1847.
    eng = small_engine()
    eng.tick()
    eng.tick()
    assert eng.simulation_step == 0
    eng.tick()
    assert eng.simulation_step == 1


def test_render_returns_frame_and_updates_history():
    eng = small_engine()
    assert eng.config.pipeline == "fast"
    eng.step(6)
    f = np.asarray(eng.render())
    assert f.shape == (48, 64, 3)
    assert np.isfinite(f).all()
    assert f.max() > 0  # growth visible from the default camera
    assert (np.asarray(eng.history.hit_idx) >= 0).sum() > 0


def test_live_vs_restart_params():
    eng = small_engine()
    eng.set("gamma", 2.4)
    assert eng.config.gamma == 2.4 and not eng.restart_required
    eng.set("light.magnitude", 7.0)
    assert eng.config.light.magnitude == 7.0
    eng.set("born", "4")
    assert eng.restart_required
    assert eng.config.born == "1,3"  # deferred, like applyOnRestart
    eng.step(2)
    eng.restart()
    assert eng.config.born == "4"
    assert eng.simulation_step == 0
    assert eng.state_dense().sum() == 1  # reseeded


def test_multistate_engine_runs_and_renders():
    eng = small_engine(neighbourhood="moore", born="4", survive="4", total_states=5)
    eng.step(2)
    dense = eng.state_dense()
    assert dense.max() >= 1
    f = np.asarray(eng.render())
    assert np.isfinite(f).all()


def test_checkpoint_roundtrip(tmp_path):
    eng = small_engine()
    eng.step(5)
    eng.render()
    p = str(tmp_path / "ckpt.npz")
    eng.save(p)
    eng2 = ca.Engine.load(p)
    assert eng2.simulation_step == 5
    np.testing.assert_array_equal(eng2.state_dense(), eng.state_dense())
    np.testing.assert_array_equal(
        np.asarray(eng2.history.color), np.asarray(eng.history.color)
    )
    # Resumed engine continues identically.
    eng.step(2)
    eng2.step(2)
    np.testing.assert_array_equal(eng2.state_dense(), eng.state_dense())


def test_camera_rig_moves_camera():
    eng = small_engine()
    pos0 = eng.camera.view_mat[:3, 3].copy()
    eng.camera.translate((0, 0, -1), 0.5)  # W key for half a second
    pos1 = eng.camera.view_mat[:3, 3]
    assert pos1[2] < pos0[2]
    eng.camera.wheel(-100)  # speed up
    assert eng.camera.translation_speed_mul > 0.2


def test_reference_pipeline_render():
    eng = small_engine(pipeline="reference")
    eng.step(6)
    f = np.asarray(eng.render())
    assert f.shape == (48, 64, 3) and np.isfinite(f).all() and f.max() > 0
    assert np.asarray(eng.history.depth).max() > 0


def test_multistate_age_coloring_fades():
    # Reference pipeline with ages: a dying cell renders dimmer than alive.
    # Plenty of depth samples: the stochastic march must not miss the
    # single target cell at this tiny resolution.
    eng = small_engine(
        pipeline="reference", born="27", survive="27", total_states=8,
        neighbourhood="moore", depth_samples=150,
    )
    c = 32 // 2 - 1
    dense = np.zeros((32, 32, 32), np.uint8)
    dense[c, c, c] = 1
    eng.set_state_dense(dense)
    f_alive = np.asarray(eng.render())
    eng.step(3)  # cell decays to age 4 (no survive)
    assert eng.state_dense()[c, c, c] == 4
    f_dying = np.asarray(eng.render())
    assert f_alive.max() > 0
    assert f_dying.max() < f_alive.max()  # faded but still visible
    eng.step(4)  # age 8 → wraps to 0: gone
    assert eng.state_dense().sum() == 0


def test_simple_render_variant():
    # Non-clustered pipeline (pathtraced_fragment.wgsl): ad-hoc lighting,
    # fixed gamma 2.2 — must render the same geometry with different shading.
    eng = small_engine(render_variant="simple", depth_samples=60)
    eng.step(6)
    f_simple = np.asarray(eng.render())
    eng2 = small_engine(pipeline="reference", depth_samples=60)
    eng2.step(6)
    f_pbr = np.asarray(eng2.render())
    assert f_simple.max() > 0 and np.isfinite(f_simple).all()
    # Nearly identical silhouette (the ad-hoc model can shade a lit pixel
    # to exactly 0), different shading values.
    mismatch = ((f_simple.sum(-1) > 0) != (f_pbr.sum(-1) > 0)).mean()
    assert mismatch < 0.01
    assert np.abs(f_simple - f_pbr).max() > 0.01


def test_live_pipeline_switch_rebuilds_history():
    # ADVICE r1: set('pipeline','reference') must rebuild history so the
    # next render doesn't crash on a FastHistory/RenderHistory mismatch.
    eng = small_engine()
    eng.step(4)
    eng.render()
    eng.set("pipeline", "reference")
    assert not eng.restart_required
    f = np.asarray(eng.render())  # would raise AttributeError before fix
    assert np.isfinite(f).all()
    eng.set("pipeline", "fast")
    f = np.asarray(eng.render())
    assert np.isfinite(f).all()


def test_live_sample_count_change_applies():
    # depth/shadow samples are live uniforms in the reference; a live set
    # must take effect on the next frame (render_static rebuilt).
    eng = small_engine(pipeline="reference")
    eng.set("depth_samples", 40)
    assert eng.render_static.depth_samples == 40
    eng.set("indirect_lighting", True)
    assert eng.render_static.indirect_lighting
    f = np.asarray(eng.render())
    assert np.isfinite(f).all()


def test_live_resize_reallocates_history():
    # main_pathtraced.js:781-797 resizes mid-run; width/height are live.
    eng = small_engine()
    eng.step(4)
    eng.render()
    eng.set("width", 80).set("height", 60)
    assert not eng.restart_required
    f = np.asarray(eng.render())
    assert f.shape == (60, 80, 3)
    assert eng.history.color.shape[:2] == (60, 80)


def test_nested_set_does_not_mutate_shared_config():
    cfg = ca.EngineConfig(grid_size=32, width=64, height=48)
    eng = ca.Engine(cfg)
    eng.set("light.magnitude", 9.0)
    assert eng.config.light.magnitude == 9.0
    assert cfg.light.magnitude == 5.0  # original config object untouched


def test_checkpoint_restores_camera_reprojection_state(tmp_path):
    eng = small_engine(pipeline="reference")
    eng.step(3)
    eng.render()
    eng.tick()  # accumulate some _frame_duration and prev matrices
    p = str(tmp_path / "ckpt.npz")
    eng.save(p)
    eng2 = ca.Engine.load(p)
    np.testing.assert_array_equal(
        eng2.camera.prev_proj_view, eng.camera.prev_proj_view
    )
    assert eng2._frame_duration == eng._frame_duration
    # First resumed frame reprojects identically to the original engine.
    f1 = np.asarray(eng.render())
    f2 = np.asarray(eng2.render())
    np.testing.assert_array_equal(f1, f2)


def test_lighting_extensions_indirect_soft_emissive():
    base = dict(grid_size=32, width=64, height=48, depth_samples=60,
                shadow_samples=8, pipeline="reference")
    dense = np.zeros((32, 32, 32), np.uint8)
    dense[12:20, 12:20, 12:20] = 1

    def frame(**kw):
        eng = ca.Engine(ca.EngineConfig(**base, **kw))
        eng.set_state_dense(dense)
        return np.asarray(eng.render())

    plain = frame()
    gi = frame(indirect_lighting=True)
    soft = frame(soft_shadow_samples=4, light_radius=0.2)
    emis = frame(emissive_color=(0.0, 0.3, 0.0), emissive_strength=1.0)

    assert np.isfinite(gi).all() and np.isfinite(soft).all()
    # Indirect adds energy somewhere on lit pixels.
    assert gi.sum() > plain.sum()
    # Emissive adds green to every hit pixel.
    hit = plain.sum(-1) > 0
    assert (emis[..., 1][hit] >= plain[..., 1][hit] - 1e-6).all()
    assert emis.sum() > plain.sum()
    # Soft shadows remain a valid image and differ from hard shadows.
    assert np.isfinite(soft).all() and np.abs(soft - plain).max() > 1e-4


def test_checkpoint_roundtrip_orbax(tmp_path):
    """Orbax checkpoint backend (multi-host-safe directory format): the
    round trip must restore exactly what the npz backend does."""
    eng = small_engine()
    eng.step(4)
    eng.render()
    eng.camera.translate((0, 0, -1), 0.25)
    p = str(tmp_path / "ckpt_orbax")
    eng.save(p, backend="orbax")
    eng2 = ca.Engine.load(p)  # directory → orbax auto-detected
    assert eng2.simulation_step == 4
    np.testing.assert_array_equal(eng2.state_dense(), eng.state_dense())
    np.testing.assert_array_equal(
        np.asarray(eng2.history.color), np.asarray(eng.history.color)
    )
    np.testing.assert_array_equal(eng2.camera.view_mat, eng.camera.view_mat)
    eng.step(2)
    eng2.step(2)
    np.testing.assert_array_equal(eng2.state_dense(), eng.state_dense())


def test_checkpoint_orbax_unknown_backend():
    eng = small_engine()
    import pytest as _pytest

    with _pytest.raises(ValueError):
        eng.save("x.npz", backend="hdf5")


def test_run_fused_reuses_loop_per_shape():
    """run_fused builds one loop per (frames, steps_per_frame) and reuses
    it; a render-asset change drops the cached loops."""
    eng = small_engine()
    eng.run_fused(2)
    loop = eng._fused_loops[(2, 1)]
    eng.run_fused(2)
    assert eng._fused_loops == {(2, 1): loop}
    assert eng.simulation_step == 4
    eng.set("shadow_samples", 3)
    assert eng._fused_loops == {}
