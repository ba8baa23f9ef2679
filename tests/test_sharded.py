"""Sharded halo-exchange step vs the single-device step on a virtual
8-device CPU mesh (SURVEY.md §4 item 5)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cellularautomatons3d_tpu.models.automaton import AutomatonSpec
from cellularautomatons3d_tpu.ops.ca_step import step_packed, step_packed_multistate
from cellularautomatons3d_tpu.ops.packing import pack_grid, unpack_grid
from cellularautomatons3d_tpu.parallel.sharded import (
    make_mesh,
    make_sharded_step,
    shard_state,
)
from cellularautomatons3d_tpu.utils.config import BoundaryMode

N = 32


def random_packed(seed=0, p=0.3):
    rng = np.random.default_rng(seed)
    return pack_grid((rng.random((N, N, N)) < p).astype(np.uint8))


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(8)


@pytest.mark.parametrize("boundary", BoundaryMode.ALL)
def test_sharded_step_matches_single_device(mesh, boundary):
    spec = AutomatonSpec.from_rule_strings(
        grid_size=N, neighbourhood="moore", born="4,5", survive="2-6",
        boundary=boundary,
    )
    packed = random_packed(seed=hash(boundary) % 2**31)
    want = np.asarray(step_packed(jnp.asarray(packed), spec))

    step = make_sharded_step(spec, mesh)
    sharded = shard_state(jnp.asarray(packed), mesh)
    got = np.asarray(step(sharded))
    np.testing.assert_array_equal(got, want)


def test_sharded_step_multiple_generations(mesh):
    spec = AutomatonSpec.from_rule_strings(grid_size=N)
    dense = np.zeros((N, N, N), np.uint8)
    dense[N // 2 - 1, N // 2 - 1, N // 2 - 1] = 1
    packed = jnp.asarray(pack_grid(dense))

    step = make_sharded_step(spec, mesh)
    sharded = shard_state(packed, mesh)
    ref = packed
    for _ in range(8):
        ref = step_packed(ref, spec)
        sharded = step(sharded)
    np.testing.assert_array_equal(np.asarray(sharded), np.asarray(ref))
    # Growth must have crossed shard boundaries by step 8 (radius 8 > 4-wide
    # slabs) — otherwise the halo exchange was never exercised.
    assert unpack_grid(np.asarray(sharded)).sum() > 100


def test_sharded_multistate(mesh):
    spec = AutomatonSpec.from_rule_strings(
        grid_size=N, neighbourhood="moore", born="4", survive="4",
        total_states=5,
    )
    rng = np.random.default_rng(3)
    dense = rng.integers(0, 5, size=(N, N, N)).astype(np.uint8)
    planes = jnp.asarray(
        np.stack([pack_grid((dense >> i) & 1) for i in range(spec.age_bits)])
    )
    want = np.asarray(step_packed_multistate(planes, spec))

    step = make_sharded_step(spec, mesh)
    got = np.asarray(step(shard_state(planes, mesh)))
    np.testing.assert_array_equal(got, want)


def test_uneven_grid_rejected(mesh):
    spec = AutomatonSpec.from_rule_strings(grid_size=N)
    bad_mesh = make_mesh(3)
    with pytest.raises(ValueError):
        make_sharded_step(spec, bad_mesh)


def test_config5_sharded_step_plus_render(mesh):
    """BASELINE config 5 shape: grid sharded across the mesh with halo
    exchange, stepped, then rendered from the (bit-packed, hence small)
    replicated grid — end to end on the virtual mesh."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from cellularautomatons3d_tpu.render.renderer import (
        RenderStatic, init_history, render_frame,
    )
    from cellularautomatons3d_tpu.utils import mat4

    n = 64
    spec = AutomatonSpec.from_rule_strings(grid_size=n)
    dense = np.zeros((n, n, n), np.uint8)
    dense[n // 2 - 1, n // 2 - 1, n // 2 - 1] = 1
    step = make_sharded_step(spec, mesh)
    state = shard_state(jnp.asarray(pack_grid(dense)), mesh)
    for _ in range(10):
        state = step(state)

    # Replicate the packed grid (64³/8 = 32 KiB) for rendering.
    replicated = jax.device_put(state, NamedSharding(mesh, P()))
    view = mat4.initial_view_matrix()
    proj = mat4.initial_projection_matrix(64, 48)
    pv = mat4.multiply(proj, mat4.inverse(view))
    s = RenderStatic(width=64, height=48, grid_size=n, depth_samples=20,
                     shadow_samples=6)
    from cellularautomatons3d_tpu.render.renderer import RenderParams

    params = RenderParams(
        view_mat=jnp.asarray(view), prev_view_mat=jnp.asarray(view),
        prev_proj_view=jnp.asarray(pv), elapsed_time=jnp.float32(0.1),
        cell_size=jnp.float32(0.85), temporal_alpha=jnp.float32(0.1),
        gamma=jnp.float32(2.0), roughness=jnp.float32(0.29),
        base_reflectivity=jnp.full((3,), 0.17, jnp.float32),
        material_color=jnp.zeros((3,), jnp.float32),
        light_pos=jnp.asarray([0.721, 1.0, 1.0], jnp.float32),
        light_magnitude=jnp.float32(5.0),
        show_depth_overlay=jnp.float32(0.0),
    )
    frame, _ = render_frame(s, replicated, params, init_history(64, 48))
    f = np.asarray(frame)
    assert f.shape == (48, 64, 3) and np.isfinite(f).all() and f.max() > 0
    # And the sharded state matches the single-device evolution.
    ref = jnp.asarray(pack_grid(dense))
    for _ in range(10):
        ref = step_packed(ref, spec)
    np.testing.assert_array_equal(np.asarray(state), np.asarray(ref))


# ------------------------------------------------------- 2-D (z, y) mesh --
#
# Multi-host-scale decomposition: the grid shards along Z and Y; the step
# exchanges z word-planes, then y word-columns of the z-padded slab
# (corner ribbons ride the second exchange).  Differential-equal to the
# single-device step for every boundary mode.


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
@pytest.mark.parametrize("boundary", BoundaryMode.ALL)
def test_sharded_2d_step_matches_single_device(shape, boundary):
    spec = AutomatonSpec.from_rule_strings(
        grid_size=N, neighbourhood="moore", born="4,5", survive="2-6",
        boundary=boundary,
    )
    packed = random_packed(seed=(hash(boundary) + shape[0]) % 2**31)
    want = np.asarray(step_packed(jnp.asarray(packed), spec))

    mesh2 = make_mesh(shape=shape)
    step = make_sharded_step(spec, mesh2)
    got = np.asarray(step(shard_state(jnp.asarray(packed), mesh2)))
    np.testing.assert_array_equal(got, want)


def test_sharded_2d_multistate_generations():
    spec = AutomatonSpec.from_rule_strings(
        grid_size=N, neighbourhood="moore", born="4", survive="4",
        total_states=5,
    )
    rng = np.random.default_rng(7)
    dense = rng.integers(0, 5, size=(N, N, N)).astype(np.uint8)
    planes = jnp.asarray(
        np.stack([pack_grid((dense >> i) & 1) for i in range(spec.age_bits)])
    )
    mesh2 = make_mesh(shape=(2, 2))
    step = make_sharded_step(spec, mesh2)
    got = shard_state(planes, mesh2)
    ref = planes
    for _ in range(4):
        ref = step_packed_multistate(ref, spec)
        got = step(got)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_sharded_2d_validation():
    spec = AutomatonSpec.from_rule_strings(grid_size=N)
    with pytest.raises(ValueError):
        make_sharded_step(spec, make_mesh(shape=(1, 3)))  # 32 % 3 != 0
    with pytest.raises(ValueError):
        make_mesh(shape=(16, 16))  # more devices than exist
