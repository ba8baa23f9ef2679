"""Fast renderer vs a per-pixel numpy DDA oracle and the exact renderer.

The oracle mirrors the traversal's specification exactly: z-plane DDA with
segment-midpoint cell probes, reference visible-cube accept rules and
snap.  Both traversal implementations — the Pallas kernel (interpret mode
on the CPU) and its plain ``jnp`` reference — must match it on every
pixel.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import cellularautomatons3d_tpu as ca
from cellularautomatons3d_tpu.render import renderer as R
from cellularautomatons3d_tpu.render import traverse
from cellularautomatons3d_tpu.render.camera import COT_HALF_FOV
from cellularautomatons3d_tpu.render.renderer_fast import pixel_rays, trace_shaded
from cellularautomatons3d_tpu.utils import mat4

N = 64
W_IMG, H_IMG = 128, 64
LIGHT = (0.721, 1.0, 1.0)
IMPLS = pytest.mark.parametrize("kernel", [False, True],
                                ids=["reference", "kernel"])


def make_params(view=None, **kw):
    view = mat4.initial_view_matrix() if view is None else view
    args = dict(
        view_mat=jnp.asarray(view),
        prev_view_mat=jnp.asarray(view),
        prev_proj_view=jnp.eye(4, dtype=jnp.float32),
        elapsed_time=jnp.float32(0.0),
        cell_size=jnp.float32(0.85),
        temporal_alpha=jnp.float32(0.1),
        gamma=jnp.float32(2.0),
        roughness=jnp.float32(0.29),
        base_reflectivity=jnp.full((3,), 0.17, jnp.float32),
        material_color=jnp.zeros((3,), jnp.float32),
        light_pos=jnp.asarray(LIGHT, jnp.float32),
        light_magnitude=jnp.float32(5.0),
        show_depth_overlay=jnp.float32(0.0),
    )
    args.update({k: jnp.asarray(v, jnp.float32) for k, v in kw.items()})
    return R.RenderParams(**args)


def trace(dense, shadow=False, view=None, kernel=True, w=W_IMG, h=H_IMG,
          ages=None, total_states=2):
    """(depth, idx, light factor) of the primary traversal."""
    n = dense.shape[0]
    view = mat4.initial_view_matrix() if view is None else view
    vol = jnp.asarray(ca.pack_grid(dense))
    _, dirs = pixel_rays(jnp.asarray(view), w, h)
    return traverse.trace_primary(
        vol, dirs, jnp.asarray(view[:3, 3]), LIGHT, 0.85, ages, grid_size=n,
        shadow=shadow, total_states=total_states, kernel=kernel,
    )


def shaded(dense, params, w=W_IMG, h=H_IMG, **static_kw):
    """trace_shaded over a scene: the full fast-path lighting."""
    n = dense.shape[0]
    s = R.RenderStatic(width=w, height=h, grid_size=n, depth_samples=8,
                       shadow_samples=8, **static_kw)
    vol = jnp.asarray(ca.pack_grid(dense))
    rgb, depth, idx, _ = trace_shaded(s, vol, params)
    return rgb, depth, idx


# ---------------------------------------------------------------- oracle --


_ORACLE_CACHE = {}


def oracle_dda(dense, view, cell_mul=0.85, h=None, w=None):
    """Per-pixel numpy DDA following the traversal spec (primary rays).
    Cached: both implementations of a case compare against one run."""
    h = H_IMG if h is None else h
    w = W_IMG if w is None else w
    key = (dense.tobytes(), np.asarray(view).tobytes(), cell_mul, h, w)
    if key not in _ORACLE_CACHE:
        _ORACLE_CACHE[key] = _oracle_dda(dense, view, cell_mul, h, w)
    return _ORACLE_CACHE[key]


def _oracle_dda(dense, view, cell_mul, h, w):
    n = dense.shape[0]
    rot = view[:3, :3]
    o = view[:3, 3].astype(np.float64)
    depth = np.zeros((h, w), np.float32)
    idx = np.full((h, w), -1, np.int32)
    half = 0.5
    cell_half = cell_mul / n * 0.5
    for py in range(h):
        for px in range(w):
            ux = (px + 0.5) / w
            uy = 1.0 - (py + 0.5) / h
            r = np.array([(ux - 0.5) * (w / h), uy - 0.5, -0.5 * COT_HALF_FOV])
            r /= np.linalg.norm(r)
            d = rot @ r
            with np.errstate(divide="ignore", invalid="ignore"):
                t1 = (-half - o) / d
                t2 = (half - o) / d
            tn = np.minimum(t1, t2).max()
            tf = np.maximum(t1, t2).min()
            if not (tn <= tf and tf >= 0):
                continue
            t_start = max(tn, 0.0)
            ks = range(n) if d[2] > 0 else range(n - 1, -1, -1)
            hit = False
            for k in ks:
                with np.errstate(divide="ignore", invalid="ignore"):
                    ta = (k / n - half - o[2]) / d[2]
                    tb = ((k + 1) / n - half - o[2]) / d[2]
                lo = max(min(ta, tb), t_start)
                hi = min(max(ta, tb), tf)
                if not lo < hi:
                    continue
                tm = 0.5 * (lo + hi)
                cx = int(np.clip(np.floor((o[0] + tm * d[0] + half) * n), 0, n - 1))
                cy = int(np.clip(np.floor((o[1] + tm * d[1] + half) * n), 0, n - 1))
                if not dense[k, cy, cx]:
                    continue
                cc = (np.array([cx, cy, k]) + 0.5) / n - half
                with np.errstate(divide="ignore", invalid="ignore"):
                    a = (cc - cell_half - o) / d
                    b = (cc + cell_half - o) / d
                tnn = np.minimum(a, b).max()
                tff = np.maximum(a, b).min()
                if tnn <= tff and tff >= t_start:
                    depth[py, px] = tnn
                    idx[py, px] = cx + cy * n + k * n * n
                    hit = True
                    break
            if not hit:
                depth[py, px] = tf
    return depth, idx


@IMPLS
def test_fast_single_cell_matches_oracle(kernel):
    dense = np.zeros((N, N, N), np.uint8)
    dense[40, 30, 31] = 1
    depth, idx, _ = trace(dense, kernel=kernel)
    o_depth, o_idx = oracle_dda(dense, mat4.initial_view_matrix())
    np.testing.assert_array_equal(np.asarray(idx), o_idx)
    np.testing.assert_allclose(np.asarray(depth), o_depth, atol=2e-5)
    assert (np.asarray(idx) >= 0).sum() > 0  # the cell is visible


@IMPLS
def test_fast_block_matches_oracle(kernel):
    dense = np.zeros((N, N, N), np.uint8)
    dense[24:40, 24:40, 24:40] = 1
    depth, idx, _ = trace(dense, kernel=kernel)
    o_depth, o_idx = oracle_dda(dense, mat4.initial_view_matrix())
    np.testing.assert_array_equal(np.asarray(idx), o_idx)
    np.testing.assert_allclose(np.asarray(depth), o_depth, atol=2e-5)


@IMPLS
@pytest.mark.parametrize("seed,density", [(5, 0.02), (7, 0.001), (11, 0.15)])
def test_fast_random_scene_matches_oracle_exactly(seed, density, kernel):
    """Randomized scenes must match the oracle on every pixel: the kernel's
    empty-space skipping reads every mip block a probe can fall in."""
    rng = np.random.default_rng(seed)
    dense = (rng.random((N, N, N)) < density).astype(np.uint8)
    _, idx, _ = trace(dense, kernel=kernel)
    _, o_idx = oracle_dda(dense, mat4.initial_view_matrix())
    np.testing.assert_array_equal(np.asarray(idx), o_idx)


@IMPLS
@pytest.mark.parametrize("angle", [0.35, 1.1, 1.45])
def test_fast_random_scene_rotated_exact(angle, kernel):
    """Oblique and near-side-on cameras: rays steep against the z planes
    cross several mip blocks per column."""
    rng = np.random.default_rng(3)
    dense = (rng.random((N, N, N)) < 0.03).astype(np.uint8)
    view = mat4.rotate(mat4.initial_view_matrix(), (0, 1, 0), angle)
    view = mat4.translate(view, (0, 0, 0.2))
    _, idx, _ = trace(dense, view=view, kernel=kernel)
    _, o_idx = oracle_dda(dense, view)
    np.testing.assert_array_equal(np.asarray(idx), o_idx)


@IMPLS
def test_fast_rotated_camera_negative_dz(kernel):
    # Camera on the other side looking +z: rays march toward larger z.
    view = mat4.rotate(mat4.initial_view_matrix(), (0, 1, 0), np.pi)
    view = mat4.translate(view, (0, 0, 1.6))
    dense = np.zeros((N, N, N), np.uint8)
    dense[24:40, 24:40, 24:40] = 1
    depth, idx, _ = trace(dense, view=view, kernel=kernel)
    o_depth, o_idx = oracle_dda(dense, view)
    np.testing.assert_array_equal(np.asarray(idx), o_idx)
    np.testing.assert_allclose(np.asarray(depth), o_depth, atol=2e-5)


# ------------------------------------------------------ shaded fast path --


def _snapped(view, depth, px, py, w=W_IMG, h=H_IMG):
    """(hit point, pixel uv) of pixel (px, py) at the traced depth."""
    ux = (px + 0.5) / w
    uy = 1.0 - (py + 0.5) / h
    r = np.array([(ux - 0.5) * (w / h), uy - 0.5, -0.5 * COT_HALF_FOV])
    r /= np.linalg.norm(r)
    p = jnp.asarray(view[:3, 3] + view[:3, :3] @ r * depth[py, px], jnp.float32)
    return p, (ux, uy)


def _exact_direct(p, n, params):
    from cellularautomatons3d_tpu.render import brdf
    from cellularautomatons3d_tpu.render.intersect import cell_from_sample_point

    coords, origin, _ = cell_from_sample_point(p, n)
    return brdf.calculate_lighting_at(
        p, origin, coords, params.view_mat[:3, 3],
        jnp.full((3,), 5.0, jnp.float32), params.light_pos, grid_size=n,
        roughness=params.roughness, material_color=params.material_color,
        base_reflectivity=params.base_reflectivity,
    ), coords, origin


def test_fast_color_matches_exact_renderer_brdf():
    """Unshadowed single-cell scene: the fast path's lit color must equal
    the exact renderer's lighting at the same snapped point."""
    dense = np.zeros((N, N, N), np.uint8)
    dense[40, 31, 31] = 1
    params = make_params()
    rgb, depth, idx = map(np.asarray, shaded(dense, params))
    ys, xs = np.nonzero(idx >= 0)
    assert len(ys) > 0
    view = mat4.initial_view_matrix()
    for py, px in list(zip(ys, xs))[:5]:
        p, _ = _snapped(view, depth, px, py)
        want, _, _ = _exact_direct(p, N, params)
        np.testing.assert_allclose(rgb[py, px], np.asarray(want),
                                   rtol=2e-3, atol=2e-4)


@IMPLS
def test_fast_shadowing(kernel):
    # A wall between the light and a target cell: the target is occluded.
    dense = np.zeros((N, N, N), np.uint8)
    dense[40, 31, 31] = 1          # target cell (visible from camera at +z)
    dense[44:47, 34:46, 28:42] = 1  # slab above/behind toward the light
    _, idx, fac = map(np.asarray, trace(dense, shadow=True, kernel=kernel))
    target_idx = 31 + 31 * N + 40 * N * N
    mask = idx == target_idx
    assert mask.sum() > 0
    np.testing.assert_array_equal(fac[mask], np.float32(traverse.OCCLUDED_FACTOR))
    _, _, fac_n = map(np.asarray, trace(dense, shadow=False, kernel=kernel))
    assert (fac_n == 1.0).all()


def test_fast_emissive_adds_unshadowed_radiance():
    """Emissive cells add their own radiance after shadowing
    (renderer.py:284-285): delta = emissive_color * strength on hits."""
    dense = np.zeros((N, N, N), np.uint8)
    dense[40, 28:34, 28:34] = 1
    rgb0, _, idx = shaded(dense, make_params())
    rgb1, _, _ = shaded(dense, make_params(emissive_color=(0.1, 0.2, 0.3),
                                           emissive_strength=0.5))
    hit = np.asarray(idx) >= 0
    delta = np.asarray(rgb1)[hit] - np.asarray(rgb0)[hit]
    np.testing.assert_allclose(
        delta, np.broadcast_to([0.05, 0.1, 0.15], delta.shape), atol=1e-5
    )
    assert (np.asarray(rgb1)[~hit] == np.asarray(rgb0)[~hit]).all()


def test_fast_soft_shadows_penumbra():
    """A finite light radius + jittered occlusion samples produce partial
    occlusion (between the hard-shadow quotient and 1) somewhere
    (renderer.py:236-245)."""
    dense = np.zeros((N, N, N), np.uint8)
    dense[40, 24:40, 24:40] = 1       # wall facing the camera
    dense[44:46, 34:44, 30:34] = 1    # small occluder toward the light
    soft = make_params(light_radius=0.25, elapsed_time=0.3)
    # Unshadowed light: the hard-shadowed frame over its shadow factor.
    rgb_n, _, idx = shaded(dense, make_params(), soft_shadow_samples=1)
    _, _, fac = trace(dense, shadow=True)
    rgb_n = np.asarray(rgb_n) / np.asarray(fac)[..., None]
    rgb_s, _, _ = map(np.asarray, shaded(dense, soft, soft_shadow_samples=8))
    hit = (np.asarray(idx) >= 0) & (rgb_n.sum(-1) > 1e-3)
    # soft stays within [hard-shadowed, unshadowed] bounds...
    assert (rgb_s[hit] <= rgb_n[hit] + 1e-4).all()
    # ...and some pixels are genuinely penumbral (not 1.0, not 0.0095).
    ratio = rgb_s.sum(-1)[hit] / np.maximum(rgb_n.sum(-1)[hit], 1e-9)
    assert ((ratio > 0.05) & (ratio < 0.95)).any(), "no penumbra found"


def _gi_oracle(dense, params, s, depth, px, py, w, h):
    from cellularautomatons3d_tpu.render.renderer import _indirect_lighting

    n = dense.shape[0]
    view = np.asarray(params.view_mat)
    p, uv = _snapped(view, depth, px, py, w, h)
    direct, coords, origin = _exact_direct(p, n, params)
    packed_flat = jnp.asarray(ca.pack_grid(dense)).reshape(-1)
    gi = _indirect_lighting(
        packed_flat, p, origin, coords, jnp.asarray(uv, jnp.float32),
        jnp.float32(0.0), params, s, jnp.asarray(True),
    )
    return np.asarray(direct), np.asarray(gi)


def test_fast_indirect_matches_exact_renderer():
    """GI parity: on an unshadowed 2-cell scene the fast path's output must
    equal the exact pipeline's direct + _indirect_lighting + emissive at
    the same snapped hit point."""
    dense = np.zeros((N, N, N), np.uint8)
    dense[40, 31, 31] = 1   # target (z=40, y=31, x=31), camera looks at +z face
    dense[41, 31, 32] = 1   # face-5 slot neighbour (+1, 0, +1)
    emis_c, emis_s = (0.02, 0.03, 0.04), 0.5
    params = make_params(emissive_color=emis_c, emissive_strength=emis_s)
    rgb, depth, idx = map(np.asarray,
                          shaded(dense, params, indirect_lighting=True))
    target = 31 + 31 * N + 40 * N * N
    ys, xs = np.nonzero(idx == target)
    assert len(ys) > 0
    s = R.RenderStatic(width=W_IMG, height=H_IMG, grid_size=N,
                       depth_samples=8, shadow_samples=8,
                       indirect_lighting=True)
    for py, px in list(zip(ys, xs))[:4]:
        direct, gi = _gi_oracle(dense, params, s, depth, px, py, W_IMG, H_IMG)
        want = direct + gi + np.asarray(emis_c) * emis_s
        np.testing.assert_allclose(rgb[py, px], want, rtol=5e-3, atol=5e-4)


def test_fast_two_bounce_matches_exact_renderer():
    """Multi-bounce GI parity (BASELINE config 4 "multi-bounce"): with
    bounces=2 the fast path must equal the exact pipeline's recursive
    _indirect_lighting at the hit point, and must differ from one bounce
    (the target→neighbour→target path adds radiance)."""
    n, w, h = 32, 32, 16
    dense = np.zeros((n, n, n), np.uint8)
    dense[20, 15, 15] = 1   # target; camera sees its +z face
    dense[21, 15, 16] = 1   # bounce-1 neighbour; its -x slots include the target
    params = make_params()
    rgb1, _, _ = shaded(dense, params, w=w, h=h, indirect_lighting=True)
    rgb2, depth, idx = map(np.asarray, shaded(
        dense, params, w=w, h=h, indirect_lighting=True, indirect_bounces=2))
    target = 15 + 15 * n + 20 * n * n
    ys, xs = np.nonzero(idx == target)
    assert len(ys) > 0
    assert np.abs(rgb2[ys, xs] - np.asarray(rgb1)[ys, xs]).max() > 1e-6
    s = R.RenderStatic(width=w, height=h, grid_size=n, depth_samples=8,
                       shadow_samples=8, indirect_lighting=True,
                       indirect_bounces=2)
    for py, px in list(zip(ys, xs))[:3]:
        direct, gi = _gi_oracle(dense, params, s, depth, px, py, w, h)
        np.testing.assert_allclose(rgb2[py, px], direct + gi,
                                   rtol=5e-3, atol=5e-4)


def test_fast_empty_grid_black():
    dense = np.zeros((N, N, N), np.uint8)
    rgb, depth, idx = shaded(dense, make_params())
    assert np.asarray(rgb).max() == 0.0
    assert (np.asarray(idx) == -1).all()
    # Depth = distance to volume exit for rays that crossed the volume.
    assert np.asarray(depth).max() > 0.5


@IMPLS
def test_fast_age_coloring(kernel):
    """Multi-state ages fade the direct light like the exact renderer:
    age 6 of 8 → (8 - 6) / 7."""
    dense = np.zeros((N, N, N), np.uint8)
    dense[40, 28:36, 28:36] = 6
    ages = jnp.asarray(np.stack([ca.pack_grid((dense >> i) & 1)
                                 for i in range(3)]))
    _, idx, fac = map(np.asarray, trace(dense != 0, kernel=kernel, ages=ages,
                                        total_states=8))
    hit = idx >= 0
    assert hit.sum() > 0
    np.testing.assert_allclose(fac[hit], 2.0 / 7.0, rtol=1e-6)
    assert (fac[~hit] == 1.0).all()
