"""The path-traced volume renderer: one full frame as a jittable function.

This is the JAX equivalent of the active fragment shader
(pathtraced_fragment_clustered.wgsl:800-890) and its render-pass plumbing
(main_pathtraced.js:1775-1794): per-pixel primary ray → volume slab test →
stochastic first-hit march → temporal depth refinement → Cook-Torrance
direct lighting with a shadow march → temporal color reprojection →
multi-render-target outputs (gamma-corrected presentation, linear light
accumulation, depth).

The WebGPU ping-pong history textures become carried state: the function
takes the previous frame's (color, depth) images and returns this frame's,
exactly as the MRT attachments + bind-group swap do
(main_pathtraced.js:1779-1793).  History is stored at float16 precision to
match the rgba16float/rg16float texture formats
(main_pathtraced.js:729-779).

Everything is vectorized over a flat pixel axis; the only data-dependent
accesses are word gathers into the packed grid and pixel gathers into the
history images.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import brdf
from .camera import pixel_uvs, get_ray
from .intersect import (
    HALF_CUBE_SIZE,
    FULL_CUBE_SIZE,
    ray_cube_intersect,
    sd_box,
    cube_face_normal,
    cell_from_sample_point,
    get_cell_state,
    n1rand,
)
from .raymarch import ray_march_depth, ray_march_shadow

__all__ = ["RenderStatic", "RenderParams", "RenderHistory", "render_frame", "init_history"]


@dataclasses.dataclass(frozen=True)
class RenderStatic:
    """Trace-time render constants (recompile on change)."""

    width: int
    height: int
    grid_size: int
    depth_samples: int = 35
    shadow_samples: int = 30
    # Extensions (BASELINE.json config 4); defaults match the reference:
    # one-bounce indirect lighting exists but is disabled in the shader
    # (call commented out, wgsl:424), shadows are hard (1 ray).
    indirect_lighting: bool = False
    soft_shadow_samples: int = 1
    # Recursion depth of the indirect term: 1 = the reference's single
    # bounce (wgsl:307-377); b > 1 feeds each neighbour's own indirect
    # radiance into the next level (4^b neighbour evaluations).
    indirect_bounces: int = 1
    # Temporally-amortized lighting (fast pipeline only): soft shadows
    # and GI evaluate ONE rotating sample per frame and let the temporal
    # EMA converge to the full multi-sample result — the reference's own
    # stochastic-accumulation pattern (its per-frame shadow ray is
    # jittered and accumulated, wgsl:644,429-471) applied to the
    # extended lighting.  Requires a frame counter (sample_idx) from the
    # caller; implies indirect_bounces == 1.
    gi_temporal: bool = False
    # Traversal of the fast pipeline: "kernel" = the Pallas kernel
    # (render/traverse.py), "reference" = its plain jnp version, the
    # parity reference and the baseline the kernel is timed against.
    traversal: str = "kernel"


class RenderParams(NamedTuple):
    """Live per-frame operands — the uniform-arena contents
    (CommonBufferLayout, pathtraced_fragment_clustered.wgsl:17-34)."""

    view_mat: jnp.ndarray          # [4,4] camera-to-world
    prev_view_mat: jnp.ndarray     # [4,4]
    prev_proj_view: jnp.ndarray    # [4,4] — "prevProjViewMatInv" (misnomer)
    elapsed_time: jnp.ndarray      # f32 scalar (performance.now()*1e-4)
    cell_size: jnp.ndarray         # f32, visible-cube fraction
    temporal_alpha: jnp.ndarray    # f32
    gamma: jnp.ndarray             # f32 (output pow(c, 1/gamma))
    roughness: jnp.ndarray         # f32
    base_reflectivity: jnp.ndarray # [3]
    material_color: jnp.ndarray    # [3] (all-zero ⇒ position rainbow)
    light_pos: jnp.ndarray         # [3]
    light_magnitude: jnp.ndarray   # f32
    show_depth_overlay: jnp.ndarray  # f32 (1.0 = on)
    # Extensions (zero-defaults preserve reference behaviour):
    light_radius: jnp.ndarray = jnp.float32(0.0)      # area light → soft shadows
    emissive_color: jnp.ndarray = jnp.zeros(3, jnp.float32)
    emissive_strength: jnp.ndarray = jnp.float32(0.0)


class RenderHistory(NamedTuple):
    color: jnp.ndarray  # [H, W, 4] float16 (rgba16float parity)
    depth: jnp.ndarray  # [H, W, 2] float16 (rg16float parity)


def init_history(width: int, height: int) -> RenderHistory:
    """Zero history (WebGPU zero-initializes fresh textures)."""
    return RenderHistory(
        color=jnp.zeros((height, width, 4), dtype=jnp.float16),
        depth=jnp.zeros((height, width, 2), dtype=jnp.float16),
    )


def _texture_load(img, uv, width: int, height: int):
    """textureLoad(img, vec2i(uv * windowSize)): truncate then clamp.

    WGSL float→int conversion truncates toward zero; out-of-bounds
    textureLoad is indeterminate in WebGPU — we clamp (documented choice).
    """
    px = jnp.clip((uv[..., 0] * width).astype(jnp.int32), 0, width - 1)
    py = jnp.clip((uv[..., 1] * height).astype(jnp.int32), 0, height - 1)
    flat = py * width + px
    return jnp.take(img.reshape(-1, img.shape[-1]), flat, axis=0).astype(jnp.float32)


def _get_reprojected_uv(prev_proj_view, p):
    """getReprojectedUV (wgsl:473-487): project through the previous
    view-projection; y flipped into texture space."""
    v = jnp.einsum(
        "ij,...j->...i", prev_proj_view,
        jnp.concatenate([p, jnp.ones_like(p[..., :1])], -1),
        precision=jax.lax.Precision.HIGHEST,
    )
    clip = v / v[..., 3:4]
    return jnp.stack(
        [clip[..., 0] * 0.5 + 0.5, -clip[..., 1] * 0.5 + 0.5], axis=-1
    )


def _estimate_likely_depth(
    packed_flat,
    sample_point,
    prev_depth_reproj,
    uv,
    camera_pos,
    prev_camera_pos,
    view_ray,
    *,
    grid_size: int,
    cell_size_mul,
):
    """estimateLikelyDepth (wgsl:743-798): if the reprojected previous depth
    lands in a live cell the current march overstepped, snap to that cell's
    exact intersection."""
    current_depth = jnp.linalg.norm(sample_point - camera_pos, axis=-1)
    view_ray2 = sample_point - prev_camera_pos
    view_ray2 = view_ray2 / jnp.linalg.norm(view_ray2, axis=-1, keepdims=True)
    reproj_point = prev_camera_pos + view_ray2 * prev_depth_reproj[..., None]
    r_coords, r_origin, r_idx = cell_from_sample_point(reproj_point, grid_size)
    c_coords, _, c_idx = cell_from_sample_point(sample_point, grid_size)
    r_state = get_cell_state(packed_flat, r_coords, grid_size)

    vis_half = jnp.float32(FULL_CUBE_SIZE / grid_size) * cell_size_mul * 0.5
    t_near, t_far = ray_cube_intersect(camera_pos, view_ray, r_origin, vis_half)
    cond = (
        (r_state == 1)
        & (c_idx != r_idx)
        & (prev_depth_reproj < current_depth)
        & (t_near <= t_far)
        & (t_near >= 0.0)
    )
    return jnp.where(cond, t_near, current_depth)


def _cell_age(age_planes, coords, grid_size: int):
    """Per-pixel age from packed age bit-planes [B, W, Z, Y]."""
    age = None
    for i in range(age_planes.shape[0]):
        bit = get_cell_state(age_planes[i].reshape(-1), coords, grid_size)
        term = bit << i
        age = term if age is None else (age | term)
    return age


def _lighting_and_occlusion(
    packed_flat, sample_point, uv, p: RenderParams, s: RenderStatic, active,
    ages=None, total_states: int = 2, variant: str = "clustered",
):
    """calculateLightingAndOcclusionAt (wgsl:379-427).

    ``ages`` (optional packed age planes) enables age-mapped coloring for
    multi-state (Generations) rules — an engine extension over the binary
    reference (BASELINE.json config 2; the reference's _totalStates hook is
    vestigial, main_pathtraced.js:133,431-439): dying cells fade linearly
    with age, factor (S - age)/(S - 1).
    """
    cell_size = jnp.float32(FULL_CUBE_SIZE / s.grid_size)
    coords, origin, _ = cell_from_sample_point(sample_point, s.grid_size)
    state = get_cell_state(packed_flat, coords, s.grid_size)
    vis_half = cell_size * p.cell_size * 0.5
    dist = sd_box(sample_point - origin, vis_half)
    lit = active & (state == 1) & (dist <= 0.001)

    rnd = n1rand(uv, p.elapsed_time)

    def shadow_toward(light_pos, rnd_offset):
        """One shadow march toward a (possibly jittered) light position
        (wgsl:403-421)."""
        light_dir = light_pos - sample_point
        light_dir = light_dir / jnp.linalg.norm(light_dir, axis=-1, keepdims=True)
        _, t_far = ray_cube_intersect(
            sample_point, light_dir, jnp.float32(0.0), jnp.float32(HALF_CUBE_SIZE)
        )
        volume_exit = sample_point + light_dir * t_far[..., None]
        return ray_march_shadow(
            packed_flat,
            sample_point,
            volume_exit,
            coords,
            rnd_offset,
            grid_size=s.grid_size,
            cell_size_mul=p.cell_size,
            shadow_samples=s.shadow_samples,
            active=lit,
            min_cell_step=variant == "clustered",
        )

    if s.soft_shadow_samples <= 1:
        occlusion = shadow_toward(p.light_pos, rnd)
    else:
        # Soft shadows (extension): average occlusion over jittered light
        # positions on a sphere of radius light_radius (0 → hard shadows).
        occlusion = jnp.zeros_like(rnd)
        for k in range(s.soft_shadow_samples):
            jx = n1rand(uv + jnp.float32(0.17 * k + 0.05), p.elapsed_time) - 0.5
            jy = n1rand(uv + jnp.float32(0.29 * k + 0.11), p.elapsed_time) - 0.5
            jz = n1rand(uv + jnp.float32(0.41 * k + 0.23), p.elapsed_time) - 0.5
            jitter = jnp.stack([jx, jy, jz], axis=-1) * (2.0 * p.light_radius)
            occlusion = occlusion + shadow_toward(p.light_pos + jitter, rnd)
        occlusion = occlusion / jnp.float32(s.soft_shadow_samples)
    camera_pos = p.view_mat[:3, 3]
    if variant == "clustered":
        color = brdf.calculate_lighting_at(
            sample_point,
            origin,
            coords,
            camera_pos,
            jnp.broadcast_to(p.light_magnitude, sample_point.shape),
            p.light_pos,
            grid_size=s.grid_size,
            roughness=p.roughness,
            material_color=p.material_color,
            base_reflectivity=p.base_reflectivity,
        )
    else:
        color = brdf.calculate_lighting_at_simple(
            sample_point,
            origin,
            coords,
            camera_pos,
            p.light_pos,
            p.light_magnitude,
            grid_size=s.grid_size,
        )
    if ages is not None and total_states > 2:
        age = _cell_age(ages, coords, s.grid_size)
        fade = (total_states - age).astype(jnp.float32) / jnp.float32(
            total_states - 1
        )
        fade = jnp.clip(fade, 0.0, 1.0)
        color = color * fade[..., None]
    out = occlusion[..., None] * color

    if s.indirect_lighting and variant == "clustered":
        out = out + _indirect_lighting(
            packed_flat, sample_point, origin, coords, uv, rnd, p, s, lit
        )

    # Emissive cells (extension): surfaces add their own radiance.
    out = out + p.emissive_color * p.emissive_strength
    return jnp.where(lit[..., None], out, 0.0)


# Neighbour-offset layers for indirect lighting, by face (wgsl:110-169):
# order: -x, +x, -y, +y, -z, +z.
_INDIRECT_LAYERS = np.array(
    [
        [[-1, 1, 0], [-1, -1, 0], [-1, 0, 1], [-1, 0, -1]],
        [[1, 1, 0], [1, -1, 0], [1, 0, 1], [1, 0, -1]],
        [[-1, -1, 0], [1, -1, 0], [0, -1, 1], [0, -1, -1]],
        [[-1, 1, 0], [1, 1, 0], [0, 1, 1], [0, 1, -1]],
        [[0, 1, -1], [0, -1, -1], [-1, 0, -1], [1, 0, -1]],
        [[0, 1, 1], [0, -1, 1], [-1, 0, 1], [1, 0, 1]],
    ],
    dtype=np.int32,
)


def _face_index(normal):
    """Face id from an axis-aligned normal: order -x,+x,-y,+y,-z,+z
    (matches the wgsl layer selection, wgsl:110-169)."""
    return jnp.where(
        jnp.abs(normal[..., 0]) > 0.5,
        jnp.where(normal[..., 0] < 0, 0, 1),
        jnp.where(
            jnp.abs(normal[..., 1]) > 0.5,
            jnp.where(normal[..., 1] < 0, 2, 3),
            jnp.where(normal[..., 2] < 0, 4, 5),
        ),
    )


def _indirect_lighting(packed_flat, sample_point, cell_origin, cell_coords,
                       uv, rnd, p: RenderParams, s: RenderStatic, lit):
    """Indirect lighting from the 4 face-adjacent neighbours
    (calculateIndirectLighting, wgsl:307-377 — implemented and enabled,
    where the reference leaves the call commented out at :424).

    ``s.indirect_bounces`` generalizes the reference's single bounce
    recursively: at depth b, each neighbour's reflected radiance includes
    its OWN indirect term evaluated at depth b-1, so light reaches the
    shaded point via up to ``indirect_bounces`` surface interactions
    (4^b neighbour evaluations — exact-path oracle; the fast path mirrors
    this decomposition with batched occlusion kernels)."""
    from .brdf import calculate_lighting_at

    grid = s.grid_size
    cell_size = jnp.float32(FULL_CUBE_SIZE / grid)
    vis_half = cell_size * p.cell_size * 0.5
    layers = jnp.asarray(_INDIRECT_LAYERS)  # [6, 4, 3]

    def indirect_from(point, origin, coords, viewer, active, depth_left):
        """Sum of bounce radiance reflected toward ``viewer`` at ``point``
        from the 4 neighbours of the face containing ``point``."""
        face = _face_index(cube_face_normal(point, origin))
        total = jnp.zeros_like(point)
        for i in range(4):
            off = jnp.take(layers[:, i, :], face, axis=0)  # [..., 3] i32
            n_coords = coords + off
            n_cl = jnp.maximum(n_coords, 0)
            n_state = get_cell_state(packed_flat, n_cl, grid)
            n_origin = (
                n_coords.astype(jnp.float32) * cell_size
                + cell_size * 0.5
                - HALF_CUBE_SIZE
            )
            n_dir = off.astype(jnp.float32)  # unnormalized, as in the reference
            t_near, t_far = ray_cube_intersect(point, n_dir, n_origin, vis_half)
            ok = active & (n_state == 1) & (t_near <= t_far) & (t_far >= 0.0)
            n_point = point + n_dir * t_near[..., None]

            l_dir = p.light_pos - n_point
            l_dir = l_dir / jnp.linalg.norm(l_dir, axis=-1, keepdims=True)
            _, exit_far = ray_cube_intersect(
                n_point, l_dir, jnp.float32(0.0), jnp.float32(HALF_CUBE_SIZE)
            )
            n_exit = n_point + l_dir * exit_far[..., None]
            occ = ray_march_shadow(
                packed_flat, n_point, n_exit, n_cl, rnd,
                grid_size=grid, cell_size_mul=p.cell_size,
                shadow_samples=s.shadow_samples, active=ok,
            )
            reflected = occ[..., None] * calculate_lighting_at(
                n_point, n_origin, n_cl, point,
                jnp.broadcast_to(p.light_magnitude, point.shape),
                p.light_pos,
                grid_size=grid, roughness=p.roughness,
                material_color=p.material_color,
                base_reflectivity=p.base_reflectivity,
            )
            # Emissive neighbours also bounce their own radiance (extension).
            reflected = reflected + p.emissive_color * p.emissive_strength
            if depth_left > 1:
                # Bounce N+1: the neighbour's incoming radiance gains its
                # own indirect term, viewed from the shaded point.
                reflected = reflected + indirect_from(
                    n_point, n_origin, n_cl, point, ok, depth_left - 1
                )
            bounce = calculate_lighting_at(
                point, origin, coords, viewer, reflected, n_point,
                grid_size=grid, roughness=p.roughness,
                material_color=p.material_color,
                base_reflectivity=p.base_reflectivity,
            )
            total = total + jnp.where(ok[..., None], bounce, 0.0)
        return total

    camera_pos = p.view_mat[:3, 3]
    return indirect_from(
        sample_point, cell_origin, cell_coords, camera_pos, lit,
        max(1, int(s.indirect_bounces)),
    )


def _mix_reprojected_color(
    packed_flat,
    current,          # [..., 4]
    prev,             # [..., 4]
    sample_pos,
    uv_reproj,
    prev_depth_reproj,
    prev_camera_pos,
    temporal_alpha,
    grid_size: int,
):
    """mixWithReprojectedColor (wgsl:429-471)."""
    d = sample_pos - prev_camera_pos
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    reproj_point = prev_camera_pos + d * prev_depth_reproj[..., None]
    _, _, r_idx = cell_from_sample_point(reproj_point, grid_size)
    _, _, c_idx = cell_from_sample_point(sample_pos, grid_size)

    outside = (
        (uv_reproj[..., 0] < 0.0)
        | (uv_reproj[..., 0] > 1.0)
        | (uv_reproj[..., 1] < 0.0)
        | (uv_reproj[..., 1] > 1.0)
    )
    reject = outside | (c_idx != r_idx)
    mixed = jnp.clip(prev + (current - prev) * temporal_alpha, 0.0, 1.0)
    return jnp.where(reject[..., None], current, mixed)


@functools.partial(jax.jit, static_argnums=(0, 5, 6), donate_argnums=3)
def render_frame(
    s: RenderStatic,
    packed: jnp.ndarray,
    params: RenderParams,
    history: RenderHistory,
    ages: jnp.ndarray | None = None,
    total_states: int = 2,
    variant: str = "clustered",
):
    """One frame (wgsl fragment_main :800-890).

    Returns (presentation [H, W, 3] f32, new RenderHistory).  The
    presentation image is gamma-corrected; ``history.color`` carries the
    linear light accumulation and ``history.depth`` the refined depth, each
    at f16 texture precision.
    """
    h, w = s.height, s.width
    window_size = jnp.array([w, h], dtype=jnp.float32)
    packed_flat = packed.reshape(-1)

    uv = pixel_uvs(w, h).reshape(-1, 2)  # [P, 2]
    camera_pos = params.view_mat[:3, 3]
    prev_camera_pos = params.prev_view_mat[:3, 3]

    ray_cam = get_ray(uv, window_size)
    view_ray = jnp.einsum(
        "ij,...j->...i", params.view_mat[:3, :3], ray_cam,
        precision=jax.lax.Precision.HIGHEST,
    )

    t_near, t_far = ray_cube_intersect(
        camera_pos, view_ray, jnp.float32(0.0), jnp.float32(HALF_CUBE_SIZE)
    )
    cube_hit = (t_near <= t_far) & (t_far >= 0.0)
    outside_box = sd_box(camera_pos, jnp.full((3,), HALF_CUBE_SIZE, jnp.float32)) >= 0.0

    enter = jnp.where(
        (cube_hit & outside_box)[..., None],
        camera_pos + view_ray * t_near[..., None],
        jnp.broadcast_to(camera_pos, view_ray.shape),
    )
    exit_ = camera_pos + view_ray * t_far[..., None]

    final_point, _ = ray_march_depth(
        packed_flat,
        enter,
        exit_,
        uv,
        params.elapsed_time,
        grid_size=s.grid_size,
        cell_size_mul=params.cell_size,
        depth_samples=s.depth_samples,
    )

    # History read at the reprojected position (:835-838).  (The reference
    # also loads prevDepth at the current pixel, :837, but only feeds it to
    # estimateLikelyDepth's commented-out branch — omitted.)
    uv_reproj = _get_reprojected_uv(params.prev_proj_view, final_point)
    prev_depth_reproj = _texture_load(history.depth, uv_reproj, w, h)[..., 0]

    likely_depth = _estimate_likely_depth(
        packed_flat,
        final_point,
        prev_depth_reproj,
        uv,
        camera_pos,
        prev_camera_pos,
        view_ray / jnp.linalg.norm(view_ray, axis=-1, keepdims=True),
        grid_size=s.grid_size,
        cell_size_mul=params.cell_size,
    )
    accurate_point = camera_pos + view_ray * likely_depth[..., None]
    uv_reproj = _get_reprojected_uv(params.prev_proj_view, accurate_point)

    # The non-clustered variant pins temporalAlpha to 0.1 and gamma to 2.2
    # (pathtraced_fragment.wgsl:372,704).
    if variant == "simple":
        params = params._replace(
            temporal_alpha=jnp.float32(0.1), gamma=jnp.float32(2.2)
        )
    lit_color = _lighting_and_occlusion(
        packed_flat, accurate_point, uv, params, s, cube_hit,
        ages=ages, total_states=total_states, variant=variant,
    )
    lit_rgba = jnp.concatenate([lit_color, jnp.ones_like(lit_color[..., :1])], -1)

    prev_color = _texture_load(history.color, uv_reproj, w, h)
    mixed = _mix_reprojected_color(
        packed_flat,
        lit_rgba,
        prev_color,
        accurate_point,
        uv_reproj,
        prev_depth_reproj,
        prev_camera_pos,
        params.temporal_alpha,
        s.grid_size,
    )

    out = jnp.where(cube_hit[..., None], mixed, jnp.zeros_like(mixed))
    mixed_depth = jnp.where(cube_hit, likely_depth, 0.0)

    # Light-source cube (:866-874): drawn where the background is black.
    lt_near, lt_far = ray_cube_intersect(
        camera_pos, view_ray, params.light_pos, jnp.float32(0.005)
    )
    light_hit = (lt_near <= lt_far) & (lt_far >= 0.0)
    black = jnp.all(out[..., :3] == 0.0, axis=-1)
    out = jnp.where((light_hit & black)[..., None], jnp.ones_like(out), out)

    # Depth overlay debug view (:880-883).
    overlay = (params.show_depth_overlay == 1.0) & (uv[..., 0] < 0.5)
    overlay_color = jnp.stack(
        [
            mixed_depth,
            jnp.zeros_like(mixed_depth),
            jnp.zeros_like(mixed_depth),
            jnp.ones_like(mixed_depth),
        ],
        axis=-1,
    )
    out = jnp.where(overlay[..., None], overlay_color, out)

    # MRT outputs (:885-888).
    light_out = jnp.concatenate([out[..., :3], jnp.ones_like(out[..., :1])], -1)
    depth_out = jnp.stack([mixed_depth, jnp.ones_like(mixed_depth)], axis=-1)
    presentation = jnp.power(out[..., :3], 1.0 / params.gamma)

    new_history = RenderHistory(
        color=light_out.reshape(h, w, 4).astype(jnp.float16),
        depth=depth_out.reshape(h, w, 2).astype(jnp.float16),
    )
    return presentation.reshape(h, w, 3), new_history
