"""Fast render pipeline: exact DDA traversal + XLA shading and composition.

Mirrors the exact pipeline's per-frame flow (renderer.py / wgsl
fragment_main :800-890) around the traversal in ``traverse.py``:
Cook-Torrance shading, soft shadows and GI (``lighting.py``), temporal EMA
accumulation, the light-source cube, the depth-overlay debug view, gamma
correction and f16 history.  Everything after the traversal is elementwise
work that XLA fuses.

Temporal accumulation: the traversal returns deterministic exact-DDA hits,
so for a static camera the reference's reprojection degenerates to the same
pixel; history is validated against the stored hit-cell id (the analogue of
mixWithReprojectedColor's cell check, wgsl:455-458).  When the camera moved
since the previous frame the caller passes ``camera_static=False`` and the
hit point is reprojected through the previous view-projection matrix
(getReprojectedUV, wgsl:473-487): history color is gathered at the
reprojected pixel and kept when the stored hit-cell id matches — so
accumulation survives interactive camera motion, as in the reference.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import brdf, lighting, traverse
from .camera import COT_HALF_FOV
from .intersect import ray_cube_intersect
from .renderer import RenderParams, RenderStatic, _get_reprojected_uv

__all__ = [
    "FastHistory",
    "init_fast_history",
    "pixel_rays",
    "trace_shaded",
    "render_frame_fast",
    "make_fused_loop",
]


class FastHistory(NamedTuple):
    color: jnp.ndarray    # [H, W, 3] float16 linear light
    hit_idx: jnp.ndarray  # [H, W] int32 cell id (-1 = miss)


def init_fast_history(width: int, height: int) -> FastHistory:
    return FastHistory(
        color=jnp.zeros((height, width, 3), dtype=jnp.float16),
        hit_idx=jnp.full((height, width), -1, dtype=jnp.int32),
    )


def pixel_rays(view_mat, width, height, full_height=None, row0=0.0):
    """Per-pixel (ux, uy) UVs and unit world directions (dx, dy, dz) of a
    ``height``-row band starting at global row ``row0`` of a
    ``full_height``-row window (get_ray, wgsl:188-197).

    The camera rotation is applied as explicit sums, not a matrix product:
    a float32 product may run in TF32 on the GPU, which moves directions by
    ~1e-3 and flips DDA hits at cell boundaries."""
    fh = height if full_height is None else full_height
    xs = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width
    ys = 1.0 - (jnp.arange(height, dtype=jnp.float32) + row0 + 0.5) / fh
    ux, uy = jnp.meshgrid(xs, ys)
    rx = (ux - 0.5) * (width / fh)
    ry = uy - 0.5
    rz = jnp.full_like(rx, -0.5 * COT_HALF_FOV)
    inv = jax.lax.rsqrt(rx * rx + ry * ry + rz * rz)
    rx, ry, rz = rx * inv, ry * inv, rz * inv
    r = view_mat[:3, :3]
    dirs = tuple(r[i, 0] * rx + r[i, 1] * ry + r[i, 2] * rz for i in range(3))
    return (ux, uy), dirs


def trace_shaded(s: RenderStatic, packed, params: RenderParams, ages=None,
                 total_states: int = 2, row0=0.0, full_height=None,
                 sample_idx=None):
    """Traced + shaded scene: (rgb [H,W,3] linear light, depth, hit_idx,
    view directions).

    The primary launch returns hits, the hard shadow and the age fade;
    soft shadows and GI add one occlusion launch (``lighting.py``).
    Emissive radiance is added to every hit, neither shadowed nor faded
    (renderer.py:284-285).  ``sample_idx``: traced frame counter of the
    temporally-amortized mode (RenderStatic.gi_temporal).
    """
    h, w, n = s.height, s.width, s.grid_size
    kernel = s.traversal == "kernel"
    soft = s.soft_shadow_samples > 1
    gi = s.indirect_lighting
    p = params
    o = p.view_mat[:3, 3]
    uv, dirs = pixel_rays(p.view_mat, w, h, full_height, row0)
    depth, idx, factor = traverse.trace_primary(
        packed, dirs, o, p.light_pos, p.cell_size, ages, grid_size=n,
        shadow=not soft, total_states=total_states, kernel=kernel,
    )
    q, porigin, coords, found = lighting.hit_geometry(o, dirs, idx, depth, n)
    rgb = brdf.calculate_lighting_at(
        q, porigin, coords, o, jnp.broadcast_to(p.light_magnitude, q.shape),
        p.light_pos, grid_size=n, roughness=p.roughness,
        material_color=p.material_color,
        base_reflectivity=p.base_reflectivity,
    ) * factor[..., None]
    if soft or gi:
        temporal = s.gi_temporal and sample_idx is not None
        # Deeper GI recursion runs its own launches per level; one bounce
        # rides the soft-shadow launch.
        deep = gi and not temporal and s.indirect_bounces > 1
        occl, gi_rgb = lighting.lighting_passes(
            packed, p, q, porigin, coords, found, uv, grid_size=n,
            soft_k=s.soft_shadow_samples if soft else None,
            jitter_k=(sample_idx % s.soft_shadow_samples).astype(jnp.int32)
            if soft and temporal else None,
            gi=gi and not deep,
            gi_slot=(sample_idx % 4).astype(jnp.int32)
            if gi and temporal else None,
            kernel=kernel,
        )
        if deep:
            gi_rgb = lighting.indirect_bounce(
                packed, p, q, porigin, coords, found, grid_size=n,
                bounces=s.indirect_bounces, kernel=kernel)
        if occl is not None:
            rgb = rgb * occl[..., None]
        if gi_rgb is not None:
            rgb = rgb + gi_rgb
    rgb = rgb + p.emissive_color * p.emissive_strength
    rgb = jnp.where(found[..., None], rgb, 0.0)
    return rgb, depth, idx, (uv, dirs)


@functools.partial(jax.jit, static_argnums=(0, 4, 6, 8))
def render_frame_fast(
    s: RenderStatic,
    packed: jnp.ndarray,
    params: RenderParams,
    history: FastHistory,
    camera_static: bool = True,
    ages: jnp.ndarray | None = None,
    total_states: int = 2,
    row0: jnp.ndarray | None = None,
    full_height: int | None = None,
    sample_idx: jnp.ndarray | None = None,
):
    """One fast-path frame.  Returns (presentation [H,W,3] f32, depth
    [H,W] f32, new FastHistory).

    ``sample_idx``: traced frame counter for the temporally-amortized
    lighting mode (RenderStatic.gi_temporal) — rotates the soft-shadow
    jitter and GI slot per frame; the EMA below converges to the full
    multi-sample lighting.

    ``row0``/``full_height``: set when this call renders a horizontal row
    shard of a larger window (mesh mode, engine._mesh_render) — pixel rows
    are local but UVs and the camera frustum are global.  Under camera
    motion, history is reprojected row-locally: pixels whose reprojected
    uv leaves this shard's row range are rejected (fresh color), so
    accumulation survives interactive motion without cross-shard gathers
    (the reprojected window is small for interactive speeds).
    """
    h, w = s.height, s.width
    fh = full_height if full_height is not None else h
    row0 = jnp.asarray(0.0 if row0 is None else row0, jnp.float32)
    rgb, depth, idx, ((ux, _), dirs) = trace_shaded(
        s, packed, params, ages, total_states, row0, fh, sample_idx,
    )
    view_ray = jnp.stack(dirs, axis=-1)
    camera_pos = params.view_mat[:3, 3]

    # Temporal EMA (wgsl:429-471): same-cell history blended with alpha.
    if camera_static:
        prev = history.color.astype(jnp.float32)
        valid = idx == history.hit_idx
    else:
        # Camera moved: reproject the hit point through the previous
        # view-projection (getReprojectedUV, wgsl:473-487) and gather
        # history at the reprojected pixel, validated by hit-cell id
        # (mixWithReprojectedColor, wgsl:429-471).
        hit_point = camera_pos + view_ray * depth[..., None]
        uv_r = _get_reprojected_uv(params.prev_proj_view, hit_point)
        in_bounds = (
            (uv_r[..., 0] >= 0.0) & (uv_r[..., 0] <= 1.0)
            & (uv_r[..., 1] >= 0.0) & (uv_r[..., 1] <= 1.0)
        )
        px = jnp.clip((uv_r[..., 0] * w).astype(jnp.int32), 0, w - 1)
        # Reprojected rows are global-window; this shard holds rows
        # [row0, row0 + h) — reject pixels reprojecting outside it.
        py_g = (uv_r[..., 1] * fh).astype(jnp.int32) - row0.astype(jnp.int32)
        in_bounds = in_bounds & (py_g >= 0) & (py_g < h)
        flat = (jnp.clip(py_g, 0, h - 1) * w + px).reshape(-1)
        prev = jnp.take(history.color.reshape(-1, 3), flat, axis=0)
        prev = prev.reshape(h, w, 3).astype(jnp.float32)
        prev_idx = jnp.take(history.hit_idx.reshape(-1), flat).reshape(h, w)
        valid = in_bounds & (prev_idx == idx)
    valid = valid & (idx >= 0)
    mixed = jnp.clip(prev + (rgb - prev) * params.temporal_alpha, 0.0, 1.0)
    out = jnp.where(valid[..., None], mixed, rgb)

    # Light-source cube (wgsl:866-874).
    lt_near, lt_far = ray_cube_intersect(
        camera_pos, view_ray, params.light_pos, jnp.float32(0.005)
    )
    light_hit = (lt_near <= lt_far) & (lt_far >= 0.0)
    black = jnp.all(out == 0.0, axis=-1)
    out = jnp.where((light_hit & black)[..., None], jnp.ones_like(out), out)

    # History snapshots the scene (incl. the light cube) but not the
    # debug overlay — a left-half depth view must not pollute accumulation.
    new_history = FastHistory(color=out.astype(jnp.float16), hit_idx=idx)

    # Depth overlay (wgsl:880-883), then gamma (wgsl:885-888).
    overlay = (params.show_depth_overlay == 1.0) & (ux < 0.5)
    overlay_rgb = jnp.stack(
        [depth, jnp.zeros_like(depth), jnp.zeros_like(depth)], axis=-1
    )
    out = jnp.where(overlay[..., None], overlay_rgb, out)

    presentation = jnp.power(out, 1.0 / params.gamma)
    return presentation, depth, new_history


def make_fused_loop(s: RenderStatic, spec, frames: int, steps_per_frame: int = 1,
                    reset_every: int = 0):
    """Jitted production loop: ``frames`` iterations of (CA steps + frame)
    entirely on device — the north star's zero-host-round-trip loop
    replacing the reference's per-frame submit (main_pathtraced.js:1833-1850).

    Returns ``run(state, params, history) -> (state, history, last_frame)``.
    Binary and multi-state automata supported; camera assumed static across
    the loop (interactive motion goes through Engine.render per frame).

    ``reset_every > 0`` restores the input state after every that many
    frames: a benchmarking aid that keeps a growth rule from densifying the
    scene while every frame still performs a full CA step + render.  The
    period is a traced operand (``run(..., reset_period)``), so loops that
    differ only in it share one compiled program.
    """
    from ..ops.loop import generation

    multistate = spec.total_states > 2
    one_step = generation(spec)

    def visibility(st):
        if not multistate:
            return st
        vis = st[0]
        for i in range(1, spec.age_bits):
            vis = vis | st[i]
        return vis

    @functools.partial(jax.jit, donate_argnums=(0, 2))
    def run_impl(state, params: RenderParams, history: FastHistory, rp):
        zero_frame = jnp.zeros((s.height, s.width, 3), jnp.float32)

        def body(i, carry):
            st, hist, _ = carry
            for _ in range(steps_per_frame):
                st = one_step(st)
            frame, _, hist = render_frame_fast(
                s, visibility(st), params, hist, True,
                st if multistate else None, spec.total_states,
                None, None,
                i.astype(jnp.int32) if s.gi_temporal else None,
            )
            st = jax.lax.cond(
                (rp > 0) & ((i + 1) % jnp.maximum(rp, 1) == 0),
                lambda: state,
                lambda: st,
            )
            return st, hist, frame

        return jax.lax.fori_loop(0, frames, body, (state, history, zero_frame))

    def run(state, params, history, reset_period=None):
        rp = reset_every if reset_period is None else reset_period
        return run_impl(state, params, history, jnp.int32(rp))

    return run
