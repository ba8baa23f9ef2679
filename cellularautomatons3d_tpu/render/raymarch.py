"""Ray-march loops: depth march and shadow march, vectorized over pixels.

The reference marches each pixel in a divergent per-thread ``while`` loop
(rayMarchDepth: pathtraced_fragment_clustered.wgsl:682-741, rayMarchShadow:
:635-680).  As vectorized array code over all pixels, the loops become
fixed-trip ``lax.fori_loop``s over the *step index* carrying per-pixel latch masks —
every lane runs every step but the first-hit result is latched (SURVEY.md §7
"hard parts").  Trip counts are the shader's sample counts: the reference's
``while depth < marchDepth`` with ``stepSize ≥ marchDepth/steps`` executes
at most ``steps`` iterations, which the mask reproduces exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .intersect import (
    FULL_CUBE_SIZE,
    HALF_CUBE_SIZE,
    ray_cube_intersect,
    get_cell_state,
    n1rand,
)

__all__ = ["ray_march_depth", "ray_march_shadow", "OCCLUSION_FACTOR"]

OCCLUSION_FACTOR = jnp.float32(0.0095)  # pathtraced_fragment_clustered.wgsl:72


def _normalize(v):
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


def ray_march_depth(
    packed_flat,
    start,
    end,
    uv,
    elapsed_time,
    *,
    grid_size: int,
    cell_size_mul,
    depth_samples: int,
):
    """First-hit march from ``start`` to ``end`` (wgsl:682-741).

    Returns (final_sample_point [..., 3], hit mask [...]).  On a hit the
    point is snapped to the exact visible-cube intersection (:717-729); with
    no hit it is ``end`` (:738), which is also the shader's
    ``farthestMarchPoint``.
    """
    direction = _normalize(end - start)
    march_depth = jnp.linalg.norm(end - start, axis=-1)
    step_size = march_depth / jnp.float32(depth_samples)
    rnd = n1rand(uv, elapsed_time)
    depth0 = step_size * rnd + jnp.float32(0.01)

    cell_size = jnp.float32(FULL_CUBE_SIZE / grid_size)
    vis_half = cell_size * cell_size_mul * 0.5

    def body(i, carry):
        found, hit_point = carry
        depth = depth0 + step_size * jnp.float32(i)
        in_range = depth < march_depth
        sample = start + direction * depth[..., None]
        coords_f = jnp.floor((sample + HALF_CUBE_SIZE) / cell_size)
        origin = coords_f * cell_size + cell_size * 0.5 - HALF_CUBE_SIZE
        coords = jnp.maximum(coords_f, 0.0).astype(jnp.int32)
        state = get_cell_state(packed_flat, coords, grid_size)
        t_near, t_far = ray_cube_intersect(start, direction, origin, vis_half)
        hit = in_range & ~found & (state != 0) & (t_far >= 0.0) & (t_near <= t_far)
        snapped = start + direction * t_near[..., None]
        hit_point = jnp.where(hit[..., None], snapped, hit_point)
        return found | hit, hit_point

    found0 = jnp.zeros(march_depth.shape, dtype=jnp.bool_)
    found, hit_point = jax.lax.fori_loop(
        0, depth_samples, body, (found0, jnp.zeros_like(start))
    )
    final = jnp.where(found[..., None], hit_point, end)
    return final, found


def ray_march_shadow(
    packed_flat,
    start,
    end,
    start_cell_coords,
    rnd_offset,
    *,
    grid_size: int,
    cell_size_mul,
    shadow_samples: int,
    active=None,
    min_cell_step: bool = True,
):
    """Occlusion march toward the light (wgsl:635-680).

    Returns the occlusion factor: 1.0 unoccluded, OCCLUSION_FACTOR when a
    *different* live cell's visible cube blocks the segment.  ``active``
    masks pixels that need the march at all (dead lanes still execute but
    cannot latch — the array analogue of the shader's early return).
    """
    direction = _normalize(end - start)
    march_depth = jnp.linalg.norm(end - start, axis=-1)
    cell_size = jnp.float32(FULL_CUBE_SIZE / grid_size)
    vis_half = cell_size * cell_size_mul * 0.5
    # stepSize = max(cell visible size, marchDepth/steps) — :644 (the .x
    # component; cell sizes are isotropic here as in the reference's cubic
    # grids).  The non-clustered variant uses the plain quotient
    # (pathtraced_fragment.wgsl:559).
    if min_cell_step:
        step_size = jnp.maximum(
            cell_size * cell_size_mul, march_depth / jnp.float32(shadow_samples)
        )
    else:
        step_size = march_depth / jnp.float32(shadow_samples)
    depth0 = step_size * rnd_offset + jnp.float32(0.0025)

    if active is None:
        active = jnp.ones(march_depth.shape, dtype=jnp.bool_)

    def body(i, occluded):
        depth = depth0 + step_size * jnp.float32(i)
        in_range = depth < march_depth
        sample = start + direction * depth[..., None]
        coords_f = jnp.floor((sample + HALF_CUBE_SIZE) / cell_size)
        origin = coords_f * cell_size + cell_size * 0.5 - HALF_CUBE_SIZE
        coords = jnp.maximum(coords_f, 0.0).astype(jnp.int32)
        state = get_cell_state(packed_flat, coords, grid_size)
        not_start = jnp.any(coords != start_cell_coords, axis=-1)
        t_near, t_far = ray_cube_intersect(start, direction, origin, vis_half)
        blocked = (
            active
            & in_range
            & not_start
            & (state == 1)
            & (t_near <= t_far)
            & (t_near >= 0.0)
        )
        return occluded | blocked

    occluded0 = jnp.zeros(march_depth.shape, dtype=jnp.bool_)
    occluded = jax.lax.fori_loop(0, shadow_samples, body, occluded0)
    return jnp.where(occluded, OCCLUSION_FACTOR, jnp.float32(1.0))
