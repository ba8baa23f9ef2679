"""Secondary lighting of the fast pipeline: soft shadows and indirect GI.

Plain XLA around the any-hit traversal (``traverse.occluded``): hit
geometry from the primary pass, the jittered area-light samples, the GI
neighbour slots, their cell states and shading.  Every occlusion query of
a frame — soft-shadow samples and GI slots — rides one traversal launch.

Semantics follow the exact renderer (``renderer._lighting_and_occlusion``
and ``renderer._indirect_lighting``, wgsl:307-427) with the stochastic
shadow march replaced by the exact DDA.  Arrays are image-shaped
``[H, W(, 3)]``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import brdf
from .intersect import (
    FULL_CUBE_SIZE,
    HALF_CUBE_SIZE,
    cube_face_normal,
    get_cell_state,
    ray_cube_intersect,
)
from .renderer import RenderParams, _INDIRECT_LAYERS, _face_index
from .traverse import OCCLUDED_FACTOR, occluded

__all__ = [
    "hit_geometry",
    "soft_shadow_jitter",
    "cell_state_batch",
    "indirect_bounce",
    "lighting_passes",
]


def hit_geometry(origin, dirs, idx, depth, grid_size):
    """(q, cell_origin, coords, found) of the primary hits: the hit point,
    the hit cell's center and integer coordinates, and the hit mask."""
    n = grid_size
    d = jnp.stack(dirs, axis=-1)
    q = origin + d * depth[..., None]
    found = idx >= 0
    coords = jnp.stack([idx % n, (idx // n) % n, idx // (n * n)], axis=-1)
    cell = jnp.float32(FULL_CUBE_SIZE / n)
    cell_origin = coords.astype(jnp.float32) * cell + cell * 0.5 - HALF_CUBE_SIZE
    return q, cell_origin, coords, found


def soft_shadow_jitter(p: RenderParams, kk, uv, nk=None):
    """Area-light offset of soft-shadow sample ``kk`` — the reference's
    sin-fract hash over global-window UVs (n1rand, wgsl:171-180;
    renderer.py:240-243).  ``uv`` = (ux, uy) pixel UV arrays.  ``kk`` may
    be a traced int32 in [0, nk) (temporal mode): the per-sample hash
    constants then come from a table rounded like the static constants,
    so each rotated sample is bit-identical to the static one."""
    ux, uy = uv
    tfrac = p.elapsed_time - jnp.floor(p.elapsed_time)

    def j1(cst):
        ax = 0.07 * tfrac + ux + cst
        ay = 0.07 * tfrac + uy + cst
        v = jnp.sin(ax * 12.9898 + ay * 78.233) * 43758.5453
        return (v - jnp.floor(v)) - 0.5

    if isinstance(kk, int):
        c1 = jnp.float32(0.17 * kk + 0.05)
        c2 = jnp.float32(0.29 * kk + 0.11)
        c3 = jnp.float32(0.41 * kk + 0.23)
    else:
        if nk is None:
            raise ValueError("traced sample index requires nk")
        ki = jnp.asarray(kk, jnp.int32)
        c1 = jnp.asarray([0.17 * k + 0.05 for k in range(nk)], jnp.float32)[ki]
        c2 = jnp.asarray([0.29 * k + 0.11 for k in range(nk)], jnp.float32)[ki]
        c3 = jnp.asarray([0.41 * k + 0.23 for k in range(nk)], jnp.float32)[ki]
    return jnp.stack([j1(c1), j1(c2), j1(c3)], axis=-1) * (2.0 * p.light_radius)


def cell_state_batch(vol, queries, grid_size):
    """Cell states for per-pixel coordinate queries: one int32 image per
    ``(coords [H, W, 3] int32, active [H, W])`` query, with the reference's
    clamp-then-wrap addressing (wgsl:268-304) and 0 on inactive pixels."""
    flat = vol.reshape(-1)
    return [
        jnp.where(active, get_cell_state(flat, jnp.maximum(coords, 0),
                                         grid_size), 0)
        for coords, active in queries
    ]


def _occlusion(vol, p: RenderParams, queries, grid_size, kernel):
    """One traversal launch for a list of (start, target, exclude, active)
    queries; returns the per-query light factor images."""
    stack = [jnp.stack(parts) for parts in zip(*queries)]
    occ = occluded(vol, *stack, p.cell_size, grid_size=grid_size,
                   kernel=kernel)
    return list(jnp.where(occ, jnp.float32(OCCLUDED_FACTOR), jnp.float32(1.0)))


def _shade(p: RenderParams, n, point, porigin, pcoords, viewer, radiance,
           light_point):
    return brdf.calculate_lighting_at(
        point, porigin, pcoords, viewer, radiance, light_point,
        grid_size=n, roughness=p.roughness, material_color=p.material_color,
        base_reflectivity=p.base_reflectivity,
    )


def _slot_geometry(p: RenderParams, n, q, porigin, pcoords, active, slot):
    """The GI neighbour slots of the face containing ``q``: per slot
    (clamped coords, cell origin, surface point, geometric ok).  ``slot``
    (traced int32) selects one of the 4 slots, else all 4."""
    cell = jnp.float32(FULL_CUBE_SIZE / n)
    vis_half = cell * p.cell_size * 0.5
    layers = jnp.asarray(_INDIRECT_LAYERS)  # [6, 4, 3]
    face = _face_index(cube_face_normal(q, porigin))

    def by_face(table):
        # A 6-way select fuses to elementwise work; a gather indexed by
        # every pixel does not.
        out = jnp.zeros(face.shape + (3,), table.dtype)
        for f in range(6):
            out = jnp.where((face == f)[..., None], table[f], out)
        return out

    if slot is None:
        offs = [by_face(layers[:, i, :]) for i in range(4)]
    else:
        offs = [by_face(jax.lax.dynamic_index_in_dim(layers, slot, axis=1,
                                                     keepdims=False))]
    slots = []
    for off in offs:
        n_coords = pcoords + off
        n_origin = n_coords.astype(jnp.float32) * cell + cell * 0.5 - HALF_CUBE_SIZE
        n_dir = off.astype(jnp.float32)  # unnormalized, as in the reference
        t_near, t_far = ray_cube_intersect(q, n_dir, n_origin, vis_half)
        ok = active & (t_near <= t_far) & (t_far >= 0.0)
        slots.append((jnp.maximum(n_coords, 0), n_origin,
                      q + n_dir * t_near[..., None], ok))
    return slots


def _gi_sum(p, n, q, porigin, pcoords, viewer, slots, states, occls, deeper,
            slot):
    """Sum of the slots' bounce radiance at ``q`` toward ``viewer``."""
    light = p.light_pos
    lmag3 = jnp.broadcast_to(p.light_magnitude, q.shape)
    emis = p.emissive_color * p.emissive_strength
    total = jnp.zeros_like(q)
    for (n_cl, n_origin, n_point, ok_geo), st, occ in zip(slots, states,
                                                           occls):
        ok = ok_geo & (st == 1)
        reflected = occ[..., None] * _shade(
            p, n, n_point, n_origin, n_cl, q, lmag3, light) + emis
        if deeper is not None:
            reflected = reflected + deeper(n_point, n_origin, n_cl, q, ok)
        bounce = _shade(p, n, q, porigin, pcoords, viewer, reflected, n_point)
        total = total + jnp.where(ok[..., None], bounce, 0.0)
    if slot is not None:
        total = total * jnp.float32(4.0)  # unbiased 1-of-4 estimator
    return total


def indirect_bounce(vol, p: RenderParams, q, porigin, coords, found, *,
                    grid_size, bounces=1, kernel=True):
    """Indirect GI [H, W, 3] with ``bounces`` levels of recursion
    (renderer._indirect_lighting): each level's 4 slot occlusion queries
    ride one launch; deeper levels add each neighbour's own indirect
    term (4^b queries)."""
    n = grid_size
    viewer0 = p.view_mat[:3, 3]

    def level(point, porigin_, pcoords, viewer, active, depth_left):
        slots = _slot_geometry(p, n, point, porigin_, pcoords, active, None)
        states = cell_state_batch(
            vol, [(cl, ok) for cl, _, _, ok in slots], n)
        occls = _occlusion(
            vol, p,
            [(pt, jnp.broadcast_to(p.light_pos, pt.shape), cl, ok)
             for cl, _, pt, ok in slots],
            n, kernel,
        )
        deeper = None
        if depth_left > 1:
            def deeper(n_point, n_origin, n_cl, viewer_, ok):
                return level(n_point, n_origin, n_cl, viewer_, ok,
                             depth_left - 1)
        return _gi_sum(p, n, point, porigin_, pcoords, viewer, slots, states,
                       occls, deeper, None)

    return level(q, porigin, coords, viewer0, found, max(1, int(bounces)))


def lighting_passes(vol, p: RenderParams, q, porigin, coords, found, uv, *,
                    grid_size, soft_k=None, jitter_k=None, gi=False,
                    gi_slot=None, kernel=True):
    """Soft shadows plus one-bounce GI with every occlusion query of the
    frame in ONE launch.  The GI slots' occlusion queries depend only on
    hit geometry, not on the neighbour's state (which only gates whether a
    slot contributes), so they ride along with the shadow samples.

    ``soft_k``: soft-shadow sample count (None = no direct queries).
    ``jitter_k``/``gi_slot``: traced int32 indices of the temporal mode —
    one rotating shadow sample and GI slot per frame, which the temporal
    EMA averages to the full result.  Returns
    ``(occl [H, W] or None, gi_rgb [H, W, 3] or None)``.
    """
    n = grid_size
    light = p.light_pos
    queries = []
    if soft_k is not None:
        if jitter_k is not None:
            ks = [jitter_k]
        else:
            ks = list(range(soft_k))
        for kk in ks:
            target = light + soft_shadow_jitter(p, kk, uv, nk=soft_k)
            queries.append((q, target, coords, found))
    n_soft = len(queries)
    slots = []
    if gi:
        slots = _slot_geometry(p, n, q, porigin, coords, found, gi_slot)
        queries += [(pt, jnp.broadcast_to(light, pt.shape), cl, ok)
                    for cl, _, pt, ok in slots]
    if not queries:
        return None, None
    occs = _occlusion(vol, p, queries, n, kernel)
    occl = sum(occs[:n_soft]) / jnp.float32(n_soft) if n_soft else None
    gi_rgb = None
    if gi:
        states = cell_state_batch(vol, [(cl, ok) for cl, _, _, ok in slots], n)
        gi_rgb = _gi_sum(p, n, q, porigin, coords, p.view_mat[:3, 3], slots,
                         states, occs[n_soft:], None, gi_slot)
    return occl, gi_rgb
