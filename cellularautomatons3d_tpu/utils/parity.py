"""Scenes and parity metrics shared by ``chip_smoke.py`` and the GPU tests.

Parity is the traversal kernel against its plain ``jnp`` reference
(``RenderStatic.traversal``) on the same frame, at real widths.  Tolerances
(float32 throughout): at least 99.99% of pixels agree — same ``hit_idx``
and rgb within rtol 3e-3 / atol 3e-4 — since a cell-boundary tie of a
primary or shadow ray can flip when the compiled kernel contracts or
orders a sum differently from XLA; where ``hit_idx`` agrees, depth is
within 3e-5.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..models.automaton import AutomatonSpec
from ..ops.loop import make_multi_step
from ..ops.packing import pack_grid, seed_center
from ..render.renderer import RenderParams, RenderStatic
from ..render.renderer_fast import trace_shaded
from .config import EngineConfig
from . import mat4

__all__ = [
    "MATCH_MIN", "DEPTH_ATOL", "RGB_RTOL", "RGB_ATOL",
    "grown_scene", "sparse_noise", "frame_params", "compare_traversals",
    "frame_agreement", "within_tolerance",
]

MATCH_MIN = 0.9999
DEPTH_ATOL = 3e-5
RGB_RTOL = 3e-3
RGB_ATOL = 3e-4


def grown_scene(n: int, steps: int, total_states: int = 2):
    """The default rule (von Neumann B1,3/S0-6) grown ``steps`` generations
    from the reference's centre seed: packed state, bit-planes for
    multi-state rules."""
    spec = AutomatonSpec.from_config(
        EngineConfig(grid_size=n, total_states=total_states))
    dense = seed_center(n)
    if total_states == 2:
        state = jnp.asarray(pack_grid(dense))
    else:
        state = jnp.asarray(np.stack(
            [pack_grid((dense >> b) & 1) for b in range(spec.age_bits)]))
    return make_multi_step(spec, steps)(state)


def sparse_noise(n: int, and_words: int, seed: int = 0):
    """Packed cells set with probability 2^-and_words, made on the device."""
    keys = jax.random.split(jax.random.key(seed), and_words)
    shape = (n // 32, n, n)
    out = jax.random.bits(keys[0], shape, jnp.uint32)
    for k in keys[1:]:
        out = out & jax.random.bits(k, shape, jnp.uint32)
    return out


def frame_params(width: int, height: int, view=None, **overrides):
    """The benchmark frame's RenderParams: the reference's start camera and
    light (main_pathtraced.js:207-213)."""
    view = mat4.initial_view_matrix() if view is None else view
    proj = mat4.initial_projection_matrix(width, height)
    args = dict(
        view_mat=jnp.asarray(view),
        prev_view_mat=jnp.asarray(view),
        prev_proj_view=jnp.asarray(mat4.multiply(proj, mat4.inverse(view))),
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
    args.update({k: jnp.asarray(v, jnp.float32) for k, v in overrides.items()})
    return RenderParams(**args)


@functools.partial(jax.jit, static_argnums=(0, 4))
def _shaded(s, packed, params, ages, total_states):
    return trace_shaded(s, packed, params, ages, total_states)[:3]


def compare_traversals(s: RenderStatic, packed, params: RenderParams,
                       ages=None, total_states: int = 2) -> dict:
    """Kernel vs reference on one traced + shaded frame."""
    outs = [
        [np.asarray(a) for a in _shaded(
            dataclasses.replace(s, traversal=t), packed, params, ages,
            total_states)]
        for t in ("kernel", "reference")
    ]
    (rgb_k, d_k, i_k), (rgb_r, d_r, i_r) = outs
    return {"hits": int((i_r >= 0).sum()),
            **frame_agreement(rgb_k, rgb_r, i_k, i_r),
            "depth_max_err": float(
                np.abs(d_k - d_r)[i_k == i_r].max(initial=0.0)),
            "finite": bool(np.isfinite(rgb_k).all() and np.isfinite(d_k).all())}


def frame_agreement(rgb_k, rgb_r, i_k, i_r) -> dict:
    """Share of pixels with the same hit and rgb within tolerance, the
    share with the same hit, and the largest rgb error among those."""
    same = i_k == i_r
    err = np.abs(rgb_k - rgb_r)
    ok = (err <= RGB_ATOL + RGB_RTOL * np.abs(rgb_r)).all(axis=-1)
    return {
        "match": float((same & ok).mean()),
        "idx_match": float(same.mean()),
        "rgb_max_err": float(err[same].max(initial=0.0)),
    }


def within_tolerance(m: dict) -> bool:
    return (m["finite"] and m["match"] >= MATCH_MIN
            and m["depth_max_err"] <= DEPTH_ATOL)
