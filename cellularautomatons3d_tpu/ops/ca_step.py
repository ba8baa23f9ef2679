"""Bit-packed CA step (XLA path): one generation on uint32 word planes.

The equivalent of the clustered compute shader
(compute_clustered.wgsl:192-265), redesigned rather than translated:

* the reference iterates the 32 bits of each word serially on a GPU thread
  and gathers up to 46 neighbour words *per cell*; here every neighbour
  offset becomes one *funnel-shifted word plane* and the neighbour count is
  a carry-save adder tree over those planes (`bitplane.popcount_planes`) —
  ~5 vector ops per 32 cells instead of ~46 loads per cell;
* rule LUT lookups (compute_clustered.wgsl:224-232) become bit-sliced
  equality tests against static rule masks (`bitplane.rule_hit`);
* the born/survive/mixed-group OR combine matches
  compute_clustered.wgsl:232 exactly.

State layout: ``uint32[W, Z, Y]`` (see `packing.py`); multi-state ages are a
stack ``uint32[B, W, Z, Y]`` of bit-sliced age planes.

This module IS the production step — the bit-sliced formulation lowers to
elementwise logic ops that XLA fuses into a handful of kernels, so no
hand-written CA kernel is needed; the dense oracle it is
differential-tested against is `ca_reference.py`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..models.automaton import AutomatonSpec
from ..types import BoundaryMode
from . import bitplane

__all__ = [
    "step_packed",
    "step_packed_multistate",
    "shift_packed",
    "make_step_fn",
    "fires_plane",
    "decay_update",
]

_U32 = jnp.uint32

# Packed axes: 0 = W (x words), 1 = Z, 2 = Y; offsets are (dx, dy, dz).


def _roll(a, shift, axis):
    return jnp.roll(a, shift, axis=axis)


def _axis_shift_plane(a, d: int, axis: int, boundary: str):
    """Word-granular shift along Z or Y: out[c] = a[c+d] under boundary."""
    if d == 0:
        return a
    rolled = _roll(a, -d, axis)
    if boundary == BoundaryMode.WRAP:
        return rolled
    wrap_hi = boundary == BoundaryMode.CLAMP_REF and d > 0
    if wrap_hi:
        # CLAMP_REF: far edge aliases index 0 (compute_clustered.wgsl:104 +
        # modulo wrap in getCellState) — same as a plain roll for d=+1.
        return rolled
    # Zero-fill the rows that wrapped in.
    n = a.shape[axis]
    idx = [slice(None)] * a.ndim
    if d > 0:
        idx[axis] = slice(n - d, n)
    else:
        idx[axis] = slice(0, -d)
    return rolled.at[tuple(idx)].set(_U32(0))


def _x_shift_plane(a, d: int, boundary: str):
    """Bit-granular shift along the packed x axis (funnel shift across
    words): out cell x reads cell x+d.  |d| must be ≤ 31."""
    if d == 0:
        return a
    ad = abs(d)
    if ad > 31:
        raise ValueError("x offsets beyond ±31 unsupported")
    if d > 0:
        # out_word[w] = (a[w] >> d) | (a[w+1] << (32-d))
        neigh = _roll(a, -1, 0)
        if boundary == BoundaryMode.CLAMP:
            neigh = neigh.at[-1].set(_U32(0))
        # WRAP and CLAMP_REF both wrap the far edge to word 0 (x = N reads
        # x = 0: compute_clustered.wgsl:56-66).
        return (a >> _U32(d)) | (neigh << _U32(32 - d))
    # d < 0: out_word[w] = (a[w] << |d|) | (a[w-1] >> (32-|d|))
    neigh = _roll(a, 1, 0)
    if boundary in (BoundaryMode.CLAMP, BoundaryMode.CLAMP_REF):
        neigh = neigh.at[0].set(_U32(0))
    return (a << _U32(ad)) | (neigh >> _U32(32 - ad))


def shift_packed(a, offset, boundary: str):
    """out[x, y, z] = a[x+dx, y+dy, z+dz] on a packed uint32[W, Z, Y] plane."""
    dx, dy, dz = offset
    out = _x_shift_plane(a, dx, boundary)
    out = _axis_shift_plane(out, dy, 2, boundary)
    out = _axis_shift_plane(out, dz, 1, boundary)
    return out


def _check_shape(plane, spec: AutomatonSpec):
    w, z, y = plane.shape[-3:]
    if (w * 32, z, y) != (spec.grid_size,) * 3:
        raise ValueError(
            f"packed state shape {plane.shape} does not match "
            f"grid_size={spec.grid_size} (expected [*, {spec.grid_size // 32}, "
            f"{spec.grid_size}, {spec.grid_size}])"
        )


def fires_plane(alive_plane, spec: AutomatonSpec):
    """OR over rule groups of the bit-sliced LUT evaluation
    (compute_clustered.wgsl:224-232): 1-bits where the cell is alive next
    generation (for binary CA) / where born-or-survive fired (multi-state)."""
    fires = None
    for offs, born_mask, survive_mask in spec.active_groups():
        shifted = [shift_packed(alive_plane, off, spec.boundary) for off in offs]
        counts = bitplane.popcount_planes(shifted)
        born_hit = bitplane.rule_hit(counts, born_mask)
        survive_hit = bitplane.rule_hit(counts, survive_mask)
        f = (alive_plane & survive_hit) | (~alive_plane & born_hit)
        fires = f if fires is None else (fires | f)
    if fires is None:
        fires = jnp.zeros_like(alive_plane)
    return fires


_fires_plane = fires_plane  # internal alias


def decay_update(planes, alive, dead, fires, total_states: int):
    """Pointwise Generations age update from the fires plane (bit-sliced).

    planes: list of age bit-planes; alive/dead: membership planes;
    fires: born-or-survive plane.  Returns the next age planes.
    """
    nbits = len(planes)
    one_planes = [~jnp.zeros_like(planes[0])] + [
        jnp.zeros_like(planes[0]) for _ in range(nbits - 1)
    ]
    zero_planes = [jnp.zeros_like(planes[0]) for _ in range(nbits)]
    if total_states == 2:
        return [fires]
    start_dying = [
        jnp.zeros_like(planes[0]),
        ~jnp.zeros_like(planes[0]),
    ] + [jnp.zeros_like(planes[0]) for _ in range(nbits - 2)]
    aged = bitplane.increment_planes(planes)
    is_last = bitplane.eq_const(planes, total_states - 1, nbits)
    aged = bitplane.select_planes(is_last, zero_planes, aged)
    from_alive = bitplane.select_planes(fires, one_planes, start_dying)
    from_dead = bitplane.select_planes(fires, one_planes, zero_planes)
    return bitplane.select_planes(
        dead, from_dead, bitplane.select_planes(alive, from_alive, aged)
    )


@functools.partial(jax.jit, static_argnums=1)
def step_packed(packed: jnp.ndarray, spec: AutomatonSpec) -> jnp.ndarray:
    """One generation, binary states, packed ``uint32[W, Z, Y]``.

    The ping-pong buffer discipline of the reference
    (main_pathtraced.js:1580-1609) is replaced by functional semantics
    (``new = step(old)``); fused multi-step loops donate buffers internally.
    """
    _check_shape(packed, spec)
    return _fires_plane(packed, spec)


@functools.partial(jax.jit, static_argnums=1)
def step_packed_multistate(age_planes: jnp.ndarray, spec: AutomatonSpec) -> jnp.ndarray:
    """One generation, Generations-style ages, ``uint32[B, W, Z, Y]``."""
    _check_shape(age_planes, spec)
    s = spec.total_states
    nbits = spec.age_bits
    planes = [age_planes[i] for i in range(nbits)]

    alive = bitplane.eq_const(planes, 1, nbits)
    dead = bitplane.eq_const(planes, 0, nbits)
    fires = fires_plane(alive, spec)
    return jnp.stack(decay_update(planes, alive, dead, fires, s))


def make_step_fn(spec: AutomatonSpec):
    """Step callable for this spec: packed plane in, packed plane out."""
    if spec.total_states == 2:
        return functools.partial(step_packed, spec=spec)
    return functools.partial(step_packed_multistate, spec=spec)
