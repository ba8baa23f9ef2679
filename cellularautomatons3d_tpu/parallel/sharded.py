"""Multi-device scaling: z-axis domain decomposition with halo exchange.

The reference is strictly single-device (SURVEY.md §2.3); this layer is the
new capability mandated by BASELINE.json config 5 (512³ sharded across
chips).  Design (SURVEY.md §5 "long-context" analogue):

* the packed grid ``uint32[W, Z, Y]`` is sharded along **Z** over a 1-D
  ``jax.sharding.Mesh`` — the packed x axis is deliberately never sharded,
  dodging sub-word halo exchange (SURVEY.md §7 "hard parts");
* every step exchanges one z *word-plane* per face via ``lax.ppermute``
  inside ``shard_map`` (a 256·256·4-byte plane at 256³ — a few hundred
  KB, which XLA hands to NCCL on GPUs), then runs the same bit-sliced local update on the haloed
  slab and slices the interior;
* boundary modes act only at the global edges: WRAP keeps the natural ring;
  CLAMP zeroes both outer halos; CLAMP_REF zeroes only the low-z halo (the
  reference's one-sided wrap keeps the high edge ring: see
  compute_clustered.wgsl:104 and types.BoundaryMode);
* rendering replicates the (small, bit-packed) grid and shards pixels —
  an ``all_gather`` of ≤ 16 MiB at 512³.

All neighbourhood presets have |dz| ≤ 1, so a 1-plane halo is exact
(asserted).

**Multi-host scale (2-D decomposition).** A 1-D z split runs out of planes on
large meshes (> 64 devices at 512³ leaves < 8 planes per shard).  ``make_mesh``
with ``shape=(mz, my)`` builds a 2-D ``(z, y)`` mesh: the grid shards
along Z *and* Y (both cell-granular axes — x stays packed and whole),
and the step exchanges z word-planes first, then y word-columns *of the
z-padded slab*, so the 8 corner ribbons ride the second exchange —
the standard sequential halo schedule for Moore stencils.  Y halos are
``[W, lz+2, 1]`` columns (≤ 256 KiB at 1024³) exchanged along the
second mesh axis.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.automaton import AutomatonSpec
from ..ops.ca_step import fires_plane, decay_update
from ..ops import bitplane
from ..types import BoundaryMode

__all__ = [
    "make_mesh",
    "shard_state",
    "make_sharded_step",
    "halo_exchange_z",
    "halo_exchange_y",
]

AXIS = "z"
AXIS_Y = "y"


def make_mesh(n_devices: int | None = None, devices=None,
              shape: tuple[int, int] | None = None) -> Mesh:
    """1-D ``(z,)`` mesh over the first ``n_devices`` (all by default),
    or a 2-D ``(z, y)`` mesh when ``shape=(mz, my)`` is given."""
    if devices is None:
        devices = jax.devices()
    import numpy as np

    if shape is not None:
        mz, my = shape
        if len(devices) < mz * my:
            raise ValueError(
                f"mesh shape {shape} needs {mz * my} devices, "
                f"have {len(devices)}"
            )
        arr = np.array(devices[: mz * my], dtype=object).reshape(mz, my)
        return Mesh(arr, (AXIS, AXIS_Y))
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices, dtype=object).reshape(-1), (AXIS,))


def _is_2d(mesh: Mesh) -> bool:
    return AXIS_Y in mesh.axis_names


def state_sharding(mesh: Mesh, multistate: bool = False) -> NamedSharding:
    y = AXIS_Y if _is_2d(mesh) else None
    spec = P(None, None, AXIS, y) if multistate else P(None, AXIS, y)
    return NamedSharding(mesh, spec)


def shard_state(state, mesh: Mesh):
    """Place a packed state ([W,Z,Y] or [B,W,Z,Y]) sharded along Z."""
    return jax.device_put(state, state_sharding(mesh, state.ndim == 4))


def halo_exchange_z(local, boundary: str, axis: str = AXIS):
    """Return the local slab padded with one z word-plane per side.

    local: [W, local_z, Y] (inside shard_map).  Neighbour planes move via
    two ring ppermutes; global-edge halos are masked per boundary mode.
    """
    n = jax.lax.axis_size(axis)
    idx = jax.lax.axis_index(axis)

    first = local[:, :1, :]
    last = local[:, -1:, :]
    if n > 1:
        fwd = [(i, (i + 1) % n) for i in range(n)]   # my last → right's left halo
        bwd = [(i, (i - 1) % n) for i in range(n)]   # my first → left's right halo
        left_halo = jax.lax.ppermute(last, axis, fwd)
        right_halo = jax.lax.ppermute(first, axis, bwd)
    else:
        left_halo, right_halo = last, first  # self-ring

    zero = jnp.zeros_like(first)
    if boundary == BoundaryMode.WRAP:
        pass  # natural ring
    elif boundary == BoundaryMode.CLAMP:
        left_halo = jnp.where(idx == 0, zero, left_halo)
        right_halo = jnp.where(idx == n - 1, zero, right_halo)
    elif boundary == BoundaryMode.CLAMP_REF:
        # One-sided: low edge reads zero, high edge aliases global plane 0
        # (delivered by the ring).
        left_halo = jnp.where(idx == 0, zero, left_halo)
    else:
        raise ValueError(f"unknown boundary mode {boundary!r}")
    return jnp.concatenate([left_halo, local, right_halo], axis=1)


def halo_exchange_y(local, boundary: str, axis: str = AXIS_Y):
    """Return the local slab padded with one y word-column per side.

    local: [W, Zl, Yl] (inside shard_map; pass the z-PADDED slab so corner
    ribbons ride along).  Same boundary semantics as ``halo_exchange_z``:
    the reference's inclusive-bound quirk is one-sided per axis
    (compute_clustered.wgsl:104) — y = -1 reads dead, y = N wraps to 0.
    """
    n = jax.lax.axis_size(axis)
    idx = jax.lax.axis_index(axis)

    first = local[:, :, :1]
    last = local[:, :, -1:]
    if n > 1:
        fwd = [(i, (i + 1) % n) for i in range(n)]
        bwd = [(i, (i - 1) % n) for i in range(n)]
        low_halo = jax.lax.ppermute(last, axis, fwd)
        high_halo = jax.lax.ppermute(first, axis, bwd)
    else:
        low_halo, high_halo = last, first  # self-ring
    zero = jnp.zeros_like(first)
    if boundary == BoundaryMode.WRAP:
        pass
    elif boundary == BoundaryMode.CLAMP:
        low_halo = jnp.where(idx == 0, zero, low_halo)
        high_halo = jnp.where(idx == n - 1, zero, high_halo)
    elif boundary == BoundaryMode.CLAMP_REF:
        low_halo = jnp.where(idx == 0, zero, low_halo)
    else:
        raise ValueError(f"unknown boundary mode {boundary!r}")
    return jnp.concatenate([low_halo, local, high_halo], axis=2)


def _pad_local(local, spec: AutomatonSpec, two_d: bool):
    padded = halo_exchange_z(local, spec.boundary)
    if two_d:
        padded = halo_exchange_y(padded, spec.boundary)
    return padded


def _interior(arr, two_d: bool):
    return arr[:, 1:-1, 1:-1] if two_d else arr[:, 1:-1, :]


def _local_step_binary(local, spec: AutomatonSpec, two_d: bool = False):
    padded = _pad_local(local, spec, two_d)
    return _interior(fires_plane(padded, spec), two_d)


def _local_step_multistate(local_planes, spec: AutomatonSpec,
                           two_d: bool = False):
    nbits = spec.age_bits
    planes = [local_planes[i] for i in range(nbits)]
    alive = bitplane.eq_const(planes, 1, nbits)
    dead = bitplane.eq_const(planes, 0, nbits)
    # Only the alive plane crosses the boundary — counts need it; the age
    # update is pointwise.
    alive_padded = _pad_local(alive, spec, two_d)
    fires = _interior(fires_plane(alive_padded, spec), two_d)
    return jnp.stack(decay_update(planes, alive, dead, fires, spec.total_states))


def make_sharded_step(spec: AutomatonSpec, mesh: Mesh):
    """Jitted one-generation step over a Z- (1-D mesh) or Z×Y- (2-D
    ``(z, y)`` mesh) sharded packed state.

    Differential-equal to the single-device step (tested on a virtual CPU
    mesh, SURVEY.md §4 item 5).
    """
    max_dz = max(
        abs(off[2]) for offs, _, _ in spec.groups for off in offs
    )
    if max_dz > 1:
        raise NotImplementedError("halo width 1: neighbourhood |dz| must be ≤ 1")
    two_d = _is_2d(mesh)
    for ax in mesh.axis_names:
        if spec.grid_size % mesh.shape[ax] != 0:
            raise ValueError(
                f"grid_size {spec.grid_size} not divisible by mesh "
                f"axis {ax!r} size {mesh.shape[ax]}"
            )
    if two_d and (spec.grid_size // mesh.shape[AXIS_Y]) < 2:
        raise ValueError("y shards must hold ≥ 2 cell columns")

    multistate = spec.total_states > 2
    y = AXIS_Y if two_d else None
    pspec = P(None, None, AXIS, y) if multistate else P(None, AXIS, y)
    local_fn = _local_step_multistate if multistate else _local_step_binary

    shard_mapped = jax.shard_map(
        functools.partial(local_fn, spec=spec, two_d=two_d),
        mesh=mesh,
        in_specs=pspec,
        out_specs=pspec,
    )
    return jax.jit(shard_mapped)
