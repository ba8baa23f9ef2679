"""Fused on-device loops: many CA generations (and sim+render ticks) inside
one jitted program — the north star's "zero host round-trips" loop replacing
the reference's per-frame command-buffer submission
(main_pathtraced.js:1833-1850)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..models.automaton import AutomatonSpec
from . import bitplane
from .ca_step import fires_plane, decay_update

__all__ = ["generation", "make_multi_step"]


def generation(spec: AutomatonSpec):
    """``state -> state`` advancing one generation (binary or multi-state
    bit-plane state), for use inside on-device loops."""
    if spec.total_states == 2:
        return lambda s: fires_plane(s, spec)
    nbits = spec.age_bits

    def step(s):
        planes = [s[i] for i in range(nbits)]
        alive = bitplane.eq_const(planes, 1, nbits)
        dead = bitplane.eq_const(planes, 0, nbits)
        fires = fires_plane(alive, spec)
        return jnp.stack(
            decay_update(planes, alive, dead, fires, spec.total_states)
        )

    return step


def make_multi_step(spec: AutomatonSpec, steps: int):
    """Jitted ``state → state`` advancing ``steps`` generations in one
    on-device ``fori_loop`` with buffer donation."""
    step = generation(spec)

    @functools.partial(jax.jit, donate_argnums=0)
    def run(state):
        return jax.lax.fori_loop(0, steps, lambda _, s: step(s), state)

    return run
