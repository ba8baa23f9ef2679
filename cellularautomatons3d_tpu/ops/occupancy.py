"""Coarse occupancy mip for empty-space skipping.

The reference's 32-cell "clusters" could skip empty words but never do
(SURVEY.md §5 last bullet — the march samples cell-by-cell,
pathtraced_fragment_clustered.wgsl:703-736).  Here we build the intended
acceleration structure: an 8× downsampled occupancy bitmap — one bit per
8³-cell block, packed 32 blocks per uint32 word along x.

Input:  packed ``uint32[W, Z, Y]`` (W = N/32).
Output: coarse ``uint32[Zc, XG·Yc]`` with Zc = Z/8, Yc = Y/8 and
XG = max(1, ⌈W/8⌉) x-block *groups* of 32 blocks each (the last group is
partial when W is not a multiple of 8, e.g. grids 288-480), laid out group-major
along the minor axis: bit ``xc & 31`` of ``coarse[zc, (xc >> 5)·Yc + yc]``
= any live cell in block (xc, yc, zc).  For N ≤ 256 (XG = 1) this is the
plain ``[Zc, Yc]`` bitmap.  At 1024³ the mip is 64 KiB (1/512 of the packed
volume); the traversal kernel reads it to skip empty 8-plane columns.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["coarse_occupancy", "BLOCK"]

BLOCK = 8  # downsample factor per axis

_U32 = jnp.uint32


def coarse_occupancy(packed: jnp.ndarray) -> jnp.ndarray:
    """8× occupancy mip; see module docstring."""
    w, z, y = packed.shape
    if z % BLOCK or y % BLOCK:
        raise ValueError(f"grid extents must be multiples of {BLOCK}")
    zc, yc = z // BLOCK, y // BLOCK

    # OR together the 8×8 (z, y) cells of each block, per word, then
    # compress each 8-word x-group to one bit per block (the final group
    # may be partial — grids 288-480; its unused high bits stay zero,
    # which downstream probes read as empty space).
    v = packed.reshape(w, zc, BLOCK, yc, BLOCK)
    v = jnp.bitwise_or.reduce(v, axis=4)
    v = jnp.bitwise_or.reduce(v, axis=2)  # [W, Zc, Yc] u32
    return _compress_x_groups(v)


def _compress_x_groups(v: jnp.ndarray) -> jnp.ndarray:
    """[W, R, Yc] per-word block occupancy → [R, XG·Yc] bit-packed rows
    (bit ``xb & 31`` of lane ``(xb >> 5)·Yc + yc``)."""
    w, r, yc = v.shape
    g = v
    for s in (1, 2, 4):  # after 1+2+4, bit i = OR of bits i..i+7
        g = g | (g >> _U32(s))
    g = g & _U32(0x01010101)
    nib = (
        (g & _U32(1))
        | ((g >> _U32(7)) & _U32(2))
        | ((g >> _U32(14)) & _U32(4))
        | ((g >> _U32(21)) & _U32(8))
    )
    xg = max(1, -(-w // BLOCK))
    groups = []
    for gi in range(xg):
        word = jnp.zeros((r, yc), dtype=_U32)
        for wi in range(min(BLOCK, w - gi * BLOCK)):
            word = word | (nib[gi * BLOCK + wi] << _U32(4 * wi))
        groups.append(word)
    return jnp.concatenate(groups, axis=1)  # [R, XG·Yc]
