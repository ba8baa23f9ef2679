"""Bit-sliced (bitboard) arithmetic on uint32 word planes.

The replacement for the reference's per-cell bit loop
(compute_clustered.wgsl:213-245): instead of iterating 32 bits of each word
on one thread, every bitwise op on a ``uint32`` word plane processes 32
cells at once.

Key pieces:

* :func:`popcount_planes` — carry-save adder tree summing K one-bit planes
  into ⌈log2(K+1)⌉ bit-sliced count planes (the classic bitboard-Life
  technique, replacing the 26-load neighbour count of
  compute_clustered.wgsl:88-163).
* :func:`eq_const` / :func:`rule_hit` — bit-sliced comparison of count
  planes against a static rule mask (replacing the LUT gather of
  compute_clustered.wgsl:165-190 with pure vector logic).
* bit-sliced select/increment for multi-state (Generations) ages.

All functions are shape-polymorphic over the plane arrays and dtype-fixed to
``uint32``.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "popcount_planes",
    "eq_const",
    "rule_hit",
    "select_planes",
    "increment_planes",
    "planes_to_int",
    "int_to_planes",
]

_U32 = jnp.uint32
_ZERO = None  # lazily built per-shape


def _full_adder(a, b, c):
    """(sum, carry) of three one-bit planes: 5 ops."""
    axb = a ^ b
    return axb ^ c, (a & b) | (axb & c)


def _half_adder(a, b):
    return a ^ b, a & b


def popcount_planes(planes):
    """Sum K one-bit uint32 planes → list of count bit-planes, LSB first.

    Carry-save reduction: repeatedly combines triples at each bit weight
    with full adders until ≤1 plane per weight remains.  For K=26 this is
    ~60 vector ops total (vs 26 gathers/adds per *cell* in the reference).
    """
    if not planes:
        raise ValueError("need at least one plane")
    levels: list[list] = [list(planes)]
    out = []
    w = 0
    while w < len(levels):
        level = levels[w]
        while len(level) >= 3:
            a, b, c = level.pop(), level.pop(), level.pop()
            s, cy = _full_adder(a, b, c)
            level.append(s)
            if w + 1 >= len(levels):
                levels.append([])
            levels[w + 1].append(cy)
        if len(level) == 2:
            a, b = level.pop(), level.pop()
            s, cy = _half_adder(a, b)
            level.append(s)
            if w + 1 >= len(levels):
                levels.append([])
            levels[w + 1].append(cy)
        out.append(level[0] if level else None)
        w += 1
    # Replace any missing weights with zero planes.
    zero = jnp.zeros_like(planes[0])
    return [p if p is not None else zero for p in out]


def eq_const(count_planes, value: int, nbits: int | None = None):
    """Plane where the bit-sliced count equals the static ``value``."""
    nbits = len(count_planes) if nbits is None else nbits
    acc = None
    for i in range(nbits):
        p = count_planes[i]
        term = p if (value >> i) & 1 else ~p
        acc = term if acc is None else (acc & term)
    return acc


def rule_hit(count_planes, mask: int):
    """Plane where the count is a member of the static 27-bit rule ``mask``.

    Generated at trace time with one bit-sliced equality per member count —
    rules are restart-bound constants, so dead comparisons cost nothing.
    """
    if mask == 0:
        return jnp.zeros_like(count_planes[0])
    nbits = len(count_planes)
    if mask == (1 << (1 << nbits)) - 1:
        return ~jnp.zeros_like(count_planes[0])
    acc = None
    v = 0
    m = mask
    while m:
        if m & 1:
            e = eq_const(count_planes, v, nbits)
            acc = e if acc is None else (acc | e)
        m >>= 1
        v += 1
    return acc


def select_planes(mask_plane, a_planes, b_planes):
    """Per-bit select: mask ? a : b, over lists of planes (zero-padded)."""
    n = max(len(a_planes), len(b_planes))
    zero = jnp.zeros_like(mask_plane)
    out = []
    for i in range(n):
        a = a_planes[i] if i < len(a_planes) else zero
        b = b_planes[i] if i < len(b_planes) else zero
        out.append((mask_plane & a) | (~mask_plane & b))
    return out


def increment_planes(planes):
    """Bit-sliced +1 with ripple carry (no wrap plane returned)."""
    out = []
    carry = ~jnp.zeros_like(planes[0])  # +1 == carry-in of 1
    for p in planes:
        out.append(p ^ carry)
        carry = p & carry
    return out


def planes_to_int(planes, dtype=jnp.int32):
    """Bit-sliced planes → per-cell packed integers is NOT what this does;
    it combines count planes into a per-*bit-lane* impossible op.  Kept for
    testing: expands planes over an explicit bit axis.

    Returns an int array of shape ``(32,) + plane.shape`` where entry
    ``[b, ...]`` is the value encoded at bit ``b`` of each word.
    """
    shifts = jnp.arange(32, dtype=_U32)
    vals = None
    for i, p in enumerate(planes):
        bit = (p[None, ...] >> shifts.reshape((32,) + (1,) * planes[0].ndim)) & _U32(1)
        contrib = bit.astype(dtype) << i
        vals = contrib if vals is None else vals + contrib
    return vals


def int_to_planes(values, nbits: int):
    """Testing helper: int array over a leading 32-bit axis → packed planes."""
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=_U32)).reshape(
        (32,) + (1,) * (values.ndim - 1)
    )
    planes = []
    for i in range(nbits):
        bits = ((values >> i) & 1).astype(_U32)
        planes.append((bits * weights).sum(axis=0).astype(_U32))
    return planes
