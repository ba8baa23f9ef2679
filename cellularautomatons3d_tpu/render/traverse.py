"""Exact z-plane DDA over the bit-packed volume, for batches of rays.

One traversal serves every ray kind of the fast pipeline:

* **first hit** (primary rays): returns ``(depth, hit_idx)``; the same
  launch runs the hard-shadow sweep toward the light for hit lanes and
  looks up the hit cell's age for the multi-state fade;
* **any hit** (occlusion queries ``(start, target, exclude, active)``):
  returns ``occluded``.  Soft-shadow samples and GI slot queries of one
  frame ride one launch (``render/lighting.py``).

Semantics, shared by both implementations below: a ray visits the z planes
its ``[t0, t1]`` segment crosses, in the direction of ``dz`` (rays with
``dz == 0`` never hit).  On each plane it probes the one cell under the
midpoint of the plane's segment, tests the visible cube (``cell_mul`` of
the cell) against the ray — primary rays accept ``tn <= tf, tf >= t0``,
occlusion rays ``tn <= tf, tn >= 0`` (wgsl:669,722-724) — and skips one
excluded cell (the shadow start cell, wgsl:665-674).  This replaces the
reference's stochastic march (pathtraced_fragment_clustered.wgsl:682-741)
with a deterministic one; ``renderer.py`` keeps the stochastic original.

Two implementations:

* ``_march_skip`` in a Pallas kernel on the Triton route.  One program
  marches a ``TILE_H x TILE_W`` screen tile, one lane per ray, in a
  ``while_loop`` that ends when every ray of the tile has finished.  Empty
  space is skipped one 8-plane column at a time on the 8x coarse mip
  (``ops/occupancy.py``); only columns whose mip blocks are occupied are
  probed plane by plane.  The skip is exact: it reads every mip block the
  column's probe cells can fall in.
* ``_march_reference``: plain ``jnp``/``lax``, a ``fori_loop`` over all n
  planes with one gather per ray per plane.  It is the parity reference of
  the kernel and the plain version the kernel is timed against.

The volume is the packed ``uint32[W, Z, Y]`` of ``ops/packing.py``, read
from device memory by gathers (a 1024^3 volume is 128 MiB).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..ops.occupancy import BLOCK, coarse_occupancy

__all__ = [
    "select_backend",
    "trace_primary",
    "occluded",
    "OCCLUDED_FACTOR",
    "TILE_H",
    "TILE_W",
]

# Light reaching an occluded point (raymarch.OCCLUSION_FACTOR, wgsl:676).
OCCLUDED_FACTOR = 0.0095

# One Pallas program marches one TILE_H x TILE_W screen tile: rays of a
# small square tile stay coherent, so the tile's loop ends soon after its
# slowest ray.  Triton wants power-of-two blocks.
TILE_H = 16
TILE_W = 16
NUM_WARPS = 4

_F32 = jnp.float32
_I32 = jnp.int32
_U32 = jnp.uint32
_HALF = 0.5
_FULL_MASK = 0xFFFFFFFF


def select_backend(platform: str | None = None) -> str:
    """How the traversal kernel runs on ``platform`` (default: JAX's).

    ``"gpu"`` compiles the Triton kernel; ``"cpu"`` runs it in Pallas
    interpret mode, the test and rehearsal platform.  Anything else is an
    error: there is no silent step down to interpret mode.
    """
    platform = platform or jax.default_backend()
    if platform in ("gpu", "cuda"):
        return "gpu"
    if platform == "cpu":
        return "cpu"
    raise RuntimeError(
        f"the traversal kernel runs on a CUDA GPU (compiled) or the CPU "
        f"(interpret mode); no implementation for platform {platform!r}"
    )


# ----------------------------------------------------------------- geometry


def _box_range(ox, oy, oz, dx, dy, dz):
    """(t_near, t_far) of the ray against the volume box [-0.5, 0.5]^3."""
    ix, iy, iz = 1.0 / dx, 1.0 / dy, 1.0 / dz
    ax, bx = (-_HALF - ox) * ix, (_HALF - ox) * ix
    ay, by = (-_HALF - oy) * iy, (_HALF - oy) * iy
    az, bz = (-_HALF - oz) * iz, (_HALF - oz) * iz
    tn = jnp.maximum(
        jnp.maximum(jnp.minimum(ax, bx), jnp.minimum(ay, by)),
        jnp.minimum(az, bz),
    )
    tf = jnp.minimum(
        jnp.minimum(jnp.maximum(ax, bx), jnp.maximum(ay, by)),
        jnp.maximum(az, bz),
    )
    return tn, tf


def shadow_ray(sx, sy, sz, tx, ty, tz):
    """Unit direction from s toward t and the t where it leaves the box."""
    lx, ly, lz = tx - sx, ty - sy, tz - sz
    inv = jax.lax.rsqrt(lx * lx + ly * ly + lz * lz)
    dx, dy, dz = lx * inv, ly * inv, lz * inv
    _, t1 = _box_range(sx, sy, sz, dx, dy, dz)
    return dx, dy, dz, t1


def _plane_range(kf, oz, inv_dz, n):
    """(entry, exit) t of the ray in the slab of z plane(s) ``kf`` ..
    ``kf + 1`` (cell units)."""
    inv_n = 1.0 / n
    ta = (kf * inv_n - _HALF - oz) * inv_dz
    tb = ((kf + 1.0) * inv_n - _HALF - oz) * inv_dz
    return jnp.minimum(ta, tb), jnp.maximum(ta, tb)


def _cell_coord(o, t, d, n):
    return (o + t * d + _HALF) * n


def _probe(k, ray, fetch, n, cell_half, any_hit, mask):
    """Probe plane ``k`` of every ray: (hit, tn, cx, cy).

    ``fetch(flat_word_index, mask)`` reads packed words; masked-off lanes
    never read.  ``k`` is a per-ray int32 plane index.
    """
    ox, oy, oz, dx, dy, dz, t0, t1, ex, ey, ez = ray
    inv_n = 1.0 / n
    kf = k.astype(_F32)
    entry, exit_ = _plane_range(kf, oz, 1.0 / dz, n)
    lo = jnp.maximum(entry, t0)
    hi = jnp.minimum(exit_, t1)
    seg = mask & (lo < hi)
    tm = 0.5 * (lo + hi)
    cx = jnp.clip(jnp.floor(_cell_coord(ox, tm, dx, n)), 0, n - 1).astype(_I32)
    cy = jnp.clip(jnp.floor(_cell_coord(oy, tm, dy, n)), 0, n - 1).astype(_I32)
    word = fetch(((cx >> 5) * n + k) * n + cy, seg)
    bit = (word >> (cx & 31).astype(_U32)) & _U32(1)
    cand = seg & (bit == 1) & ~((cx == ex) & (cy == ey) & (k == ez))
    # Visible-cube intersection (wgsl:712-729).
    ccx = (cx.astype(_F32) + 0.5) * inv_n - _HALF
    ccy = (cy.astype(_F32) + 0.5) * inv_n - _HALF
    ccz = (kf + 0.5) * inv_n - _HALF
    ix, iy, iz = 1.0 / dx, 1.0 / dy, 1.0 / dz
    ax, bx = (ccx - cell_half - ox) * ix, (ccx + cell_half - ox) * ix
    ay, by = (ccy - cell_half - oy) * iy, (ccy + cell_half - oy) * iy
    az, bz = (ccz - cell_half - oz) * iz, (ccz + cell_half - oz) * iz
    tn = jnp.maximum(
        jnp.maximum(jnp.minimum(ax, bx), jnp.minimum(ay, by)),
        jnp.minimum(az, bz),
    )
    tf = jnp.minimum(
        jnp.minimum(jnp.maximum(ax, bx), jnp.maximum(ay, by)),
        jnp.maximum(az, bz),
    )
    ok = (tn <= tf) & ((tn >= 0.0) if any_hit else (tf >= t0))
    return cand & ok, tn, cx, cy


# --------------------------------------------------------- plain reference


def _march_reference(vol_flat, ray, active, *, n, cell_half, any_hit):
    """Visit all n planes of every ray in its direction; latch the first
    hit.  Returns (found, t_hit, hx, hy, hz)."""
    dz = ray[5]
    pos = dz > 0
    active = active & (pos | (dz < 0))

    def fetch(idx, mask):
        return jnp.where(mask, vol_flat[jnp.where(mask, idx, 0)], _U32(0))

    def body(i, carry):
        found, t_hit, hx, hy, hz = carry
        k = jnp.where(pos, i, n - 1 - i)
        hit, tn, cx, cy = _probe(
            k, ray, fetch, n, cell_half, any_hit, active & ~found
        )
        return (
            found | hit,
            jnp.where(hit, tn, t_hit),
            jnp.where(hit, cx, hx),
            jnp.where(hit, cy, hy),
            jnp.where(hit, k, hz),
        )

    z = jnp.zeros(dz.shape, _I32)
    init = (jnp.zeros(dz.shape, bool), jnp.zeros(dz.shape, _F32), z, z, z)
    return jax.lax.fori_loop(0, n, body, init)


# ------------------------------------------------------------ Pallas kernel


def _column_occupied(c, lo, hi, ray, fetch_coarse, n, mask):
    """Whether any mip block the column-``c`` probes of these rays can read
    is occupied.  Probe cells lie between the cells under the segment's
    end points ``lo``/``hi`` (the same rounded formula, monotone in t); a
    1/64-cell margin absorbs contraction differences.  Rays whose block
    box spans more than three y blocks or two 32-block x words descend
    without a test."""
    ox, oy = ray[0], ray[1]
    dx, dy = ray[3], ray[4]
    nb = n // BLOCK
    yc = nb
    row = max(1, -(-nb // 32)) * yc          # words per coarse z row
    eps = 1.0 / 64.0

    def blocks(o, d):
        a = _cell_coord(o, lo, d, n)
        b = _cell_coord(o, hi, d, n)
        lo_c = jnp.clip(jnp.floor(jnp.minimum(a, b) - eps), 0, n - 1)
        hi_c = jnp.clip(jnp.floor(jnp.maximum(a, b) + eps), 0, n - 1)
        return lo_c.astype(_I32) >> 3, hi_c.astype(_I32) >> 3

    bx0, bx1 = blocks(ox, dx)
    by0, by1 = blocks(oy, dy)
    g0, g1 = bx0 >> 5, bx1 >> 5
    testable = mask & (by1 - by0 <= 2) & (g1 - g0 <= 1)
    full = _U32(_FULL_MASK)
    m_lo = full << (bx0 & 31).astype(_U32)
    m_hi = full >> (31 - (bx1 & 31)).astype(_U32)
    same = g0 == g1
    mask0 = jnp.where(same, m_lo & m_hi, m_lo)
    mask1 = jnp.where(same, _U32(0), m_hi)
    occ = mask & ~testable
    for j in range(3):
        by = by0 + j
        valid = testable & (by <= by1)
        base = c * row + by
        w0 = fetch_coarse(base + g0 * yc, valid)
        w1 = fetch_coarse(base + g1 * yc, valid & ~same)
        occ = occ | (((w0 & mask0) | (w1 & mask1)) != 0)
    return occ


def _march_skip(fetch, fetch_coarse, ray, active, *, n, cell_half, any_hit):
    """The reference march with empty-space skipping: the same probes on
    every plane of every occupied column, none elsewhere.  Returns
    (found, t_hit, hx, hy, hz)."""
    ox, oy, oz, dx, dy, dz, t0, t1 = ray[:8]
    pos = dz > 0
    alive = active & (pos | (dz < 0))
    step = jnp.where(pos, 1, -1).astype(_I32)
    inv_dz = 1.0 / dz
    # Start one plane before the plane holding the segment's entry point:
    # an extra plane only costs an empty probe, a missed one a wrong hit.
    zs = jnp.where(alive, (oz + t0 * dz + _HALF) * n, 0.0)
    k = jnp.clip(jnp.floor(jnp.clip(zs, -1.0, n + 1.0)).astype(_I32) - step,
                 0, n - 1)
    shape = dz.shape
    zi = jnp.zeros(shape, _I32)
    init = (k, jnp.zeros(shape, bool), alive, jnp.zeros(shape, bool),
            jnp.zeros(shape, _F32), zi, zi, zi)

    def cond(carry):
        return jnp.max(carry[2].astype(_I32)) > 0

    def body(carry):
        k, fine, alive, found, t_hit, hx, hy, hz = carry
        # Column test for rays between columns.
        c8 = (k >> 3) << 3
        need = alive & ~fine
        # Column bounds with the plane formula's floats (c8 and c8 + 8 are
        # its first plane's entry and last plane's exit boundaries).
        c8f = c8.astype(_F32)
        ca = (c8f * (1.0 / n) - _HALF - oz) * inv_dz
        cb = ((c8f + 8.0) * (1.0 / n) - _HALF - oz) * inv_dz
        centry, cexit = jnp.minimum(ca, cb), jnp.maximum(ca, cb)
        clo = jnp.maximum(centry, t0)
        chi = jnp.minimum(cexit, t1)
        cseg = need & (clo < chi)
        occ = _column_occupied(k >> 3, clo, chi, ray, fetch_coarse, n, cseg)
        descend = cseg & occ
        skip = need & ~descend
        fine = fine | descend
        k = jnp.where(skip, jnp.where(pos, c8 + BLOCK, c8 - 1), k)
        # Plane probe for rays inside an occupied column.
        probe = alive & fine
        hit, tn, cx, cy = _probe(k, ray, fetch, n, cell_half, any_hit, probe)
        found = found | hit
        t_hit = jnp.where(hit, tn, t_hit)
        hx = jnp.where(hit, cx, hx)
        hy = jnp.where(hit, cy, hy)
        hz = jnp.where(hit, k, hz)
        k = jnp.where(probe, k + step, k)
        fine = fine & (((k >> 3) << 3) == c8)
        # A ray ends at a hit, past the volume, or where the next plane
        # starts beyond t1 (plane entries grow along the ray).
        entry, _ = _plane_range(k.astype(_F32), oz, inv_dz, n)
        alive = alive & ~hit & (k >= 0) & (k < n) & (entry < t1)
        return k, fine, alive, found, t_hit, hx, hy, hz

    out = jax.lax.while_loop(cond, body, init)
    return out[3:]


def _masked_fetch(ref):
    def fetch(idx, mask):
        return plgpu.load(ref.at[jnp.where(mask, idx, 0)], mask=mask, other=0)

    return fetch


def _no_exclusion(shape):
    neg = jnp.full(shape, -1, _I32)
    return neg, neg, neg


def _primary_body(params, vol_fetch, coarse_fetch, dx, dy, dz, onscreen, *,
                  n, shadow, march):
    """Shared body of the primary launch: first hit, hard shadow, outputs
    (depth, idx, found, hx, hy, hz, light factor)."""
    ox, oy, oz, lx, ly, lz, cell_half = params
    shape = dz.shape
    oxv = jnp.full(shape, ox, _F32)
    oyv = jnp.full(shape, oy, _F32)
    ozv = jnp.full(shape, oz, _F32)
    tn, tf = _box_range(oxv, oyv, ozv, dx, dy, dz)
    active = onscreen & (tn <= tf) & (tf >= 0.0)
    t0 = jnp.maximum(tn, 0.0)
    ray = (oxv, oyv, ozv, dx, dy, dz, t0, tf) + _no_exclusion(shape)
    found, t_hit, hx, hy, hz = march(
        vol_fetch, coarse_fetch, ray, active, n=n, cell_half=cell_half,
        any_hit=False,
    )
    depth = jnp.where(found, t_hit, jnp.where(active, tf, 0.0))
    idx = jnp.where(found, hx + hy * n + hz * (n * n), -1)
    factor = jnp.ones(shape, _F32)
    if shadow:
        qx, qy, qz = oxv + t_hit * dx, oyv + t_hit * dy, ozv + t_hit * dz
        sdx, sdy, sdz, st1 = shadow_ray(
            qx, qy, qz, jnp.full(shape, lx, _F32), jnp.full(shape, ly, _F32),
            jnp.full(shape, lz, _F32),
        )
        sray = (qx, qy, qz, sdx, sdy, sdz, jnp.zeros(shape, _F32), st1,
                hx, hy, hz)
        occ = march(vol_fetch, coarse_fetch, sray, found, n=n,
                    cell_half=cell_half, any_hit=True)[0]
        factor = jnp.where(occ, OCCLUDED_FACTOR, 1.0).astype(_F32)
    return depth, idx, found, hx, hy, hz, factor


def _age_fade(age_fetch, found, hx, hy, hz, n, age_bits, total_states):
    """Linear fade of dying cells, (S - age)/(S - 1) (renderer.py:270-276)."""
    word = ((hx >> 5) * n + hz) * n + hy
    shift = (hx & 31).astype(_U32)
    plane = (n // 32) * n * n
    age = jnp.zeros(found.shape, _I32)
    for b in range(age_bits):
        w = age_fetch(word + b * plane, found)
        age = age | (((w >> shift) & _U32(1)).astype(_I32) << b)
    age = jnp.where(found, age, 1)
    return jnp.clip(
        (total_states - age).astype(_F32) / float(total_states - 1), 0.0, 1.0
    )


def _primary_kernel(n, shadow, height, width, age_bits, total_states):
    def kernel(p_ref, vol_ref, coarse_ref, *rest):
        age_ref = rest[0] if age_bits else None
        dx_ref, dy_ref, dz_ref, depth_ref, idx_ref, fac_ref = rest[-6:]
        params = [p_ref[i] for i in range(7)]
        py = pl.program_id(0) * TILE_H + jax.lax.broadcasted_iota(
            _I32, (TILE_H, TILE_W), 0)
        px = pl.program_id(1) * TILE_W + jax.lax.broadcasted_iota(
            _I32, (TILE_H, TILE_W), 1)
        onscreen = (py < height) & (px < width)
        depth, idx, found, hx, hy, hz, factor = _primary_body(
            params, _masked_fetch(vol_ref), _masked_fetch(coarse_ref),
            dx_ref[...], dy_ref[...], dz_ref[...], onscreen,
            n=n, shadow=shadow, march=_march_skip,
        )
        if age_bits:
            factor = factor * _age_fade(
                _masked_fetch(age_ref), found, hx, hy, hz, n, age_bits,
                total_states,
            )
        depth_ref[...] = depth
        idx_ref[...] = idx
        fac_ref[...] = factor

    return kernel


def _occlusion_kernel(n):
    def kernel(p_ref, vol_ref, coarse_ref, ox_ref, oy_ref, oz_ref, dx_ref,
               dy_ref, dz_ref, t1_ref, ex_ref, ey_ref, ez_ref, act_ref,
               out_ref):
        ray = (ox_ref[...], oy_ref[...], oz_ref[...], dx_ref[...],
               dy_ref[...], dz_ref[...], jnp.zeros((TILE_H, TILE_W), _F32),
               t1_ref[...], ex_ref[...], ey_ref[...], ez_ref[...])
        occ = _march_skip(
            _masked_fetch(vol_ref), _masked_fetch(coarse_ref), ray,
            act_ref[...] != 0, n=n, cell_half=p_ref[0], any_hit=True,
        )[0]
        out_ref[...] = occ.astype(_I32)

    return kernel


def _pad_to_tiles(x, fill=0):
    h, w = x.shape[-2:]
    ph, pw = -h % TILE_H, -w % TILE_W
    if ph or pw:
        pad = [(0, 0)] * (x.ndim - 2) + [(0, ph), (0, pw)]
        x = jnp.pad(x, pad, constant_values=fill)
    return x


def _pallas(kernel, n_whole, blocked, out_dtypes, interpret):
    """pallas_call over TILE_H x TILE_W tiles of the 2-D ``blocked``
    operands; the first ``n_whole`` operands are read whole."""
    rows, cols = blocked[0].shape
    tile = pl.BlockSpec((TILE_H, TILE_W), lambda i, j: (i, j))
    return pl.pallas_call(
        kernel,
        grid=(rows // TILE_H, cols // TILE_W),
        in_specs=[pl.no_block_spec] * n_whole + [tile] * len(blocked),
        out_specs=[tile] * len(out_dtypes),
        out_shape=[jax.ShapeDtypeStruct((rows, cols), d) for d in out_dtypes],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="ca3d_traverse",
    )


# ------------------------------------------------------------ entry points


@functools.partial(
    jax.jit,
    static_argnames=("grid_size", "shadow", "total_states", "kernel"),
)
def trace_primary(vol, dirs, origin, light_pos, cell_mul, ages=None, *,
                  grid_size, shadow=True, total_states=2, kernel=True):
    """First hits of one camera's rays, plus hard shadows and age fade.

    ``vol``: packed ``uint32[W, Z, Y]``.  ``dirs``: (dx, dy, dz), each
    ``[H, W]`` f32 unit world directions from ``origin`` (f32[3]).
    ``ages``: optional ``uint32[B, W, Z, Y]`` age bit-planes
    (``total_states > 2``).  Returns ``(depth, hit_idx, light)`` [H, W]:
    depth of the hit (volume exit for misses that crossed the volume, else
    0), cell id ``x + y n + z n^2`` (-1 = miss), and the factor on direct
    light — the hard-shadow quotient (1 when ``shadow`` is off) times the
    age fade.  ``kernel=False`` runs the plain ``jnp`` reference.
    """
    n = grid_size
    dx, dy, dz = dirs
    h, w = dz.shape
    cell_half = jnp.asarray(cell_mul, _F32) / n * 0.5
    params = jnp.concatenate([
        jnp.asarray(origin, _F32).reshape(3),
        jnp.asarray(light_pos, _F32).reshape(3),
        cell_half.reshape(1), jnp.zeros((1,), _F32),
    ])
    age_bits = 0 if ages is None else int(ages.shape[0])
    vol_flat = vol.reshape(-1)
    if not kernel:
        depth, idx, found, hx, hy, hz, factor = _primary_body(
            [params[i] for i in range(7)], vol_flat, None, dx, dy, dz,
            jnp.ones((h, w), bool), n=n, shadow=shadow,
            march=lambda f, _c, ray, act, **kw: _march_reference(
                f, ray, act, **kw),
        )
        if age_bits:
            ages_flat = ages.reshape(-1)
            factor = factor * _age_fade(
                lambda i, m: jnp.where(m, ages_flat[jnp.where(m, i, 0)],
                                       _U32(0)),
                found, hx, hy, hz, n, age_bits, total_states,
            )
        return depth, idx, factor

    interpret = select_backend() == "cpu"
    padded = [_pad_to_tiles(a) for a in (dx, dy, dz)]
    whole = [params, vol_flat, coarse_occupancy(vol).reshape(-1)]
    if age_bits:
        whole.append(ages.reshape(-1))
    call = _pallas(
        _primary_kernel(n, shadow, h, w, age_bits, total_states),
        len(whole), padded, (_F32, _I32, _F32), interpret,
    )
    depth, idx, factor = call(*whole, *padded)
    return depth[:h, :w], idx[:h, :w], factor[:h, :w]


@functools.partial(jax.jit, static_argnames=("grid_size", "kernel"))
def occluded(vol, start, target, exclude, active, cell_mul, *, grid_size,
             kernel=True):
    """Any-hit occlusion for a batch of queries.

    ``start``/``target``: f32 ``[Q, H, W, 3]`` world points; ``exclude``:
    int32 ``[Q, H, W, 3]`` cell skipped by the test (coordinates outside
    the grid exclude nothing); ``active``: bool ``[Q, H, W]``.  Returns
    bool ``[Q, H, W]``: a visible cube lies on the segment from ``start``
    toward ``target`` before the ray leaves the volume.
    """
    n = grid_size
    cell_half = jnp.asarray(cell_mul, _F32) / n * 0.5
    sx, sy, sz = start[..., 0], start[..., 1], start[..., 2]
    dx, dy, dz, t1 = shadow_ray(
        sx, sy, sz, target[..., 0], target[..., 1], target[..., 2]
    )
    ex, ey, ez = exclude[..., 0], exclude[..., 1], exclude[..., 2]
    vol_flat = vol.reshape(-1)
    if not kernel:
        ray = (sx, sy, sz, dx, dy, dz, jnp.zeros_like(t1), t1, ex, ey, ez)
        return _march_reference(
            vol_flat, ray, active, n=n, cell_half=cell_half, any_hit=True
        )[0]

    interpret = select_backend() == "cpu"
    q, h, w = active.shape
    fills = (0, 0, 0, 1, 1, 1, 0, -1, -1, -1, 0)
    arrays = (sx, sy, sz, dx, dy, dz, t1, ex, ey, ez, active.astype(_I32))
    blocked = [
        _pad_to_tiles(a, f).reshape(-1, a.shape[-1] + (-w % TILE_W))
        for a, f in zip(arrays, fills)
    ]
    params = jnp.concatenate([cell_half.reshape(1), jnp.zeros((7,), _F32)])
    whole = [params, vol_flat, coarse_occupancy(vol).reshape(-1)]
    out = _pallas(_occlusion_kernel(n), len(whole), blocked, (_I32,),
                  interpret)(*whole, *blocked)[0]
    hp = h + (-h % TILE_H)
    return out.reshape(q, hp, -1)[:, :h, :w] != 0
