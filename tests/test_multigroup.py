"""Multi-x-group coarse occupancy layouts (grids > 256) and the 288-480
partial-group case.

Grids 288-480 have a packed word count (9-15) that is neither ≤ 8 nor a
multiple of 8, so their last x-block group is partial.  These tests run
the real layouts at N=320 and 512: the mip's group assembly
(ops/occupancy.py) and the traversal kernel's skip test across x-block
groups, with a tiny window.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import cellularautomatons3d_tpu as ca
from cellularautomatons3d_tpu.ops.occupancy import (
    BLOCK,
    coarse_occupancy,
)
from cellularautomatons3d_tpu.ops.packing import pack_grid


def dense_occupancy(dense):
    z, y, x = dense.shape
    b = dense.reshape(z // BLOCK, BLOCK, y // BLOCK, BLOCK, x // BLOCK, BLOCK)
    return b.any(axis=(1, 3, 5))  # [Zc, Yc, Xc] bool


def unpack_groups(coarse, yc):
    """[Zc, XG·Yc] u32 → [Zc, Yc, XG·32] bool (group-major x-blocks)."""
    zc, ytot = coarse.shape
    xg = ytot // yc
    g = np.asarray(coarse).reshape(zc, xg, yc)
    bits = (g[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    # [Zc, XG, Yc, 32] → [Zc, Yc, XG·32]
    return bits.astype(bool).transpose(0, 2, 1, 3).reshape(zc, yc, xg * 32)


@pytest.mark.parametrize("n", [320, 512])
def test_coarse_occupancy_multigroup(n):
    rng = np.random.default_rng(1)
    dense = (rng.random((n, n, n)) < 0.0005).astype(np.uint8)
    dense[0, 0, n - 1] = 1  # last x-block: partial-group high word at 320
    coarse = coarse_occupancy(jnp.asarray(pack_grid(dense)))
    yc = n // BLOCK
    got = unpack_groups(coarse, yc)[:, :, : n // BLOCK]
    np.testing.assert_array_equal(got, dense_occupancy(dense))


def test_coarse_occupancy_320_no_crash():
    """The exact ADVICE r2 repro: a multiple-of-32 grid in 288-480."""
    packed = jnp.zeros((320 // 32, 320, 320), jnp.uint32)
    out = coarse_occupancy(packed)
    assert out.shape == (40, 2 * 40)  # XG=2 (partial second group)


def test_kernel_skips_across_x_groups_320():
    """Kernel vs plain reference at N=320 with oblique rays whose column
    block boxes straddle x-block groups (the two-word skip test)."""
    from cellularautomatons3d_tpu.render import traverse
    from cellularautomatons3d_tpu.render.renderer_fast import pixel_rays
    from cellularautomatons3d_tpu.utils import mat4

    n, w, h = 320, 32, 16
    rng = np.random.default_rng(9)
    dense = (rng.random((n, n, n)) < 0.002).astype(np.uint8)
    vol = jnp.asarray(pack_grid(dense))
    view = mat4.translate(
        mat4.rotate(mat4.initial_view_matrix(), (0, 1, 0), 0.9), (0, 0, 0.2))
    _, dirs = pixel_rays(jnp.asarray(view), w, h)
    outs = [
        [np.asarray(a) for a in traverse.trace_primary(
            vol, dirs, jnp.asarray(view[:3, 3]), (0.7, 1.0, 1.0), 0.85,
            grid_size=n, shadow=True, kernel=kernel)]
        for kernel in (False, True)
    ]
    (d_r, i_r, f_r), (d_k, i_k, f_k) = outs
    assert (i_r >= 0).sum() > 0
    np.testing.assert_array_equal(i_k, i_r)
    np.testing.assert_array_equal(d_k, d_r)
    np.testing.assert_array_equal(f_k, f_r)


def test_engine_config_320_keeps_fast_pipeline():
    cfg = ca.EngineConfig(grid_size=320)
    assert cfg.pipeline == "fast"
