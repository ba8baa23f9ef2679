"""Coarse occupancy mip vs a dense numpy reduction."""

import numpy as np
import jax.numpy as jnp

from cellularautomatons3d_tpu.ops.occupancy import coarse_occupancy, BLOCK
from cellularautomatons3d_tpu.ops.packing import pack_grid


def dense_occupancy(dense):
    z, y, x = dense.shape
    b = dense.reshape(z // BLOCK, BLOCK, y // BLOCK, BLOCK, x // BLOCK, BLOCK)
    return b.any(axis=(1, 3, 5))  # [Zc, Yc, Xc] bool


def unpack_coarse(coarse):
    zc, yc = coarse.shape
    bits = (coarse[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.astype(bool)  # [Zc, Yc, 32]


def test_coarse_occupancy_random():
    rng = np.random.default_rng(0)
    for n, p in ((64, 0.01), (64, 0.3), (256, 0.001)):
        dense = (rng.random((n, n, n)) < p).astype(np.uint8)
        coarse = np.asarray(coarse_occupancy(jnp.asarray(pack_grid(dense))))
        want = dense_occupancy(dense)
        got = unpack_coarse(coarse)[:, :, : n // BLOCK]
        np.testing.assert_array_equal(
            got, want.transpose(0, 1, 2)
        )  # [Zc, Yc, Xc]


def test_coarse_occupancy_single_cell():
    n = 64
    dense = np.zeros((n, n, n), np.uint8)
    dense[13, 42, 57] = 1
    coarse = np.asarray(coarse_occupancy(jnp.asarray(pack_grid(dense))))
    got = unpack_coarse(coarse)
    assert got[13 // 8, 42 // 8, 57 // 8]
    assert got.sum() == 1


# ---------------------------------------------------- plane-level mip --
#
# Multi-x-group assembly/dilation tests live in tests/test_multigroup.py;
# here only the plane-level mip (the render kernel's per-column fine-plane
# prefilter) gets its dense oracle.


def unpack_groups(rows, yc):
    """[R, XG·Yc] packed rows → [R, Yc, XG·32] bool block grid."""
    r, ytot = rows.shape
    xg = ytot // yc
    bits = (rows.reshape(r, xg, yc)[..., None]
            >> np.arange(32, dtype=np.uint32)) & 1
    return bits.astype(bool).transpose(0, 2, 1, 3).reshape(r, yc, xg * 32)
