"""Traversal kernel (Pallas, interpret mode) vs its plain ``jnp`` reference,
plus the backend selection and the GI cell-state lookup.

The kernel skips empty space on the coarse mip; the reference visits every
plane.  On the CPU both run the same float32 arithmetic per probe, so hits,
depths and light factors must agree exactly, at grid sizes that are and are
not powers of two, and on images that do not fill whole tiles.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import cellularautomatons3d_tpu as ca
from cellularautomatons3d_tpu.render import lighting, traverse
from cellularautomatons3d_tpu.render.renderer_fast import pixel_rays
from cellularautomatons3d_tpu.utils import mat4

W, H = 32, 16
LIGHT = (0.721, 1.0, 1.0)


def _scene(n, density, seed):
    rng = np.random.default_rng(seed)
    dense = (rng.random((n, n, n)) < density).astype(np.uint8)
    c = n // 2
    dense[c - 4:c + 4, c - 4:c + 4, c - 4:c + 4] = 1
    return dense


def _view(angle):
    view = mat4.rotate(mat4.initial_view_matrix(), (0, 1, 0), angle)
    return mat4.translate(view, (0, 0, 0.1)) if angle else view


def _both(fn, **kw):
    ref = [np.asarray(x) for x in fn(kernel=False, **kw)]
    ker = [np.asarray(x) for x in fn(kernel=True, **kw)]
    return ref, ker


def _primary(n, dense, angle, shadow, ages=None, total_states=2):
    view = _view(angle)
    _, dirs = pixel_rays(jnp.asarray(view), W, H)
    vol = jnp.asarray(ca.pack_grid(dense))

    def run(kernel):
        return traverse.trace_primary(
            vol, dirs, jnp.asarray(view[:3, 3]), LIGHT, 0.85, ages,
            grid_size=n, shadow=shadow, total_states=total_states,
            kernel=kernel,
        )

    return _both(run)


@pytest.mark.parametrize(
    "n,density,angle,shadow",
    [
        (32, 0.05, 0.0, False),
        (32, 0.05, 0.0, True),
        (64, 0.02, 0.6, True),
        (64, 0.2, 1.3, True),
        (96, 0.03, 0.3, True),   # not a power of two
    ],
)
def test_kernel_matches_reference_primary(n, density, angle, shadow):
    dense = _scene(n, density, seed=n)
    (d_r, i_r, f_r), (d_k, i_k, f_k) = _primary(n, dense, angle, shadow)
    assert (i_r >= 0).sum() > 0
    np.testing.assert_array_equal(i_k, i_r)
    np.testing.assert_array_equal(d_k, d_r)
    np.testing.assert_array_equal(f_k, f_r)
    if shadow:
        assert (f_r < 1.0).any() and (f_r[i_r >= 0] == 1.0).any()


def test_kernel_matches_reference_ages():
    """Multi-state ages: the launch looks up the hit cell's age planes."""
    n = 32
    rng = np.random.default_rng(4)
    ages_dense = (rng.integers(1, 8, (n, n, n))
                  * (rng.random((n, n, n)) < 0.08)).astype(np.uint8)
    ages = jnp.asarray(np.stack([ca.pack_grid((ages_dense >> b) & 1)
                                 for b in range(3)]))
    (d_r, i_r, f_r), (d_k, i_k, f_k) = _primary(
        n, ages_dense != 0, 0.2, True, ages=ages, total_states=8)
    np.testing.assert_array_equal(i_k, i_r)
    np.testing.assert_array_equal(f_k, f_r)
    hit = i_r >= 0
    assert len(np.unique(f_r[hit])) > 3  # several ages and shadow states


@pytest.mark.parametrize("n", [32, 96])
def test_kernel_matches_reference_occlusion(n):
    """Any-hit queries from random points toward random targets, with
    exclusion cells in and out of range and inactive lanes."""
    rng = np.random.default_rng(n)
    dense = _scene(n, 0.04, seed=n + 1)
    vol = jnp.asarray(ca.pack_grid(dense))
    q = 3
    start = rng.uniform(-0.45, 0.45, (q, H, W, 3)).astype(np.float32)
    target = rng.uniform(-1.5, 1.5, (q, H, W, 3)).astype(np.float32)
    excl = np.floor((start + 0.5) * n).astype(np.int32)
    excl[1, ::2] = n  # outside the grid: excludes nothing
    active = rng.random((q, H, W)) < 0.9

    def run(kernel):
        return (traverse.occluded(
            vol, jnp.asarray(start), jnp.asarray(target), jnp.asarray(excl),
            jnp.asarray(active), 0.85, grid_size=n, kernel=kernel),)

    (o_r,), (o_k,) = _both(run)
    np.testing.assert_array_equal(o_k, o_r)
    assert o_r.any() and not o_r.all()
    assert not o_r[~active].any()


def test_select_backend():
    assert traverse.select_backend("cpu") == "cpu"
    assert traverse.select_backend("gpu") == "gpu"
    assert traverse.select_backend() == "cpu"  # the test platform
    with pytest.raises(RuntimeError, match="metal"):
        traverse.select_backend("metal")


def test_cell_state_batch_matches_gather_oracle():
    """GI slot states equal a dense-grid lookup with the reference's
    clamp-then-wrap addressing for arbitrary target coords — edge-diagonal
    slot offsets, volume edges and out-of-range clamped bases — and 0 on
    inactive pixels."""
    n = 64
    rng = np.random.default_rng(21)
    dense = (rng.random((n, n, n)) < 0.2).astype(np.uint8)
    vol = jnp.asarray(ca.pack_grid(dense))
    h, w = 16, 32
    queries, wants = [], []
    for off in [(1, 0, 1), (-1, 0, 1), (0, 1, -1), (0, 0, 0)]:
        coords = rng.integers(0, n, (h, w, 3)).astype(np.int32)
        coords[0, :5] = [0, 0, 0]
        coords[1, :5] = [n - 1, n - 1, n - 1]
        coords[2, 0] = [5, n, 7]
        n_cl = np.maximum(coords + np.asarray(off, np.int32), 0) % n
        active = rng.random((h, w)) < 0.9
        queries.append((jnp.asarray(np.maximum(coords + off, 0)),
                        jnp.asarray(active)))
        want = dense[n_cl[..., 2], n_cl[..., 1], n_cl[..., 0]].astype(np.int32)
        wants.append(np.where(active, want, 0))
    got = lighting.cell_state_batch(vol, queries, n)
    for qi, (g, want) in enumerate(zip(got, wants)):
        np.testing.assert_array_equal(np.asarray(g), want,
                                      err_msg=f"query {qi}")
