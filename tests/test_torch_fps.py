"""Farthest-point sampling in the PyTorch port against the JAX reference,
on the CPU: the plain version of the CUDA kernel (``kernels/fps.py``)
against ``dmcf_tpu/ops/sph.py:farthest_point_sample``, and the pyramid's
farthest-point branch (``ops/sph.get_dilated_pos``) against JAX's; the
kernel's schedule (``kernels/fps.schedule``) and its order-preserving
arg-max key (mirrored in numpy) on their own.

Tolerance: none.  Every pick depends on exact comparisons of distances
(a one-ulp change of one distance changes every later pick), so picks,
masks, counts and positions are held equal, on lattices with exact
distance ties too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmcf_tpu.ops import sph as jsph
from dmcf_tpu_torch.kernels import fps
from dmcf_tpu_torch.kernels.fps import (farthest_point_sample,
                                        farthest_point_sample_reference)
from dmcf_tpu_torch.ops import sph
from dmcf_tpu_torch.scene import build_scene

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

T = torch.from_numpy

_jax_fps = jax.jit(jsph.farthest_point_sample, static_argnums=2)


def _masked(pos, mask):
    return np.array(jsph.masked_positions(jnp.asarray(pos),
                                          jnp.asarray(mask)))


def _random(seed, n, dim):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    pos[:, dim:] = 0.0
    return pos, np.ones(n, bool)


def _scene_lattice():
    """``build_scene(256)``'s fluid and boundary (the boundary lines an
    exact lattice), 16 padded rows masked."""
    pos, box, _ = build_scene(256)
    pts = np.concatenate([pos, box, np.zeros((16, 3), np.float32)])
    mask = np.arange(len(pts)) < len(pos) + len(box)
    return pts[:256], mask[:256]


def _cube_lattice():
    """An exact 6 x 6 x 6 lattice at spacing 0.01: ties at every pick."""
    g = np.stack(np.meshgrid(*[np.arange(6)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    return (g * 0.01).astype(np.float32), np.ones(len(g), bool)


def _holes():
    """Random 3D points with every third row masked (sentinel rows)."""
    pos, mask = _random(5, 200, 3)
    mask[::3] = False
    return pos, mask


CASES = {
    "random_2d": (lambda: _random(0, 256, 2), 64, 64),
    "random_3d": (lambda: _random(1, 256, 3), 128, 100),
    "scene_lattice": (_scene_lattice, 128, 128),
    "cube_lattice": (_cube_lattice, 216, 216),
    "masked_rows": (_holes, 150, 66),
    "count_below_max": (lambda: _random(2, 96, 3), 48, 7),
    # the kernel's one-warp limit and one row past it
    "warp_limit": (lambda: _random(6, fps.WARP_ROWS, 3), 16, 12),
    "warp_limit_plus_1": (lambda: _random(7, fps.WARP_ROWS + 1, 2), 16, 16),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_fps_matches_jax(case):
    make, sample_max, count = CASES[case]
    pos, mask = make()
    pos = _masked(pos, mask)
    ref_idx, ref_sel = _jax_fps(jnp.asarray(pos), jnp.asarray(mask),
                                sample_max, count)
    idx, sel = farthest_point_sample(T(pos), T(mask), sample_max,
                                     torch.tensor(count, dtype=torch.int32))
    assert idx.dtype == torch.int32 and sel.dtype == torch.bool
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(ref_sel))
    if case == "masked_rows":  # all valid rows picked before a masked one
        assert mask[idx.numpy()[:mask.sum()]].all()


def test_plain_fps_batches_sets_independently():
    a, b = _random(3, 80, 3)[0], _cube_lattice()[0][:80]
    pos = np.stack([a, b])
    mask = np.ones((2, 80), bool)
    mask[1, :5] = False
    pos[1] = _masked(pos[1], mask[1])
    count = torch.tensor([30, 11], dtype=torch.int32)
    idx, sel = farthest_point_sample_reference(T(pos), T(mask), 40, count)
    for s in range(2):
        one, one_sel = farthest_point_sample_reference(
            T(pos[s]), T(mask[s]), 40, count[s])
        np.testing.assert_array_equal(idx[s].numpy(), one.numpy())
        np.testing.assert_array_equal(sel[s].numpy(), one_sel.numpy())


def test_fps_pyramid_matches_jax():
    """``get_dilated_pos`` without a voxel size: each coarse scale a
    farthest-point sample of the one before, ``max(count // stride, 1)``
    valid picks (the absolute stride), its rows in ``idx``."""
    pts, mask = _scene_lattice()
    pts = _masked(pts, mask)
    caps = [256, 128, 64]
    ref = jax.jit(lambda p, m: jsph.get_dilated_pos(p, m, [1, 2, 4], caps))(
        jnp.asarray(pts), jnp.asarray(mask))
    got = sph.get_dilated_pos(T(pts), T(mask), [1, 2, 4], caps)
    assert got[3][0] is None and ref[3][0] is None
    for s in range(3):
        np.testing.assert_array_equal(got[0][s].numpy(), np.asarray(ref[0][s]))
        np.testing.assert_array_equal(got[1][s].numpy(), np.asarray(ref[1][s]))
        assert int(got[2][s]) == int(ref[2][s])
        if s:
            np.testing.assert_array_equal(got[3][s].numpy(),
                                          np.asarray(ref[3][s]))
    # the absolute stride: scale 2 holds count_1 // 4 picks
    assert int(got[2][2]) == max(int(got[2][1]) // 4, 1)


@pytest.mark.parametrize("regime,first,last", [
    ("warp", 1, fps.WARP_ROWS),
    ("block", fps.WARP_ROWS + 1, fps.REGISTER_ROWS),
    ("workspace", fps.REGISTER_ROWS + 1, fps.REGISTER_ROWS + 300)])
def test_schedule_holds_every_set(regime, first, last):
    """For every N from 1 to past the registers' capacity the schedule
    covers every row with at most 1,024 threads (and the kernel's launch
    bounds), with the rows a thread the kernel is built for: sets one warp
    holds take the one-warp regime, larger ones a block of a power of two
    warps, sets past the registers the workspace."""
    assert fps.WARP_ROWS <= 32 * fps.ITEMS[-1]
    assert max(fps.threads_cap(i) for i in fps.ITEMS) == 1024
    for n in range(first, last + 1):
        s = fps.schedule(n)
        assert s.regime == regime, (n, s)
        if regime == "warp":
            assert s.warps == 1 and s.items in fps.ITEMS, (n, s)
            assert 32 * s.items >= n, (n, s)
        elif regime == "block":
            assert s.items in fps.ITEMS, (n, s)
            assert s.warps in (2, 4, 8, 16, 32), (n, s)
            assert 32 * s.warps * s.items >= n, (n, s)
            assert 32 * s.warps <= fps.threads_cap(s.items), (n, s)
        else:
            assert s.items == 0 and s.warps in (1, 2, 4, 8, 16, 32), (n, s)


def _order_key(v):
    """numpy mirror of ``order_key`` in ``csrc/fps.cu``: a value >= +0
    maps to its float bits plus 1, -inf (a masked row) to 0."""
    v = np.asarray(v, np.float32)
    return np.where(v >= 0, v.view(np.uint32) + np.uint32(1),
                    np.uint32(0)).astype(np.uint32)


def test_order_key_orders_as_value_then_lowest_index():
    """The kernel's arg-max (largest key, then lowest index among equal
    keys) is the order on (value, -index) of the running minima: +0,
    subnormals, normals, the largest float, +inf (a valid row before its
    first update) and -inf (a masked row), equal values included; and the
    distances, fma(dz, dz, fma(dy, dy, dx * dx)), are never -0 (whose
    bits would break the key)."""
    tiny = np.finfo(np.float32).tiny
    sub = np.float32(1.4e-45)
    edge = np.array([-np.inf, 0.0, sub, 2 * sub, tiny - sub, tiny,
                     np.nextafter(tiny, np.float32(1)), 1.0,
                     np.nextafter(np.float32(1), np.float32(2)),
                     np.finfo(np.float32).max, np.inf], np.float32)
    keys = _order_key(edge)
    assert (np.diff(keys.astype(np.int64)) > 0).all()
    assert keys[0] == 0 and keys[1] == 1
    rng = np.random.RandomState(0)
    for _ in range(200):
        v = rng.choice(edge, size=int(rng.randint(1, 40)))  # equal values
        i = np.arange(len(v))
        by_value = np.lexsort((i, -v.astype(np.float64)))
        by_key = np.lexsort((i, -_order_key(v).astype(np.int64)))
        np.testing.assert_array_equal(by_key, by_value)
        k = _order_key(v)
        top = k.max()
        assert np.flatnonzero(k == top).min() == int(torch.argmax(T(v)))
    zeros = torch.tensor([0.0, -0.0])
    d = torch.cartesian_prod(zeros, zeros, zeros)
    dist = fps.fma(d[:, 2], d[:, 2], fps.fma(d[:, 1], d[:, 1],
                                             d[:, 0] * d[:, 0]))
    assert not torch.signbit(dist).any()
