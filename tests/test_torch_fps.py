"""Farthest-point sampling in the PyTorch port against the JAX reference,
on the CPU: the plain version of the CUDA kernel (``kernels/fps.py``)
against ``dmcf_tpu/ops/sph.py:farthest_point_sample``, and the pyramid's
farthest-point branch (``ops/sph.get_dilated_pos``) against JAX's.

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
