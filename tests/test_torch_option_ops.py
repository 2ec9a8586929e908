"""The ops the model options add, in the PyTorch port against the JAX
reference on identical numpy inputs, on the CPU: the Tait pressure, the
quaternion helpers and the equivariant displacement field, point
sampling (the density pyramid), the circular kernel and the transposed
neighbour list.  Tolerances: elementwise results 1e-6 absolute (the same
formulas, other libm and sum orders), neighbour lists and kernels exactly
(where not, stated at the test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmcf_tpu.ops import cconv as jcc
from dmcf_tpu.ops import neighbors as jnb
from dmcf_tpu.ops import sph as jsph
from dmcf_tpu.ops import windows as jwin
from dmcf_tpu_torch.ops import cconv, neighbors, sph, windows

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

T = torch.from_numpy


def test_compute_pressure_matches_jax():
    dens = np.linspace(0.0, 6.0, 301).astype(np.float32)
    got = sph.compute_pressure(T(dens), 3.5, 20.0).numpy()
    want = np.asarray(jax.jit(jsph.compute_pressure)(jnp.asarray(dens), 3.5,
                                                     20.0))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_quaternion_helpers_match_jax():
    rng = np.random.RandomState(1)
    q = rng.randn(64, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    r = rng.randn(64, 4).astype(np.float32)
    r /= np.linalg.norm(r, axis=-1, keepdims=True)
    v = rng.randn(64, 3).astype(np.float32)
    want = jax.jit(lambda q, r, v: (
        jsph.quat_mult(q, r), jsph.quat_conj(q), jsph.quat_rot(v, q),
        jsph.quat_mean(q, r)))(q, r, v)
    got = (sph.quat_mult(T(q), T(r)), sph.quat_conj(T(q)),
           sph.quat_rot(T(v), T(q)), sph.quat_mean(T(q), T(r)))
    for got, want in zip(got, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_compute_transformed_dx_matches_jax():
    rng = np.random.RandomState(2)
    pos = rng.uniform(-0.1, 0.1, (96, 3)).astype(np.float32)
    mask = np.arange(96) < 90
    pos = np.array(jsph.masked_positions(jnp.asarray(pos),
                                         jnp.asarray(mask)))
    scale = rng.randn(96, 1).astype(np.float32)
    rot = rng.randn(96, 4).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    want = jax.jit(lambda p, m, s, r: jsph.compute_transformed_dx(
        p, m, scale=s, rot=r, radius=0.05, k=32))(pos, mask, scale, rot)
    got = sph.compute_transformed_dx(T(pos), T(mask), scale=T(scale),
                                     rot=T(rot), radius=0.05, k=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert np.abs(np.asarray(want)).max() > 1e-3
    # a scale of the first 64 rows only (a fluid-only output): the
    # gather clamps, as JAX's does
    want = jax.jit(lambda p, m, s: jsph.compute_transformed_dx(
        p, m, scale=s, radius=0.05, k=32))(pos, mask, scale[:64])
    got = sph.compute_transformed_dx(T(pos), T(mask), scale=T(scale[:64]),
                                     radius=0.05, k=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_point_sampling_matches_jax():
    rng = np.random.RandomState(3)
    pts = rng.uniform(-0.2, 0.2, (128, 3)).astype(np.float32)
    qs = rng.uniform(-0.2, 0.2, (40, 3)).astype(np.float32)
    feats = rng.rand(128, 2).astype(np.float32)
    for win in (None, "poly6"):
        nl, want = jax.jit(lambda p, q, f: (lambda nl: (nl, jcc.point_sampling(
            f, nl, 0.16, window_fn=jwin.get_window_func(win))))(
                jnb.fixed_radius_search(p, q, 0.08, 32)))(pts, qs, feats)
        tnl = neighbors.NeighborList(
            idx=T(np.array(nl.idx)), mask=T(np.array(nl.mask)),
            dist=T(np.array(nl.dist)), count=T(np.array(nl.count)))
        got = cconv.point_sampling(T(feats), tnl, 0.16,
                                   window_fn=windows.get_window_func(win))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_point_sampling_gradient_is_finite_where_jax_is_nan():
    """A query row with no neighbour: JAX's gradient of the features is
    NaN (its ``where`` divides by the zero weight), the port's is finite
    and equals JAX's over the rows that have neighbours."""
    rng = np.random.RandomState(6)
    pts = rng.uniform(-0.2, 0.2, (64, 3)).astype(np.float32)
    qs = rng.uniform(-0.2, 0.2, (24, 3)).astype(np.float32)
    qs[0] = 5.0  # far from every point
    feats = rng.rand(64, 2).astype(np.float32)
    win = jwin.get_window_func("poly6")

    def jloss(f, q):
        nl = jnb.fixed_radius_search(jnp.asarray(pts), q, 0.08, 32)
        return jnp.sum(jcc.point_sampling(f, nl, 0.16, window_fn=win) ** 2)

    grad = jax.jit(jax.grad(jloss))
    nl = neighbors.fixed_radius_search(T(pts), T(qs), 0.08, 32)
    some = nl.count.numpy() > 0
    assert not some.all()
    nan = np.asarray(grad(feats, qs))
    want = np.asarray(grad(feats, qs[some]))
    assert np.isnan(nan).any() and np.isfinite(want).all()
    f = T(feats).requires_grad_(True)
    out = cconv.point_sampling(f, nl, 0.16,
                               window_fn=windows.get_window_func("poly6"))
    (out ** 2).sum().backward()
    assert float(out[0].abs().max()) == 0.0
    np.testing.assert_allclose(f.grad.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("symmetric", [False, True])
def test_build_circular_kernel_matches_jax(symmetric):
    """The cube kernel bit for bit; the odd field's factor (the signed
    coordinate over the kernel size, a constant XLA folds at compile
    time) within one ulp of jitted JAX's."""
    rng = np.random.RandomState(4)
    radial = rng.randn(3, 2, 3).astype(np.float32)
    for ks in ((1, 4, 4), (6, 6, 6), (1, 5, 3)):
        want = np.asarray(jax.jit(lambda r: jcc.build_circular_kernel(
            r, ks, symmetric=symmetric))(radial))
        got = cconv.build_circular_kernel(T(radial), ks,
                                          symmetric=symmetric).numpy()
        assert got.shape == want.shape
        if symmetric:
            np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)
        else:
            np.testing.assert_array_equal(got, want)


def test_invert_neighbors_list_matches_jax():
    """The transpose of a search is the search the other way (no
    overflow), JAX's inverse equal to the port's."""
    rng = np.random.RandomState(5)
    a = rng.uniform(-0.2, 0.2, (150, 3)).astype(np.float32)
    b = rng.uniform(-0.2, 0.2, (60, 3)).astype(np.float32)
    b[:, 2] = a[:60, 2] = 0.0
    fwd, want = jax.jit(lambda a, b: (lambda f: (
        f, jnb.invert_neighbors_list(f, 150, 24)))(
            jnb.fixed_radius_search(a, b, 0.06, 64)))(a, b)
    assert int(np.asarray(fwd.count).max()) <= 64
    tfwd = neighbors.NeighborList(
        idx=T(np.array(fwd.idx)), mask=T(np.array(fwd.mask)),
        dist=T(np.array(fwd.dist)), count=T(np.array(fwd.count)),
        disp=T(np.array(fwd.disp)))
    got = neighbors.invert_neighbors_list(tfwd, 150, 24)
    for f in ("idx", "mask", "dist", "count", "disp"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    direct = neighbors.fixed_radius_search(T(b), T(a), 0.06, 24)
    np.testing.assert_array_equal(got.idx.numpy(), direct.idx.numpy())
    np.testing.assert_array_equal(got.mask.numpy(), direct.mask.numpy())
