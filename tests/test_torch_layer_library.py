"""The port's layer library against the JAX package's flax layers with the
weights carried across (``interop.params_from_flax``), on the CPU:
``SparseConv`` and ``SparseConvTranspose`` (Linf search, identity mapping,
nearest_neighbor taps, the offset shift, the inverted list), the
parameterless ``PointSampling``, ``ContinuousConv``'s ``inp_importance``
on the K-list path (with ``normalize``) and on a DensePair, and per-query
extents through ``radius_search``.

Inputs: points on a 0.05 voxel grid (random occupancy) for the sparse
convs, a jittered cloud otherwise.  Tolerance: 2e-5 absolute on every
output (fp32 sums in another order; outputs O(1)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmcf_tpu.models import layers as jlayers
from dmcf_tpu.ops import cconv as jcc
from dmcf_tpu.ops import neighbors as jnb
from dmcf_tpu.ops import windows as jwin
from dmcf_tpu_torch.interop import params_from_flax
from dmcf_tpu_torch.models import layers
from dmcf_tpu_torch.ops import cconv, neighbors, windows

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

T = torch.from_numpy
VOXEL = 0.05
TOL = 2e-5


@pytest.fixture(scope="module")
def grid():
    """Two random subsets of a 7^3 grid at the voxel size (inputs and
    outputs), masks with a few padded rows, 4-channel features."""
    rng = np.random.RandomState(8)
    cells = np.stack(np.meshgrid(*[np.arange(7)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
    inp = (cells[rng.rand(len(cells)) < 0.5] * VOXEL).astype(np.float32)
    out = (cells[rng.rand(len(cells)) < 0.3] * VOXEL).astype(np.float32)
    imask = rng.rand(len(inp)) > 0.05
    omask = rng.rand(len(out)) > 0.05
    feats = rng.randn(len(inp), 4).astype(np.float32)
    imp = rng.uniform(0.5, 1.5, len(inp)).astype(np.float32)
    return dict(inp=inp, out=out, imask=imask, omask=omask, feats=feats,
                imp=imp)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else T(x)


@pytest.mark.parametrize("normalize,importance", [(False, False),
                                                  (True, True)])
@pytest.mark.parametrize("ksize", [(3, 3, 3), (2, 2, 2)])
@pytest.mark.parametrize("transpose", [False, True])
def test_sparse_convs_match_flax(grid, transpose, ksize, normalize,
                                 importance):
    """An odd kernel (offset 0) and an even one (offset -1/2 voxel), plain
    and with normalize and an importance."""
    g = grid
    if transpose:
        jl = jlayers.SparseConvTranspose(filters=3, kernel_size=ksize,
                                         normalize=normalize)
        tl = layers.SparseConvTranspose(4, 3, ksize, normalize=normalize)
        # the transpose's importance is indexed by the inputs' rows
        extra = "out_importance"
    else:
        jl = jlayers.SparseConv(filters=3, kernel_size=ksize,
                                normalize=normalize)
        tl = layers.SparseConv(4, 3, ksize, normalize=normalize)
        extra = "inp_importance"
    imp = g["imp"] if importance else None
    args = (g["feats"], g["inp"], g["out"])
    params = jax.jit(lambda k, f, i, o: jl.init(k, f, i, o, VOXEL))(
        jax.random.PRNGKey(1), *map(_j, args))
    params = jax.tree.map(lambda x: x + 0.1, params)  # a non-zero bias
    fn = jax.jit(lambda p, f, i, o, im, om, w: jl.apply(
        p, f, i, o, VOXEL, inp_mask=im, out_mask=om, **{extra: w}))
    want = np.asarray(fn(params, *map(_j, args), _j(g["imask"]),
                         _j(g["omask"]), _j(imp)))
    tl.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    got = tl(*map(_t, args), VOXEL, inp_mask=_t(g["imask"]),
             out_mask=_t(g["omask"]), **{extra: _t(imp)})
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL)


@pytest.mark.parametrize("window", [None, "poly6"])
def test_point_sampling_layer_matches_flax(grid, window):
    g = grid
    jl = jlayers.PointSampling(window_function=jwin.get_window_func(window))
    tl = layers.PointSampling(window_function=windows.get_window_func(
        window))
    assert list(tl.parameters()) == []
    args = (g["feats"], g["inp"], g["out"] + 0.01)
    want = np.asarray(jax.jit(lambda *x: jl.apply(
        {}, *x[:3], 0.12, inp_mask=x[3], out_mask=x[4]))(
            *map(_j, args), _j(g["imask"]), _j(g["omask"])))
    got = tl(*map(_t, args), 0.12, inp_mask=_t(g["imask"]),
             out_mask=_t(g["omask"]))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.RandomState(9)
    pts = rng.uniform(-0.3, 0.3, (64, 3)).astype(np.float32)
    qry = rng.uniform(-0.3, 0.3, (24, 3)).astype(np.float32)
    feats = rng.randn(64, 4).astype(np.float32)
    imp = rng.uniform(0.2, 1.0, 64).astype(np.float32)
    return pts, qry, feats, imp


@pytest.mark.parametrize("mode", ["linear", "nearest_neighbor"])
@pytest.mark.parametrize("window", [None, "poly6"])
@pytest.mark.parametrize("normalize", [False, True])
def test_inp_importance_on_klist_and_dense_paths(cloud, mode, window,
                                                 normalize):
    """The K-list path (with and without normalize: an importance makes it
    divide by the weights' sum) and, without normalize, a DensePair."""
    pts, qry, feats, imp = cloud
    win_j, win_t = jwin.get_window_func(window), windows.get_window_func(
        window)
    jnl = jax.jit(lambda p, q: jnb.fixed_radius_search(p, q, 0.2, 24))(
        pts, qry)
    nl = neighbors.NeighborList(*(None if x is None else T(np.array(x))
                                  for x in jnl))
    kw = dict(filters=3, kernel_size=(1, 4, 4), normalize=normalize,
              window_function=win_j, interpolation=mode)
    jl = jlayers.ContinuousConv(**kw)
    tl = layers.ContinuousConv(4, 3, (1, 4, 4), normalize=normalize,
                               window_function=win_t, interpolation=mode)
    a = (jnp.asarray(feats), jnp.asarray(pts), jnp.asarray(qry), 0.4, jnl)
    params = jax.jit(lambda k, f, p, q, n: jl.init(k, f, p, q, 0.4, n))(
        jax.random.PRNGKey(2), *a[:3], jnl)
    tl.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    apply = jax.jit(lambda p, f, i, q, n, w: jl.apply(p, f, i, q, 0.4, n,
                                                       inp_importance=w))
    want = np.asarray(apply(params, *a[:3], jnl, jnp.asarray(imp)))
    got = tl(T(feats), T(pts), T(qry), 0.4, nl, inp_importance=T(imp))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL)
    plain = tl(T(feats), T(pts), T(qry), 0.4, nl)
    assert np.abs(plain.detach().numpy() - want).max() > 1e-3
    if normalize:
        return
    # the same pair as a dense field
    rel = (pts[None] - qry[:, None]) / np.float32(0.2)
    d2 = (rel * rel).sum(-1)
    valid = d2 <= 1.0
    rel = np.where(valid[..., None], rel, 1.0).astype(np.float32)
    qnorm = np.where(valid, d2, 2.0).astype(np.float32)
    count = valid.sum(1).astype(np.int32)
    jdp = jnb.DensePair(rel=jnp.asarray(rel), qnorm=jnp.asarray(qnorm),
                        valid=jnp.asarray(valid), count=jnp.asarray(count))
    tdp = neighbors.DensePair(rel=T(rel), qnorm=T(qnorm), valid=T(valid),
                              count=T(count))
    want = np.asarray(apply(params, *a[:3], jdp, jnp.asarray(imp)))
    got = tl(T(feats), T(pts), T(qry), 0.4, tdp, inp_importance=T(imp))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL)
    lazy = neighbors.LazyDensePair(T(pts), torch.ones(64, dtype=bool),
                                   T(qry), torch.ones(24, dtype=bool), 0.2)
    with pytest.raises(ValueError):
        tl(T(feats), T(pts), T(qry), 0.4, lazy, inp_importance=T(imp))


@pytest.mark.parametrize("metric,window", [("L2", "poly6"), ("Linf", None)])
def test_per_query_extents_through_radius_search(cloud, metric, window):
    """A radius a query: ``radius_search``'s lists (distances not
    normalised, so the window sees d^2 / r_q^2 as JAX's does) into the
    K-list conv and point sampling with extents [Q]."""
    pts, qry, feats, imp = cloud
    radii = np.random.RandomState(1).uniform(0.12, 0.22, 24).astype(
        np.float32)
    jnl = jax.jit(lambda p, q, r: jnb.radius_search(
        p, q, r, 32, metric=metric, normalize_distances=False))(
            pts, qry, radii)
    nl = neighbors.radius_search(T(pts), T(qry), T(radii), 32,
                                 metric=metric, normalize_distances=False)
    np.testing.assert_array_equal(nl.count.numpy(), np.asarray(jnl.count))
    assert int(nl.count.max()) <= 32
    ext = 2.0 * radii
    kern = (np.random.RandomState(3).randn(1, 4, 4, 4, 3)
            * 0.2).astype(np.float32)
    for mode in ("linear", "nearest_neighbor"):
        want = np.asarray(jax.jit(lambda *x: jcc.continuous_conv(
            *x[:4], jnl, x[4], window_fn=jwin.get_window_func(window),
            interpolation=mode, inp_importance=x[5], normalize=True))(
                kern, qry, pts, feats, ext, imp))
        got = cconv.continuous_conv(
            T(kern), T(qry), T(pts), T(feats), nl, T(ext),
            window_fn=windows.get_window_func(window), interpolation=mode,
            inp_importance=T(imp), normalize=True)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    want = np.asarray(jax.jit(lambda f, e: jcc.point_sampling(
        f, jnl, e, window_fn=jwin.get_window_func(window)))(feats, ext))
    got = cconv.point_sampling(T(feats), nl, T(ext),
                               window_fn=windows.get_window_func(window))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
