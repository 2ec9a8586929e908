"""The port's L1 and Linf searches, ``radius_search``, ``prob_sample``,
``grid_pos_bnds``, the chamfer and hist losses, the host metrics and JAX's
precision names against the JAX package on identical numpy inputs, on the
CPU.

Tolerances: neighbour *sets* and counts exactly (``lax.top_k`` and a
stable sort may order equal distances differently), each kept pair's
distance to 1e-7 absolute plus two ulp of it (the same fp32 differences;
``radius_search``'s normalised distances, ~1, may round one ulp apart);
``prob_sample`` exactly on dyadic weights and, on random ones, but for the
uniforms within 1e-6 of a CDF edge (the two cumulative sums may round the
edge differently; their count is reported); ``grid_pos_bnds`` exactly;
the losses and metrics to 1e-6 relative (the same float64 host code);
convs at each precision name: fp32 names 2e-5 absolute, None and
"default" (bf16) 1e-4 of the max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmcf_tpu.models import losses as jlosses
from dmcf_tpu.ops import cconv as jcc
from dmcf_tpu.ops import cell_search as jcell
from dmcf_tpu.ops import grid_search as jgrid
from dmcf_tpu.ops import neighbors as jnb
from dmcf_tpu.ops import sph as jsph
from dmcf_tpu.pipelines import metrics as jmetrics
from dmcf_tpu_torch.kernels.cconv_klist import is_bf16
from dmcf_tpu_torch.models import losses
from dmcf_tpu_torch.ops import cconv, cell_search, grid_search, neighbors
from dmcf_tpu_torch.ops import sph
from dmcf_tpu_torch.pipelines import metrics
from tests.test_torch_search import jitted

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

T = torch.from_numpy


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.RandomState(5)
    pts = rng.uniform(0.0, 0.5, (150, 3)).astype(np.float32)
    qry = np.concatenate([pts[:30], rng.uniform(0.0, 0.5, (30, 3))
                          ]).astype(np.float32)
    pm = rng.rand(150) > 0.1
    qm = rng.rand(60) > 0.1
    return pts, qry, pm, qm


def _sets(nl):
    idx, mask = np.asarray(nl.idx), np.asarray(nl.mask)
    dist = np.asarray(nl.dist)
    return [dict(zip(idx[q][mask[q]].tolist(), dist[q][mask[q]].tolist()))
            for q in range(idx.shape[0])]


def assert_same_sets(got, ref):
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(ref.count))
    for g, w in zip(_sets(got), _sets(ref)):
        assert set(g) == set(w)
        for i in g:
            assert abs(g[i] - w[i]) <= 1e-7 + 2.4e-7 * abs(w[i])


SEARCHES = {  # name: (port call, JAX call), (points, queries, r, k, kw)
    "dense": (neighbors.fixed_radius_search, jnb.fixed_radius_search, {}),
    "chunked": (neighbors.fixed_radius_search, jnb.fixed_radius_search,
                dict(fast_path_max=64, chunk=48)),
    "cell": (cell_search.cell_fixed_radius_search,
             jcell.cell_fixed_radius_search, dict(occ_cap=32)),
    "grid": (grid_search.grid_fixed_radius_search,
             jgrid.grid_fixed_radius_search, dict(cell_cap=48)),
}


@pytest.mark.parametrize("search,ignore", [
    ("dense", False), ("dense", True), ("chunked", False), ("chunked", True),
    ("cell", True), ("grid", False)])
@pytest.mark.parametrize("metric", ["L1", "Linf"])
def test_metric_searches_match_jax(cloud, metric, search, ignore):
    pts, qry, pm, qm = cloud
    port, jax_fn, kw = SEARCHES[search]
    args = dict(points_mask=pm, queries_mask=qm, metric=metric,
                ignore_query_point=ignore, **kw)
    r = 0.2 if metric == "L1" else 0.1  # ~10 neighbours a query
    ref = jitted(jax_fn, pts, qry, r, 48, **args)
    got = port(T(pts), T(qry), r, 48, **{
        k: T(v) if isinstance(v, np.ndarray) else v for k, v in args.items()})
    assert int(got.count.max()) <= 48 and int(got.count.sum()) > 100
    assert_same_sets(got, ref)
    if search == "dense":
        d = np.asarray(ref.disp)
        np.testing.assert_array_equal(got.disp.numpy(), d)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("metric", ["L2", "L1", "Linf"])
def test_radius_search_matches_jax(cloud, metric, normalize):
    """A radius a query; the K nearest (ties aside) with their distances,
    normalised or not."""
    pts, qry, pm, qm = cloud
    radii = np.random.RandomState(3).uniform(0.05, 0.12, 60).astype(
        np.float32)
    kw = dict(points_mask=pm, queries_mask=qm, metric=metric,
              normalize_distances=normalize)
    ref = jitted(jnb.radius_search, pts, qry, radii, 24, **kw)
    got = neighbors.radius_search(T(pts), T(qry), T(radii), 24, **{
        k: T(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    assert int(got.count.max()) <= 24
    assert_same_sets(got, ref)


def test_prob_sample_matches_jax():
    """Exact where the weights are dyadic (every CDF edge exact in both);
    on random weights, equal but for uniforms within 1e-6 of an edge."""
    rng = np.random.RandomState(0)
    w = np.asarray([1, 2, 0, 4, 1, 0, 8], np.float32)
    u = np.concatenate([rng.uniform(0, 1, 500), np.cumsum(w)[:-1] / w.sum()
                        ]).astype(np.float32)
    want = np.asarray(jsph.prob_sample(jnp.asarray(w), jnp.asarray(u)))
    got = sph.prob_sample(T(w), T(u))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    w = rng.uniform(0.0, 1.0, 300).astype(np.float32)
    u = rng.uniform(0, 1, 20000).astype(np.float32)
    want = np.asarray(jsph.prob_sample(jnp.asarray(w), jnp.asarray(u)))
    got = sph.prob_sample(T(w), T(u)).numpy()
    cdf = np.cumsum(w.astype(np.float64)) / w.sum(dtype=np.float64)
    near = np.abs(u[:, None] - cdf[None, :]).min(axis=1) <= 1e-6
    differ = got != want
    assert not (differ & ~near).any()
    print(f"prob_sample: {int(differ.sum())} of {u.size} uniforms differ, "
          f"{int(near.sum())} lie within 1e-6 of a CDF edge")


@pytest.mark.parametrize("centralize", [False, True])
def test_grid_pos_bnds_matches_jax(centralize):
    rng = np.random.RandomState(2)
    pos = rng.uniform(-0.4, 0.6, (200, 3)).astype(np.float32)
    mask = rng.rand(200) > 0.2
    vs = [0.1, 0.1, 0.0]
    # eager: under jit XLA may fuse the centres' product and sum into one
    # rounding
    want = jsph.grid_pos_bnds(jnp.asarray(pos), jnp.asarray(mask), vs, 180,
                              centralize=centralize)
    got = sph.grid_pos_bnds(T(pos), T(mask), vs, 180, centralize=centralize)
    assert 0 < int(got[2]) < 180
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_chamfer_hist_and_metrics_match_jax():
    rng = np.random.RandomState(4)
    tgt = rng.randn(120, 3).astype(np.float32)
    pred = (tgt + 0.05 * rng.randn(120, 3)).astype(np.float32)
    mask = rng.rand(120) > 0.1
    for mode in (0, 1):
        want = jlosses.get_loss("chamfer", fac=2.0, mode=mode)(
            tgt, pred, mask)
        got = losses.get_loss("chamfer", fac=2.0, mode=mode)(
            T(tgt), T(pred), T(mask))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    want = jlosses.get_loss("hist", bin_size=5)(tgt, pred, mask)
    got = losses.get_loss("hist", bin_size=5)(T(tgt), T(pred), T(mask))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(RuntimeError, match="eval-only"):
        losses.get_loss("hist")(T(tgt), T(pred).requires_grad_(True))
    np.testing.assert_allclose(
        metrics.optimal_assignment_distance(tgt[:40], pred[:40]),
        jmetrics.optimal_assignment_distance(tgt[:40], pred[:40]),
        rtol=1e-6)
    d = np.abs(pred - tgt).sum(-1)
    assert metrics.compute_stats(d) == jmetrics.compute_stats(d)


PRECISIONS = [None, "default", "high", "highest", "float32", "bfloat16",
              "tensorfloat32", "fastest", "bfloat16_3x",
              jax.lax.Precision.HIGH, ("highest", "high")]


@pytest.fixture(scope="module")
def conv_inputs(cloud):
    pts, qry, _, _ = cloud
    rng = np.random.RandomState(6)
    feats = rng.randn(150, 8).astype(np.float32)
    kern = (rng.randn(1, 4, 4, 8, 4) * 0.1).astype(np.float32)
    jnl = jax.jit(lambda p, q: jnb.fixed_radius_search(p, q, 0.1, 48))(
        pts, qry)
    nl = neighbors.NeighborList(*(T(np.array(x)) if x is not None else None
                                  for x in jnl))
    return pts, qry, feats, kern, jnl, nl


@pytest.mark.parametrize("precision", PRECISIONS, ids=str)
def test_precision_names_match_jax(conv_inputs, precision):
    """Every precision JAX's continuous_conv takes (a ``jax.lax.Precision``
    by its name): None and "default" run its bf16 contraction, every other
    one fp32 (on the CPU JAX's matmul precision changes nothing); an
    unknown one raises."""
    pts, qry, feats, kern, jnl, nl = conv_inputs
    want = np.asarray(jax.jit(lambda k, q, p, f: jcc.continuous_conv(
        k, q, p, f, jnl, 0.2, precision=precision))(
            kern, qry, pts, feats))
    got = cconv.continuous_conv(T(kern), T(qry), T(pts), T(feats), nl, 0.2,
                                precision=precision).numpy()
    if is_bf16(precision):
        assert precision in (None, "default")
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, atol=2e-5)
    with pytest.raises(ValueError):
        is_bf16("medium")
