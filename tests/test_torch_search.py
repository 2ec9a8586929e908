"""The port's large-scene searches against the JAX package on identical
numpy inputs, on the CPU: the chunked running top-K of
``fixed_radius_search``, the sorted-window cell search and its exact
contact count (``ops/cell_search.py``), the hash-probe grid search and its
contact weight (``ops/grid_search.py``), ``search``'s dispatch and the
batched dense search.

Tolerances: indices, masks, counts, ``cell_overflow``, hashes and contact
counts exactly; squared distances to 1e-7 absolute (the same fp32
differences summed over three axes; |d|^2 <= r^2 < 0.1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmcf_tpu.ops import cell_search as jcell
from dmcf_tpu.ops import grid_search as jgrid
from dmcf_tpu.ops import neighbors as jnb
from dmcf_tpu_torch.ops import cell_search, grid_search, neighbors

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

T = torch.from_numpy
DIST_TOL = 1e-7


def jitted(fn, *args, **kw):
    """``fn(*args, **kw)`` compiled once as a whole (array arguments
    traced, the rest static): one compile instead of one an op."""
    def is_array(x):
        return isinstance(x, (np.ndarray, jax.Array))

    where = [i for i, x in enumerate(args) if is_array(x)]
    arrays = {k: v for k, v in kw.items() if is_array(v)}
    static = {k: v for k, v in kw.items() if k not in arrays}

    def call(pos, named):
        full = list(args)
        for i, x in zip(where, pos):
            full[i] = x
        return fn(*full, **static, **named)

    return jax.jit(call)([args[i] for i in where], arrays)


def assert_same_lists(got, ref, cell_overflow=False):
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(ref.count))
    np.testing.assert_allclose(got.dist.numpy(), np.asarray(ref.dist),
                               rtol=0, atol=DIST_TOL)
    if cell_overflow:
        np.testing.assert_array_equal(got.cell_overflow.numpy(),
                                      np.asarray(ref.cell_overflow))


def cloud(seed, n, dim=3, extent=0.6, clustered=False):
    rng = np.random.RandomState(seed)
    if clustered:  # a few tight clumps: many points a cell
        centres = rng.uniform(0, extent, (6, 3))
        pts = centres[rng.randint(0, 6, n)] + rng.normal(
            scale=0.02, size=(n, 3))
    else:
        pts = rng.uniform(0, extent, (n, 3))
    pts[:, dim:] = 0.0
    return pts.astype(np.float32)


def masks(seed, n, q, share=0.85):
    rng = np.random.RandomState(seed)
    return rng.rand(n) < share, rng.rand(q) < share


@pytest.mark.parametrize("ignore", [False, True])
def test_chunked_top_k_matches_jax(ignore):
    """N past fast_path_max 64, chunks of 32 (the last one short), masks,
    coincident points (ties and the ignore rule) and a query whose
    in-radius count (>= 30) overflows K 12: the same K nearest kept."""
    pts = cloud(0, 150, extent=0.3)
    pts[100:120] = pts[0]            # 21 coincident points: ties at d = 0
    pts[120:130] = pts[1] + 1e-3     # ties at one distance
    qs = np.concatenate([pts[:40], cloud(1, 20, extent=0.3)])
    pm, qm = masks(2, len(pts), len(qs))
    pm[:2] = qm[:2] = True
    kw = dict(points_mask=pm, queries_mask=qm, ignore_query_point=ignore,
              chunk=32, fast_path_max=64)
    got = neighbors.fixed_radius_search(T(pts), T(qs), 0.08, 12,
                                        **{k: T(v) if isinstance(
                                            v, np.ndarray) else v
                                           for k, v in kw.items()})
    ref = jitted(jnb.fixed_radius_search, jnp.asarray(pts),
                 jnp.asarray(qs), 0.08, 12, **kw)
    assert got.disp is None and got.cell_overflow is None
    assert int(got.count.max()) > 12          # overflow exercised
    assert_same_lists(got, ref)


@pytest.mark.parametrize("case", ["3d", "2d", "clustered", "masked_ignore",
                                  "block_chunk"])
def test_cell_search_matches_jax(case):
    dim = 2 if case == "2d" else 3
    pts = cloud(3, 700, dim=dim, clustered=case == "clustered")
    qs = np.concatenate([pts[::3], cloud(4, 90, dim=dim)])
    kw, tkw = {}, {}
    if case == "masked_ignore":
        pm, qm = masks(5, len(pts), len(qs))
        kw = dict(points_mask=pm, queries_mask=qm, ignore_query_point=True)
        tkw = dict(points_mask=T(pm), queries_mask=T(qm),
                   ignore_query_point=True)
    if case == "block_chunk":
        kw = tkw = dict(block_chunk=3)
    got = cell_search.cell_fixed_radius_search(
        T(pts), T(qs), 0.07, 24, occ_cap=64, **tkw)
    ref = jitted(jcell.cell_fixed_radius_search, jnp.asarray(pts),
                 jnp.asarray(qs), 0.07, 24, occ_cap=64, **kw)
    assert int(got.mask.sum()) > 0
    assert_same_lists(got, ref, cell_overflow=True)


@pytest.mark.parametrize("case", ["window", "span"])
def test_cell_search_overflow_matches_jax(case):
    """A window past W = 3 * occ_cap rows (clustered points, occ_cap 4)
    and a scene wider than G - 2 cells (the hard 2^20 report)."""
    if case == "window":
        pts = cloud(6, 400, clustered=True)
        radius, occ = 0.05, 4
    else:
        pts = cloud(7, 300, extent=0.6)
        pts[0] = [0.0, 0.0, 0.0]
        pts[1] = [1030 * 0.01, 0.0, 0.0]   # 1030 cells of 0.01 apart
        radius, occ = 0.01, 16
    qs = pts[::2]
    got = cell_search.cell_fixed_radius_search(T(pts), T(qs), radius, 16,
                                               occ_cap=occ)
    ref = jitted(jcell.cell_fixed_radius_search, jnp.asarray(pts),
                 jnp.asarray(qs), radius, 16, occ_cap=occ)
    assert int(got.cell_overflow.max()) > 0
    if case == "span":
        assert int(got.cell_overflow.min()) >= 1 << 20
    assert_same_lists(got, ref, cell_overflow=True)


def test_contact_weight_dense_matches_jax():
    fluid = cloud(8, 300, extent=0.3)
    box = cloud(9, 2000, extent=0.5)
    pm, qm = masks(10, len(fluid), len(box))
    got = cell_search.contact_weight_dense(T(fluid), T(box), 0.06,
                                           points_mask=T(pm),
                                           queries_mask=T(qm), chunk=300)
    ref = jitted(jcell.contact_weight_dense, jnp.asarray(fluid),
                 jnp.asarray(box), 0.06, points_mask=pm, queries_mask=qm,
                 chunk=300)
    assert int((got > 0).sum()) > 100
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_hash_cells_match_jax():
    rng = np.random.RandomState(11)
    c = rng.randint(-2 ** 31, 2 ** 31 - 1, size=(4000, 3)).astype(np.int32)
    c[:8] = [[0, 0, 0], [-1, -1, -1], [1, 2, 3], [-2 ** 31, 0, 2 ** 31 - 1],
             [5, -7, 9], [1023, 1024, -1025], [2 ** 31 - 1] * 3,
             [-2 ** 31] * 3]
    got = grid_search._hash_cells(T(c)).numpy()
    ref = np.asarray(jgrid._hash_cells(jnp.asarray(c)))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", ["3d", "planar", "masked_ignore",
                                  "cell_cap"])
def test_grid_search_matches_jax(case):
    dim = 2 if case == "planar" else 3
    pts = cloud(12, 600, dim=dim,
                clustered=case == "cell_cap")
    qs = np.concatenate([pts[::4], cloud(13, 60, dim=dim)])
    kw = dict(cell_cap=4 if case == "cell_cap" else 32,
              planar_axis=2 if case == "planar" else None)
    tkw = dict(kw)
    if case == "masked_ignore":
        pm, qm = masks(14, len(pts), len(qs))
        kw.update(points_mask=pm, queries_mask=qm, ignore_query_point=True)
        tkw.update(points_mask=T(pm), queries_mask=T(qm),
                   ignore_query_point=True)
    got = grid_search.grid_fixed_radius_search(T(pts), T(qs), 0.06, 20,
                                               query_chunk=100, **tkw)
    ref = jitted(jgrid.grid_fixed_radius_search, jnp.asarray(pts),
                 jnp.asarray(qs), 0.06, 20, **kw)
    if case == "cell_cap":
        assert int(got.cell_overflow.max()) > 0
    assert_same_lists(got, ref, cell_overflow=True)


def test_contact_weight_matches_jax():
    fluid = cloud(15, 300, extent=0.3)
    box = cloud(16, 1500, extent=0.5)
    pm, qm = masks(17, len(fluid), len(box))
    got = grid_search.contact_weight(T(fluid), T(box), 0.05,
                                     points_mask=T(pm), queries_mask=T(qm))
    ref = jitted(jgrid.contact_weight, jnp.asarray(fluid),
                 jnp.asarray(box), 0.05, points_mask=pm, queries_mask=qm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("shape", [(5000, 6000), (5000, 6001), (9000, 10),
                                   (3000, 12000)])
@pytest.mark.parametrize("method", ["auto", "brute", "cell", "grid"])
def test_search_dispatches_as_jax(monkeypatch, shape, method):
    """Which search ``search`` runs, by method and N*Q (auto: the cell
    search past 3e7): each package's three searches stubbed to name
    themselves."""
    seen = []

    def stub(name):
        return lambda *a, **k: seen.append((name, k.get("occ_cap"),
                                            k.get("cell_cap"),
                                            k.get("planar_axis")))

    for mod, cell, grid in ((jnb, jcell, jgrid),
                            (neighbors, cell_search, grid_search)):
        monkeypatch.setattr(mod, "fixed_radius_search", stub("brute"))
        monkeypatch.setattr(cell, "cell_fixed_radius_search", stub("cell"))
        monkeypatch.setattr(grid, "grid_fixed_radius_search", stub("grid"))
    n, q = shape
    kw = dict(method=method, occ_cap=40, cell_cap=12, planar_axis=2)
    jnb.search(jnp.zeros((n, 3)), jnp.zeros((q, 3)), 0.1, 8, **kw)
    neighbors.search(torch.zeros((n, 3)), torch.zeros((q, 3)), 0.1, 8,
                     **kw)
    assert len(seen) == 2 and seen[0] == seen[1], seen


def test_batched_search_matches_jax():
    pts = np.stack([cloud(18 + i, 200) for i in range(3)])
    qs = np.stack([cloud(21 + i, 90) for i in range(3)])
    pm = np.stack([masks(24 + i, 200, 90)[0] for i in range(3)])
    qm = np.stack([masks(24 + i, 200, 90)[1] for i in range(3)])
    radii = np.asarray([0.08, 0.1, 0.12], np.float32)
    got = neighbors.batched_fixed_radius_search(
        T(pts), T(qs), T(radii), 16, points_mask=T(pm), queries_mask=T(qm))
    ref = jitted(jnb.batched_fixed_radius_search, jnp.asarray(pts),
                 jnp.asarray(qs), radii, 16, points_mask=pm,
                 queries_mask=qm)
    assert_same_lists(got, ref)
    np.testing.assert_allclose(got.disp.numpy(), np.asarray(ref.disp),
                               rtol=0, atol=1e-7)
