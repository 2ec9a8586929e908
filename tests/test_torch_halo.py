"""The port's slab halo building blocks (``dmcf_tpu_torch/parallel/halo.py``)
against the JAX package's (``dmcf_tpu/parallel/halo.py``), on the CPU: JAX
on 2 of the 8 virtual CPU devices, the port on 2 gloo ranks
(``parallel.dist.spawn``; the rank bodies are in ``_torch_ranks.py``).

* ``slab_partition`` and ``min_slab_width``: bit for bit.
* ``_halo_select``: equal slots, masks and counts.
* The halo search: neighbour counts equal to JAX's exactly; the halo conv
  within 2e-5 absolute of JAX's (fp32 sums in another order); the zone
  overflow reported at a tiny ``halo_cap`` as in JAX.
* ``get_dilated_pos(center=)``: the pyramid anchored at a given center
  equals JAX's exactly (integer counts, float centers to 1e-6).
* ``spatial.shard_sample``: a rank's contiguous block of the particle rows.
* Sentinel rows (1e9 to 6e9, where the halo code parks unused slots) never
  enter the cell tables of the grid search or the sorted-window cell
  search: the lists equal a search over the valid rows alone, no query
  reports a cell overflow it would not have without them, and the lists
  and overflows equal JAX's exactly.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmcf_tpu.ops import sph as jsph
from dmcf_tpu.ops.neighbors import search as jsearch
from dmcf_tpu.ops.windows import get_window_func
from dmcf_tpu.parallel import halo as jhalo
from dmcf_tpu.parallel.spatial import make_spatial_mesh
from dmcf_tpu_torch.ops import sph
from dmcf_tpu_torch.ops.grid_search import grid_fixed_radius_search
from dmcf_tpu_torch.ops.neighbors import search
from dmcf_tpu_torch.parallel import halo
from dmcf_tpu_torch.parallel.dist import spawn
from dmcf_tpu_torch.parallel.spatial import shard_sample

import _torch_ranks

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

RADIUS = 0.1
K = 32


def _cloud(n=512, pad=576, seed=0):
    rng = np.random.RandomState(seed)
    pos = np.zeros((pad, 3), np.float32)
    pos[:n, 0] = rng.uniform(-2.0, 2.0, n)
    pos[:n, 1:] = rng.uniform(-0.3, 0.3, (n, 2))
    pos[n:] = 1e6 + np.arange(pad - n)[:, None] * 5.0
    mask = np.arange(pad) < n
    feats = np.zeros((pad, 4), np.float32)
    feats[:n] = rng.normal(size=(n, 4)).astype(np.float32)
    return pos, mask, feats


@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
def test_slab_partition_matches_jax(n_dev):
    pos, mask, feats = _cloud()
    want = jhalo.slab_partition(pos, mask, n_dev, payload=feats)
    got = halo.slab_partition(pos, mask, n_dev, payload=feats)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype
    assert halo.min_slab_width(got["bounds"]) == \
        jhalo.min_slab_width(want["bounds"])


@pytest.mark.parametrize("side", [1, -1])
def test_halo_select_matches_jax(side):
    pos, mask, feats = _cloud()
    plane = 1.2 if side > 0 else -1.2
    want = jhalo._halo_select(jnp.asarray(pos), jnp.asarray(mask),
                              jnp.asarray(feats), 0, plane, side, 64)
    got = halo._halo_select(torch.from_numpy(pos), torch.from_numpy(mask),
                            torch.from_numpy(feats), 0,
                            torch.tensor(plane, dtype=torch.float32), side,
                            64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[3]) > 0


@pytest.fixture(scope="module")
def halo_ranks():
    """One spawn of 2 gloo ranks for the module, in the background while
    the tests compute their references: a future of each rank's
    ``_torch_ranks.halo_search`` on ``_cloud``'s slabs."""
    pos, mask, feats = _cloud()
    kernel = np.random.RandomState(1).normal(
        scale=0.1, size=(4, 4, 4, 4, 8)).astype(np.float32)
    parts = jhalo.slab_partition(pos, mask, 2, payload=feats)
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(spawn, _torch_ranks.halo_search, 2,
                          args=(parts, kernel, RADIUS, K, 128, 2))


def test_halo_search_conv_matches_jax(halo_ranks):
    pos, mask, feats = _cloud()
    kernel = np.random.RandomState(1).normal(
        scale=0.1, size=(4, 4, 4, 4, 8)).astype(np.float32)
    parts = jhalo.slab_partition(pos, mask, 2, payload=feats)
    mesh = make_spatial_mesh(jax.devices()[:2])
    jparts = jhalo.shard_parts(parts, mesh)
    run = jhalo.make_halo_search_conv(mesh, radius=RADIUS, k=K, halo_cap=128,
                                      window_fn=get_window_func("poly6"),
                                      precision="highest")
    want_counts, _ = jax.jit(run)(jparts)
    want_conv, _ = jax.jit(run)(jparts, jnp.asarray(kernel))
    _, want_small = jax.jit(jhalo.make_halo_search_conv(
        mesh, radius=1.5, k=K, halo_cap=2))(jparts)

    ranks = halo_ranks.result()
    counts = torch.cat([r["counts"] for r in ranks]).numpy()
    conv = torch.cat([r["conv"] for r in ranks]).numpy()
    np.testing.assert_array_equal(counts, np.asarray(want_counts))
    np.testing.assert_allclose(conv, np.asarray(want_conv), rtol=0,
                               atol=2e-5)
    assert [r["over"] for r in ranks] == [0, 0]
    assert [r["over_conv"] for r in ranks] == [0, 0]
    # the overflow is summed over the ranks, so both report JAX's total
    assert int(want_small) > 0
    over_small = [r["over_small"] for r in ranks]
    assert over_small[0] == over_small[1] > 0
    # a search of the whole cloud on one process gives the same counts
    nl = grid_fixed_radius_search(torch.from_numpy(pos),
                                  torch.from_numpy(pos), RADIUS, K,
                                  points_mask=torch.from_numpy(mask),
                                  queries_mask=torch.from_numpy(mask))
    full = np.zeros(pos.shape[0], np.float32)
    m = parts["mask"].reshape(-1)
    full[parts["src"].reshape(-1)[m]] = counts[m, 0]
    np.testing.assert_array_equal(full[mask], nl.count.numpy()[mask])


def test_shard_sample_takes_contiguous_blocks():
    class G:
        world_size, rank = 4, 2
    sample = {"pos": np.arange(24).reshape(8, 3), "fluid_mask": np.ones(8),
              "feats": None}
    got = shard_sample(sample, G)
    np.testing.assert_array_equal(got["pos"], sample["pos"][4:6])
    assert got["feats"] is None
    with pytest.raises(ValueError):
        shard_sample({"pos": np.zeros((6, 3))}, G)


def test_exchange_refuses_gradients(halo_ranks):
    msg = halo_ranks.result()[0]["exchange_grad"]
    assert msg and "does not differentiate" in msg


def test_dilated_pos_center_matches_jax():
    pos, mask, _ = _cloud(n=200, pad=256)
    center = np.array([0.3, -0.05, 0.02], np.float32)
    vs = np.array([0.05, 0.05, 0.05], np.float32)
    # JAX's pyramid compiled whole (eager, each op compiles on its own)
    want = jax.jit(lambda p, m, c: jsph.get_dilated_pos(
        p, m, [1, 2, 4], [256, 512, 256], voxel_size=vs, centralize=True,
        center=c))(jnp.asarray(pos), jnp.asarray(mask), jnp.asarray(center))
    got = sph.get_dilated_pos(torch.from_numpy(pos), torch.from_numpy(mask),
                              [1, 2, 4], [256, 512, 256], voxel_size=vs,
                              centralize=True,
                              center=torch.from_numpy(center))
    for s in (1, 2):
        np.testing.assert_array_equal(got[1][s].numpy(),
                                      np.asarray(want[1][s]))
        assert int(got[2][s]) == int(want[2][s])
        m = got[1][s].numpy()
        np.testing.assert_allclose(got[0][s].numpy()[m],
                                   np.asarray(want[0][s])[m], rtol=0,
                                   atol=1e-6)
    # anchored elsewhere than the centroid, the grid differs from the
    # centroid's: the argument is used
    own = sph.get_dilated_pos(torch.from_numpy(pos), torch.from_numpy(mask),
                              [1, 2], [256, 512], voxel_size=vs,
                              centralize=True)
    assert not torch.equal(own[0][1], got[0][1])


@pytest.mark.parametrize("method", ["grid", "cell"])
def test_sentinel_rows_stay_out_of_cell_tables(method):
    pos, mask, _ = _cloud(n=300, pad=320)
    n = int(mask.sum())
    # the halo code's parked rows: pad rows from 1e9, unused send slots
    # from 2e9, unmatched receive slots from 3e9 and 6e9
    parked = np.concatenate([halo.PAD_FAR + np.arange(8)[:, None] * 7.0,
                             halo.HALO_FAR + np.arange(8)[:, None],
                             halo.RECV_FAR + np.arange(8)[:, None],
                             2 * halo.RECV_FAR + np.arange(8)[:, None]])
    parked = np.repeat(parked, 3, 1).astype(np.float32)
    full = np.concatenate([pos[:n], parked])
    fmask = np.arange(len(full)) < n
    # small caps, so that the budgets bind: the parked rows use none of
    # them (grid: cell_cap a cell; cell: occ_cap a sorted window)
    kw = dict(method=method, cell_cap=8, occ_cap=4)
    got = search(torch.from_numpy(full), torch.from_numpy(full), RADIUS, K,
                 points_mask=torch.from_numpy(fmask),
                 queries_mask=torch.from_numpy(fmask), **kw)
    ref = search(torch.from_numpy(pos[:n]), torch.from_numpy(pos[:n]),
                 RADIUS, K, **kw)
    for a, b in ((got.idx, ref.idx), (got.mask, ref.mask),
                 (got.count, ref.count), (got.cell_overflow,
                                          ref.cell_overflow)):
        np.testing.assert_array_equal(a[:n].numpy(), b.numpy())
    assert int(got.count[n:].max()) == 0
    assert int(got.cell_overflow[n:].max()) == 0
    # the parked rows' cells saturate at the int32 bound, as XLA's do
    jnl = jax.jit(lambda p, m: jsearch(p, p, RADIUS, K, points_mask=m,
                                       queries_mask=m, **kw))(
        jnp.asarray(full), jnp.asarray(fmask))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(jnl.count))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(jnl.idx))
    np.testing.assert_array_equal(got.cell_overflow.numpy(),
                                  np.asarray(jnl.cell_overflow))
