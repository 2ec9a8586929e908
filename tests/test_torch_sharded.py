"""The port's particle-sharded step (``dmcf_tpu_torch/parallel/spatial.py``
``make_sharded_step``) against the JAX package's (``dmcf_tpu/parallel/
spatial.py``) and against its own single-process step, on the CPU: JAX
on 2 of the 8 virtual CPU devices, the port on 1-3 gloo ranks
(``parallel.dist.spawn``; rank bodies in ``_torch_ranks.py``), at
``precision: highest``.

Cases, all in one spawn a world size: ``jax_scene`` is
``tests/test_parallel.py``'s scene and model (WaterRamps' SymNet with
``neighbor_k`` 16, 64 fluid and 32 boundary rows) with JAX's weights
carried over by ``interop.params_from_flax``; ``waterramps`` the same
model on 66 fluid and 36 boundary rows, whose 102 rows split over 3 but
whose coarse scales (51 and 26 rows) do not; ``cell`` that scene with the
cell search (whose query blocks span rank boundaries); ``path_b``
``column/hrnet.yml`` with chip_smoke's path-B options (the farthest-point
pyramid, ``transpose_search_reuse``, ``equivar``, circular kernels) on a
column of 60 + 24 rows, its coarse scales 42, 21 and 11 rows;
``global_sizes`` the ``cell`` case on 30 fluid in 36 rows over 60
boundary in 66 (more boundary rows than fluid rows: there the boundary
conv's geometry without ``disp`` depends on whether the reference caches
the all->all pair's taps, ROADMAP section 3) with ``tap_cache_max_elems``
and ``dense_lazy_min_elems`` between a rank's Q*K*S (Q*N) and the whole
set's.

Tolerances: against JAX, fluid positions within JAX's own 1e-5
(``test_parallel.py``), velocities within 1e-3 (a position difference
over dt 0.0025), integer ``aux`` exactly but for the pair-excess entries
of two pairs where the port's single-process step already counts one
neighbour fewer than JAX's (``LATTICE_TIES``).  Against one process (the one
process run in the rank, with its threads): one rank bit for bit; 2 and
3 ranks within 1e-6 in positions and velocities and within 1e-6 of its
largest value in the position correction (the plain conv's matrix
products may block by the rows, so a rank's rows could sum in another
order; measured: bit for bit on this CPU; the card's kernel computes
each row alone), integer ``aux`` and ``avg_neighbors`` exactly.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dmcf_tpu.models import build_model as jax_build_model
from dmcf_tpu.parallel.spatial import (make_sharded_step as jax_sharded,
                                       make_spatial_mesh,
                                       shard_sample as jax_shard)
from dmcf_tpu_torch.interop import params_from_flax
from dmcf_tpu_torch.models import build_model
from dmcf_tpu_torch.ops.sph import masked_positions
from dmcf_tpu_torch.parallel.dist import init_group, row_block, spawn

import _torch_ranks
import chip_smoke

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
# chip_smoke's path B with coarse scales of fewer rows
PATH_B = dict(chip_smoke.PATH_B, scale_size_factor=[1.0, 0.5, 0.25, 0.125])
# between a rank's Q*K*S of the all->all pair (51 * 16 * 64 at two ranks,
# 34 * 16 * 64 at three) and the whole set's (102 * 16 * 64); and between
# a rank's Q*N of the scale 0 -> 1 dense pair (26 * 102) and the set's
# (51 * 102)
GLOBAL_SIZES = dict(tap_cache_max_elems=80_000, dense_lazy_min_elems=4_000)
# the one-process port's pair excess differs from JAX's on two pairs of
# the JAX scene: its scale 2 is a lattice of voxel centres 0.04 apart, so
# pairs two cells apart sit exactly at the radius 0.08, where the two
# packages' fp32 distances differ in the last bit; the port counts one
# neighbour fewer there (at zero window weight: the step agrees).
# ROADMAP.md section 3 records it.
LATTICE_TIES = {"dilated1>dilated2@0.08(dense)": -1,
                "dilated2>dilated2@0.08": -1}
INT_AUX = ("neighbor_overflow", "pair_overflow", "scale_counts",
           "scale_caps", "cell_overflow")


def _cfg(name, **kw):
    with open(os.path.join(CONFIG_DIR, name)) as f:
        return dict(yaml.safe_load(f)["model"], precision="highest", **kw)


def _masked(pos, fm):
    return masked_positions(torch.from_numpy(pos),
                            torch.from_numpy(fm)).numpy()


def jax_scene():
    """tests/test_parallel.py's scene (numpy)."""
    rng = np.random.RandomState(0)
    n, b = 64, 32
    pos = np.zeros((n, 3), np.float32)
    pos[:48] = rng.uniform(-0.2, 0.2, (48, 3))
    pos[:, 2] = 0
    box = np.zeros((b, 3), np.float32)
    box[:16] = rng.uniform(-0.3, 0.3, (16, 3))
    box[:, 2] = 0
    nrm = np.zeros((b, 3), np.float32)
    nrm[:16, 1] = 1
    fm, bm = np.arange(n) < 48, np.arange(b) < 16
    grav = np.zeros((n, 3), np.float32)
    grav[:, 1] = -9.81
    return {"pos": _masked(pos, fm), "vel": np.zeros((n, 3), np.float32),
            "grav": grav, "box": box, "box_normals": nrm, "fluid_mask": fm,
            "box_mask": bm}


def block_scene(nf=66, vf=50, nb=36, vb=24, seed=0):
    """``vf`` fluid in ``nf`` rows above a ``vb``-point floor in ``nb``
    rows (2D)."""
    rng = np.random.RandomState(seed)
    pos = np.zeros((nf, 3), np.float32)
    pos[:vf, :2] = rng.uniform(-0.1, 0.1, (vf, 2))
    vel = np.zeros((nf, 3), np.float32)
    vel[:vf, :2] = rng.randn(vf, 2) * 0.05
    box = np.zeros((nb, 3), np.float32)
    box[:vb, 0] = np.linspace(-0.15, 0.15, vb)
    box[:vb, 1] = -0.12
    nrm = np.zeros((nb, 3), np.float32)
    nrm[:vb, 1] = 1
    fm, bm = np.arange(nf) < vf, np.arange(nb) < vb
    grav = np.zeros((nf, 3), np.float32)
    grav[:, 1] = -9.81
    return {"pos": _masked(pos, fm), "vel": vel, "grav": grav, "box": box,
            "box_normals": nrm, "fluid_mask": fm, "box_mask": bm}


def column_scene(seed=1):
    """A column along y: 45 fluid in 60 rows over 18 boundary in 24."""
    rng = np.random.RandomState(seed)
    nf, vf, nb, vb = 60, 45, 24, 18
    pos = np.zeros((nf, 3), np.float32)
    pos[:vf, 1] = 0.004 + 0.0045 * np.arange(vf) \
        + rng.uniform(-5e-4, 5e-4, vf)
    vel = np.zeros((nf, 3), np.float32)
    vel[:vf, 1] = rng.randn(vf) * 0.05
    box = np.zeros((nb, 3), np.float32)
    box[:vb, 1] = -0.004 * np.arange(vb)
    nrm = np.zeros((nb, 3), np.float32)
    nrm[:vb, 1] = 1
    fm, bm = np.arange(nf) < vf, np.arange(nb) < vb
    grav = np.zeros((nf, 3), np.float32)
    grav[:, 1] = -10.0
    return {"pos": _masked(pos, fm), "vel": vel, "grav": grav, "box": box,
            "box_normals": nrm, "fluid_mask": fm, "box_mask": bm}


@pytest.fixture(scope="module")
def jax_case():
    """JAX's model on test_parallel's scene, a flax param tree of its
    shapes (``eval_shape`` of its init: no compile) drawn from a seeded
    generator, and the port's state dict of it."""
    cfg = _cfg("WaterRamps.yml", neighbor_k=16)
    jmodel = jax_build_model(dict(cfg))
    sample = jax_scene()
    js = {k: jnp.asarray(v) for k, v in sample.items()}
    shapes = jax.eval_shape(
        lambda key, s: jmodel.init(key, s, training=False),
        jax.random.PRNGKey(0), js)
    rng = np.random.RandomState(0)
    params = jax.tree.map(lambda a: rng.uniform(
        -0.3, 0.3, a.shape).astype(np.float32), shapes)
    state = params_from_flax(params)
    return dict(cfg=cfg, jmodel=jmodel, params=params, state=state,
                sample=sample)


def _state(cfg):
    return build_model(dict(cfg), device="cpu").state_dict()


@pytest.fixture(scope="module")
def cases(jax_case):
    wr = _cfg("WaterRamps.yml", neighbor_k=16)
    cell = dict(wr, search_method="cell")
    col = _cfg("column/hrnet.yml", **PATH_B)
    sizes = dict(cell, **GLOBAL_SIZES)
    return {"jax_scene": (jax_case["cfg"], jax_case["state"],
                          jax_case["sample"]),
            "waterramps": (wr, _state(wr), block_scene()),
            "cell": (cell, _state(cell), block_scene()),
            "path_b": (col, _state(col), column_scene()),
            "global_sizes": (sizes, _state(cell), block_scene(36, 30, 66,
                                                              60))}


_RUNS = {}


@pytest.fixture(scope="module")
def runs(cases):
    """Each world size's ranks (once, every case whose rows it divides:
    the JAX scene's 64 and 32 at two ranks).  A world of one runs here,
    in this process's own group; two and three ranks spawn at once, in
    the background from the fixture's first use, while the tests compute
    their references."""
    def mine(world):
        return {k: v for k, v in cases.items()
                if k != "jax_scene" or world == 2}

    with ThreadPoolExecutor(2) as pool:
        spawned = {w: pool.submit(spawn, _torch_ranks.sharded_cases, w,
                                  args=(mine(w),)) for w in (2, 3)}

        def get(world):
            if world not in _RUNS:
                if world == 1:
                    with init_group("cpu", rank=0, world_size=1) as group:
                        _RUNS[1] = [_torch_ranks.sharded_cases(group,
                                                               mine(1))]
                else:
                    _RUNS[world] = spawned[world].result()
            return _RUNS[world]
        yield get


def _whole(ranks, name, key):
    return torch.cat([r[name][key] for r in ranks]).numpy()


def test_row_blocks_cover_the_rows():
    for n in (1, 7, 26, 51, 102):
        for w in (1, 2, 3, 4):
            blocks = [row_block(n, w, r) for r in range(w)]
            assert blocks[0][0] == 0 and blocks[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
            assert max(hi - lo for lo, hi in blocks) == -(-n // w)
            assert n < w or min(hi - lo for lo, hi in blocks) > 0


def test_sharded_step_matches_jax(jax_case, runs):
    """The 2-rank step against JAX's make_sharded_step on 2 devices."""
    jmodel, params, sample = (jax_case["jmodel"], jax_case["params"],
                              jax_case["sample"])
    mesh = make_spatial_mesh(jax.devices()[:2])
    js = jax_shard({k: jnp.asarray(v) for k, v in sample.items()}, mesh)
    jp, jv, jaux = jax_sharded(jmodel, mesh)(params, js)
    ranks = runs(2)
    fm = sample["fluid_mask"]
    np.testing.assert_allclose(_whole(ranks, "jax_scene", "pos")[fm],
                               np.asarray(jp)[fm], rtol=0, atol=1e-5)
    np.testing.assert_allclose(_whole(ranks, "jax_scene", "vel")[fm],
                               np.asarray(jv)[fm], rtol=0, atol=1e-3)
    for r in ranks:
        aux = r["jax_scene"]["aux"]
        for k in INT_AUX:
            if k in jaux:
                np.testing.assert_array_equal(aux[k].numpy(),
                                              np.asarray(jaux[k]), err_msg=k)
        got = {k: int(v) for k, v in aux["pair_overflow_detail"].items()}
        want = {k: int(v) for k, v in jaux["pair_overflow_detail"].items()}
        assert set(got) == set(want)
        assert {k: got[k] - want[k] for k in got if got[k] != want[k]} \
            == LATTICE_TIES
        np.testing.assert_allclose(aux["num_fluid_neighbors"].numpy(),
                                   np.asarray(jaux["num_fluid_neighbors"]))


@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("name", ["waterramps", "cell", "path_b",
                                  "global_sizes"])
def test_sharded_step_matches_one_process(runs, name, world):
    ranks = runs(world)
    ref = ranks[0][name]
    tol = 0.0 if world == 1 else 1e-6
    for key in ("pos", "vel"):
        got, want = _whole(ranks, name, key), ref[f"ref_{key}"].numpy()
        if world == 1:
            np.testing.assert_array_equal(got, want, err_msg=key)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                   err_msg=key)
    want_aux = ref["ref_aux"]
    for r in ranks:
        aux = r[name]["aux"]
        assert set(aux) == set(want_aux)
        for k, want in want_aux.items():
            got = aux[k]
            if isinstance(want, dict):
                assert {a: int(b) for a, b in got.items()} \
                    == {a: int(b) for a, b in want.items()}, k
            elif k == "pos_correction" and world > 1:
                np.testing.assert_allclose(
                    got.numpy(), want.numpy(), rtol=0,
                    atol=tol * float(want.abs().max()), err_msg=k)
            else:
                np.testing.assert_array_equal(got.numpy(), want.numpy(),
                                              err_msg=k)


def test_ranks_split_the_conv_rows(runs):
    """Each ContinuousConv call (forward hooks) of a rank takes at most
    ceil(Q/2) query rows, and a rank's sum of Q*K over its calls is at
    most 0.55 of one process's: the port's counterpart of
    ``test_parallel.py::TestSpatialWorkingSet``."""
    for name in ("waterramps", "path_b"):
        for r in runs(2):
            calls, one = r[name]["calls"], r[name]["one_calls"]
            assert [(k, n) for _, k, n in calls] == \
                [(k, q) for q, k, _ in one]
            assert all(q <= -(-n // 2) for q, _, n in calls), calls
            share = sum(q * k for q, k, _ in calls) / sum(
                q * k for q, k, _ in one)
            assert share <= 0.55, (name, share)


def test_decisions_read_the_whole_set(cases, runs):
    """The thresholds of ``global_sizes`` lie between a rank's size and
    the set's, and the tap-cache decision moves the result (the
    boundary conv's geometry without ``disp``): a rank that decided on
    its own rows would leave one process's branch.  The step still
    equals one process (``test_sharded_step_matches_one_process``)."""
    cfg, state, sample = cases["global_sizes"]
    q_all = len(sample["pos"]) + len(sample["box"])
    k, s = cfg["neighbor_k"], int(np.prod(cfg["kernel_size"]))
    for world in (2, 3):
        assert -(-q_all // world) * k * s <= cfg["tap_cache_max_elems"] \
            < q_all * k * s
    q1 = -(-q_all // 2)                # scale 1's rows (factor 0.5)
    assert -(-q1 // 2) * q_all < cfg["dense_lazy_min_elems"] <= q1 * q_all
    got = {}
    for cap in (cfg["tap_cache_max_elems"], 1 << 30):
        model = build_model(dict(cfg, tap_cache_max_elems=cap),
                            device="cpu")
        model.load_state_dict(state)
        with torch.no_grad():
            got[cap] = model({k_: torch.from_numpy(v)
                              for k_, v in sample.items()})[2][
                "pos_correction"]
    want = got[cfg["tap_cache_max_elems"]]
    assert float((got[1 << 30] - want).abs().max()) \
        > 1e-3 * float(want.abs().max())
    for world in (2, 3):
        ranks = runs(world)
        assert all(r["global_sizes"]["gathers"] > 0 for r in ranks)
