"""The port's column generator (``dmcf_tpu_torch.data.generators``: SPH1D
setup, ``column_solve_reference``, ``_column_frames``, ``gen_column_data``)
against the JAX package's, on the CPU, and the column configs end to end
through ``run_pipeline``.

Tolerance of the solver (positions and velocities in the solver's units,
h = 1, |x| <= 21, |v| <= 20): the two solvers do the same fp32 operations
but sum each particle's pairs in another order (the port over 64
zero-padded slots in a fixed tree, JAX in XLA's order), and each
projection iteration feeds the next, so the difference grows with the
iterations.  At the sizes here (<= 5 frames, <= 200 iterations a frame)
positions agree to 1e-5 and velocities to 1e-3 (measured: at most 1.4e-6
in velocity).  At the configs' full size (100 frames of ~10,000
iterations) they drift much further apart; ``PERF.md`` has the figures and
the card's tolerance.  Frames, structure and cache keys agree exactly.
"""

import os
from functools import partial

import jax
import numpy as np
import pytest
import torch

from dmcf_tpu.data import dataset as jdataset
from dmcf_tpu.data import generators as jgen
from dmcf_tpu_torch import run_pipeline
from dmcf_tpu_torch.data import dataset, generators
from dmcf_tpu_torch.kernels.column_sph import (column_solve_reference,
                                               tree_sum)
from scripts import make_torch_column_ref as ref_script

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
HRNET = os.path.join(ROOT, "configs", "column", "hrnet.yml")
X_TOL, V_TOL = 1e-5, 1e-3
RES, DT = 100, 0.0025


def initial_state(counts, offset=0.0):
    """Each scene's particles as SPH1D sets them up, padded to one width."""
    solver = jgen.SPH1D(radius=0.25, mass=1.0, stiffness=20.0, visc=0.1,
                        gravity=-10.0 * RES)
    p = max(counts) + 2
    x0 = np.zeros((len(counts), p), np.float32)
    v0 = np.zeros_like(x0)
    for s, n in enumerate(counts):
        solver.setup(n, 2, offset=offset)
        x0[s, :n + 2] = solver.particles[:, 0]
        v0[s, :n + 2] = solver.particles[:, 1]
    return solver, x0, v0


@pytest.mark.parametrize("counts,timesteps,max_iter,offset", [
    ([1], 5, 200, 0.0),
    ([5], 4, 100, 0.0),
    ([40], 3, 20, 0.0),
    ([1, 5, 40], 3, 50, 0.0),
    ([5, 3], 5, 200, 10.0),
], ids=["n1", "n5", "n40", "batched", "free_fall_stops_early"])
def test_plain_solver_matches_jax(counts, timesteps, max_iter, offset):
    solver, x0, v0 = initial_state(counts, offset)
    kw = dict(bcnt=2, gravity=solver.gravity, rest_dens=solver.rest_dens,
              stiffness=20.0, visc=0.1, h=solver.h, timesteps=timesteps,
              dt=DT, max_iter=max_iter)
    xs, vs, iters, _ = column_solve_reference(
        torch.from_numpy(x0), torch.from_numpy(v0),
        torch.tensor([n + 2 for n in counts], dtype=torch.int32), **kw)
    jsolve = jax.jit(partial(jgen._column_solve_jax, **kw))
    for s, n in enumerate(counts):
        jx, jv = jsolve(x0[s, :n + 2], v0[s, :n + 2], np.float32(1.0))
        np.testing.assert_allclose(xs[s, :, :n + 2].numpy(), np.asarray(jx),
                                   rtol=0, atol=X_TOL)
        np.testing.assert_allclose(vs[s, :, :n + 2].numpy(), np.asarray(jv),
                                   rtol=0, atol=V_TOL)
        # padding stays zero
        assert not xs[s, :, n + 2:].any()
    it = iters.numpy()
    assert (it >= 1).all() and (it <= max_iter).all()
    if offset:
        # falling free, the columns are never over-dense: each projection
        # stops after its first iteration
        assert (it == 1).all()
    elif max(counts) >= 5:
        assert (it[np.argmax(counts)] == max_iter).all()


def test_plain_solver_counts_pairs_by_spline_arm():
    """The pair counts that the column bound reads: a frame's viscosity
    step sees the state the frame records, so its counts are those of the
    recorded positions exactly; every projection iteration counts each
    particle with itself (inner arm) and at most all of its pairs."""
    counts = [1, 5, 40]
    solver, x0, v0 = initial_state(counts)
    xs, _, iters, pairs = column_solve_reference(
        torch.from_numpy(x0), torch.from_numpy(v0),
        torch.tensor([n + 2 for n in counts], dtype=torch.int32), bcnt=2,
        gravity=solver.gravity, rest_dens=solver.rest_dens, stiffness=20.0,
        visc=0.1, h=solver.h, timesteps=4, dt=DT, max_iter=30)
    pairs, iters = pairs.numpy(), iters.numpy()
    for s, n in enumerate(counts):
        x = xs[s, :, :n + 2].numpy()
        q = np.abs(x[:, :, None] - x[:, None, :])
        np.testing.assert_array_equal(pairs[s, :, 0],
                                      (q <= 0.5).sum((1, 2)))
        np.testing.assert_array_equal(pairs[s, :, 1],
                                      ((q > 0.5) & (q <= 1.0)).sum((1, 2)))
        assert (pairs[s, :, 2] >= iters[s] * (n + 2)).all()
        assert (pairs[s, :, 2] + pairs[s, :, 3]
                <= iters[s] * (n + 2) ** 2).all()
    # at the rest spacing h/2 a particle meets its neighbours at q = 0.5
    # and q = 1.0: a 42-particle column has far fewer pairs in the
    # support than pairs in all
    assert pairs[2, 0, :2].sum() < 0.2 * 42 ** 2


def lane_tree_sum(x, lanes):
    """The column kernel's pair sum (``csrc/column_sph.cu``
    ``group_tree``) emulated on the CPU for a row spread over ``lanes``
    lanes: lane g holds the leaves of slots g + lanes * k; the tree's
    levels whose pairs lie in one lane (slot j with j + 32, ..., j +
    lanes) are added in the lane, then each lane adds the value lane
    g ^ off holds, for off = lanes / 2, ..., 1, its own value first as the
    kernel's ``add(s, shfl)``.  Returns every lane's result [..., lanes]."""
    leaf = x.reshape(*x.shape[:-1], 64 // lanes, lanes)  # [.., k, g]
    n = 64 // lanes // 2
    while n >= 1:
        leaf = leaf[..., :n, :] + leaf[..., n:2 * n, :]
        n //= 2
    s = leaf[..., 0, :]
    ids = torch.arange(lanes)
    off = lanes // 2
    while off:
        s = s + s[..., ids ^ off]
        off //= 2
    return s


@pytest.mark.parametrize("lanes", [32, 16, 8, 4, 2, 1])
def test_lane_layout_gives_tree_sum_bits(lanes):
    """The kernel spreads each 64-slot pair sum over a group of lanes (16
    in the kernel; every width here); that order is ``tree_sum``'s with
    some additions commuted, so every lane holds ``tree_sum``'s bits: on
    random fp32 rows over many magnitudes (where other orders round
    otherwise), with zeros, -0.0, +-inf and NaN leaves.  A NaN sum is
    compared as NaN (its payload may depend on the operand order, and the
    port keeps no NaN's payload)."""
    rng = np.random.RandomState(0)
    rows = (rng.randn(4096, 64) * 10.0 ** rng.randint(-6, 7, (4096, 64)))
    rows = rows.astype(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan], np.float32)
    for r in range(0, 4096, 4):  # a few special leaves in a quarter
        k = rng.randint(1, 4)
        rows[r, rng.randint(0, 64, k)] = rng.choice(special, k)
    rows[1] = 0.0
    rows[2] = -0.0                      # all -0.0: the sum is -0.0
    rows[3, :32], rows[3, 32:] = -0.0, 0.0
    x = torch.from_numpy(rows)
    want = tree_sum(x)
    got = lane_tree_sum(x, lanes)
    nan = torch.isnan(want)
    assert nan.any() and torch.isinf(want).any()
    for lane in range(lanes):
        g = got[:, lane]
        assert torch.equal(torch.isnan(g), nan), lane
        assert torch.equal(g[~nan].view(torch.int32),
                           want[~nan].view(torch.int32)), lane
    assert want[2].view(torch.int32) == torch.tensor(-0.0).view(torch.int32)
    # the test can tell orders apart: a left-to-right sum rounds otherwise
    seq = x[~nan].clone()
    acc = seq[:, 0]
    for j in range(1, 64):
        acc = acc + seq[:, j]
    assert not torch.equal(acc.view(torch.int32),
                           want[~nan].view(torch.int32))


def test_column_frames_match_jax():
    rng = np.random.RandomState(0)
    seq = rng.randn(4, 9, 2).astype(np.float32)
    for width, walls in ((1, False), (3, False), (5, True)):
        got = generators._column_frames(seq, 3, RES, 2, -1000.0, width,
                                        walls)
        want = jgen._column_frames(seq, 3, RES, 2, -1000.0, width, walls)
        assert_same_frames(got, want, exact=True)


def assert_same_frames(got, want, exact=False):
    """Scenes' frame lists equal: keys, ids, dtypes and shapes exactly; pos
    and vel within the solver tolerance (scaled by 1/res) unless
    ``exact``."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype and g[k].shape == \
                    w[k].shape, k
                if exact or k not in ("pos", "vel"):
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
                else:
                    tol = (X_TOL if k == "pos" else V_TOL) / RES
                    np.testing.assert_allclose(g[k], w[k], rtol=0, atol=tol,
                                               err_msg=k)
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("kw", [
    dict(data_cnt=3, timesteps=4, max_pts=12, offset=10.0),
    dict(data_cnt=2, timesteps=3, max_pts=6, rnd=0.1, offset=10.0),
    dict(data_cnt=2, timesteps=3, pts_cnt=[1, 5], width=5, side_walls=True,
         offset=10.0),
], ids=["sorted_counts", "random_counts_and_jitter", "wide_with_walls"])
def test_gen_column_data_matches_jax(kw):
    kw = dict(kw, dt=DT, res=RES)
    np.random.seed(7)
    got = generators.gen_column_data(**kw, device="cpu")
    after = np.random.rand()
    np.random.seed(7)
    want = jgen.gen_column_data(**kw)
    # the same draws, in the same order
    assert np.random.rand() == after
    for g, w in zip(got, want):
        assert_same_frames(g, w)


def column_cfg():
    """A tiny column dataset section: three splits of 2 scenes, a few
    frames, falling free (each projection stops at once)."""
    split = dict(min_pts=1, max_pts=6, data_cnt=2, timesteps=3, offset=10.0)
    return dict(name="Column2", type="column", res=RES, gravity=-10.0,
                dt=DT, train=dict(split, seed=42), valid=dict(split, seed=43),
                test=dict(split, seed=44))


def test_dataset_cache_key_and_data_match_jax(tmp_path):
    got = dataset.DatasetGroup(cache_dir=str(tmp_path / "port"),
                               device="cpu", **column_cfg())
    want = jdataset.DatasetGroup(cache_dir=str(tmp_path / "jax"),
                                 **column_cfg())
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))
    for split in ("train", "valid", "test"):
        g, w = getattr(got, split), getattr(want, split)
        for i in range(len(w)):
            assert_same_frames(g[i], w[i])
    # a second group reads the cached files
    again = dataset.DatasetGroup(cache_dir=str(tmp_path / "port"),
                                 device="cpu", **column_cfg())
    assert_same_frames(again.valid[0], got.valid[0], exact=True)


@pytest.mark.parametrize("split", ["train", "valid", "test"])
def test_run_pipeline_column_hrnet_on_cpu(split, tmp_path, monkeypatch):
    """``run_pipeline`` on ``configs/column/hrnet.yml`` on the CPU with the
    generator's plain solver, at test size (2 scenes a split, 5 frames,
    20 projection iterations a frame)."""
    monkeypatch.chdir(tmp_path)
    args = ["--cfg_file", HRNET, "--split", split, "--device", "cpu",
            "--main_log_dir", "logs", "--output_dir", "out",
            "--pipeline.train_sum_dir", "sum", "--dataset.cache_dir",
            "none", "--pipeline.max_epoch", "0", "--pipeline.iter", "2",
            "--pipeline.log_every", "1",
            "--pipeline.batch_size", "2",
            "--pipeline.run_valid_every_epoch", "false",
            "--pipeline.run_test_every_epoch", "false",
            "--pipeline.data_generator.valid.time_end", "4",
            "--pipeline.data_generator.valid.random_start", "1",
            "--model.precision", "highest"]
    for s in ("train", "valid", "test"):
        args += [f"--dataset.{s}.data_cnt", "2", f"--dataset.{s}.timesteps",
                 "5", f"--dataset.{s}.max_iter", "20"]
    args += ["--dataset.train.max_pts", "4", "--dataset.valid.max_pts", "4"]
    out = run_pipeline.main(args)
    if split == "train":
        assert [e["step"] for e in out] == [0, 1]
        assert all(np.isfinite(e["loss"]) for e in out)
    elif split == "valid":
        assert np.isfinite(out["loss"])
    else:
        assert any(f.endswith(".hdf5") for _, _, fs in os.walk("out")
                   for f in fs)


@pytest.mark.parametrize("scene", ["first", "largest", "largest_permuted"])
def test_column_fixture_is_what_jax_makes_today(scene):
    """``tests/data/torch_column_ref.npz`` (``scripts/
    make_torch_column_ref.py``): its counts are the split's first three
    under its seed, and its scene 0, its 40-particle scene and that
    scene's run in another particle order are the JAX solver's output
    now, at full size, bit for bit."""
    ref = np.load(os.path.join(ROOT, "tests", "data",
                               "torch_column_ref.npz"))
    cfg = ref_script.split_config()
    np.testing.assert_array_equal(ref["pts_cnt"], ref_script.pts_cnt(cfg))
    assert int(ref["timesteps"]) == cfg["timesteps"] == 100
    if scene == "first":
        n = int(ref["pts_cnt"][0]) + ref_script.OBS_SIZE
        xs, vs = ref_script.solve_scene(int(ref["pts_cnt"][0]), cfg)
        want = ref["xs"][0, :, :n], ref["vs"][0, :, :n]
        assert not ref["xs"][0, :, n:].any()
    else:
        perm = (ref_script.fluid_permutation(ref_script.LARGEST)
                if scene == "largest_permuted" else None)
        xs, vs = ref_script.solve_scene(ref_script.LARGEST, cfg, perm=perm)
        key = "40_perm" if perm is not None else "40"
        want = ref["xs" + key], ref["vs" + key]
    np.testing.assert_array_equal(want[0], xs)
    np.testing.assert_array_equal(want[1], vs)
