"""The port's evaluation pipeline against the JAX package's on the CPU:
EMD, SPH density and the density losses, nearest-neighbour and numpy
metrics, then ``Simulator.run_rollout`` / ``run_valid`` / ``run_test`` with
weights carried from the flax tree (``interop.params_from_flax``), the
boundary-bbox clip of the valid suite (ROADMAP §3), and the port's
``run_pipeline`` and ``bench`` entry points.

JAX models are built with ``precision: highest`` (the port is fp32).
Tolerances: 1e-5 for the op-level comparisons (fp32, reductions in another
order); trajectories 1e-5 absolute; valid metrics 1e-4 relative (plus 1e-7
absolute for metrics at round-off size), since they sum per-frame fp32
numbers computed in another order over many frames.
"""

import os
import types

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dmcf_tpu.data import Dataset as JDataset
from dmcf_tpu.data import get_rollout as jget_rollout
from dmcf_tpu.data.generators import gen_momentum_data
from dmcf_tpu.models import build_model as jbuild_model
from dmcf_tpu.models.hrnet import HRNet as JHRNet
from dmcf_tpu.models.losses import density_loss as jdensity_loss
from dmcf_tpu.ops import emd as jemd
from dmcf_tpu.ops import sph as jsph
from dmcf_tpu.ops.windows import get_window_func as jwindow
from dmcf_tpu.pipelines import metrics as jmetrics
from dmcf_tpu.pipelines.simulator import Simulator as JSimulator
from dmcf_tpu_torch import bench, run_pipeline
from dmcf_tpu_torch.data import Dataset
from dmcf_tpu_torch.interop import params_from_flax
from dmcf_tpu_torch.models import build_model
from dmcf_tpu_torch.models.hrnet import HRNet
from dmcf_tpu_torch.models.losses import density_loss
from dmcf_tpu_torch.ops import emd, sph
from dmcf_tpu_torch.ops.windows import get_window_func
from dmcf_tpu_torch.pipelines import Simulator, metrics
from tests.test_pipeline import _make_scenes

ROOT = os.path.join(os.path.dirname(__file__), "..")
MOMENTUM = os.path.join(ROOT, "configs", "other", "momentum.yml")
T = torch.from_numpy
J = jnp.asarray

FULL_KEYS = {"mse_val", "chamfer_val", "chamfer_val_2", "dens_val",
             "max_dens_val", "emd", "vel_diff_val", "vel_diff_val_2",
             "mse_single_val", "loss"}


def cloud(rng, n, lo=-0.2, hi=0.2):
    return rng.uniform(lo, hi, (n, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# ops


@pytest.mark.parametrize("n_true,m_true,N,M", [
    (40, 40, 40, 40), (40, 25, 48, 32), (17, 45, 24, 64)])
def test_emd_matches_jax(n_true, m_true, N, M):
    rng = np.random.RandomState(n_true + m_true)
    x = np.stack([cloud(rng, N, 0.0, 0.3), cloud(rng, N, 0.0, 0.3)])
    y = np.stack([cloud(rng, M, 0.05, 0.35), cloud(rng, M, 0.0, 0.3)])
    n = np.array([n_true, N], np.int32)
    m = np.array([m_true, M], np.int32)
    got = emd.emd_loss(T(x), T(y), n=T(n), m=T(m)).numpy()
    want = np.asarray(jemd.emd_loss(J(x), J(y), n=J(n), m=J(m)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    match = emd.approx_match(T(x), T(y), T(n), T(m)).numpy()
    jmatch = np.asarray(jemd.approx_match(J(x), J(y), J(n), J(m)))
    np.testing.assert_allclose(match, jmatch, atol=1e-5)
    # padded rows take no mass on either side
    assert not match[0, m_true:, :].any() and not match[0, :, n_true:].any()
    np.testing.assert_allclose(
        emd.approx_vel(T(x), T(y), T(n), T(m)).numpy(),
        np.asarray(jemd.approx_vel(J(x), J(y), J(n), J(m))), atol=1e-5)


@pytest.mark.parametrize("win", [None, "poly6", "cubic"])
def test_compute_density_matches_jax(win):
    rng = np.random.RandomState(1)
    out_pos, in_pos = cloud(rng, 70), cloud(rng, 90)
    om, im = rng.rand(70) < 0.8, rng.rand(90) < 0.9
    got = sph.compute_density(T(out_pos), T(in_pos), 0.08,
                              get_window_func(win), out_mask=T(om),
                              in_mask=T(im), k=24).numpy()
    want = np.asarray(jsph.compute_density(
        J(out_pos), J(in_pos), 0.08, jwindow(win), out_mask=J(om),
        in_mask=J(im), k=24))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("use_max", [False, True])
def test_density_loss_matches_jax(use_max):
    rng = np.random.RandomState(2)
    gt, box = cloud(rng, 64), cloud(rng, 16)
    # a compressed prediction: denser than the ground truth's densest
    pred = (0.8 * gt + rng.normal(scale=0.01, size=gt.shape)).astype(
        np.float32)
    mask = np.arange(64) < 57
    bmask = np.arange(16) < 12
    allm = np.concatenate([mask, bmask])
    args = dict(radius=0.06, use_max=use_max, k=32, eps=0.01)
    got = density_loss(
        T(gt), T(pred), T(mask), T(mask),
        gt_in=T(np.concatenate([pred, box])),
        pred_in=T(np.concatenate([gt, box])), gt_in_mask=T(allm),
        pred_in_mask=T(allm), win=get_window_func("poly6"), **args)
    want = jdensity_loss(
        J(gt), J(pred), J(mask), J(mask),
        gt_in=J(np.concatenate([pred, box])),
        pred_in=J(np.concatenate([gt, box])), gt_in_mask=J(allm),
        pred_in_mask=J(allm), win=jwindow("poly6"), **args)
    assert float(want) > 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    # own in-sets, no window (the identity)
    plain = density_loss(T(gt), T(pred), T(mask), T(mask), **args)
    jplain = jdensity_loss(J(gt), J(pred), J(mask), J(mask), **args)
    np.testing.assert_allclose(float(plain), float(jplain), rtol=1e-5,
                               atol=1e-7)


def test_nn_distance_matches_jax():
    rng = np.random.RandomState(3)
    a, b = cloud(rng, 50), cloud(rng, 40)
    am, bm = rng.rand(50) < 0.8, rng.rand(40) < 0.7
    for masks in ((None, None), (am, bm)):
        got = sph.nn_distance(T(a), T(b), *(None if x is None else T(x)
                                            for x in masks))
        want = jsph.nn_distance(J(a), J(b), *(None if x is None else J(x)
                                              for x in masks))
        for g, w in zip(got, want):
            if g.dtype == torch.int32:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           atol=1e-5)


def test_numpy_metrics_match_jax():
    rng = np.random.RandomState(4)
    x, y = cloud(rng, 300), cloud(rng, 300)
    np.testing.assert_array_equal(metrics.chamfer_distance(x, y),
                                  jmetrics.chamfer_distance(x, y))
    np.testing.assert_array_equal(metrics.distance(x, y),
                                  jmetrics.distance(x, y))
    assert metrics.compare_dist(x, y) == jmetrics.compare_dist(x, y)
    assert metrics.compare_dist(x[:, :2], y[:, :2], bin_size=5) == \
        jmetrics.compare_dist(x[:, :2], y[:, :2], bin_size=5)


# ---------------------------------------------------------------------------
# the Simulator


def hrnet_kwargs():
    return dict(particle_radii=(0.1,), strides=(1,),
                layer_channels=(((4,),), ((3,),)), kernel_size=(2, 2, 2),
                neighbor_k=16, window="poly6", window_dens="cubic",
                timestep=0.01, voxel_size=(0.05, 0.05, 0.05))


def pipe_kwargs(tmp_path, tag, **over):
    kw = dict(name="Simulator", main_log_dir=str(tmp_path / tag / "logs"),
              train_sum_dir=str(tmp_path / tag / "sum"),
              output_dir=str(tmp_path / tag / "out"), seed=42,
              data_generator={"valid": {}, "test": {}})
    kw.update(over)
    return kw


def simulators(tmp_path, scenes, jmodel, model, **over):
    """A JAX and a port Simulator over the same scenes; the port's model
    carries the JAX pipeline's initial weights."""
    jgroup = types.SimpleNamespace(train=None, valid=JDataset(scenes),
                                   test=JDataset(scenes), name="vm")
    group = types.SimpleNamespace(train=None, valid=Dataset(scenes),
                                  test=Dataset(scenes), name="vm")
    jpipe = JSimulator(jmodel, dataset=jgroup,
                       **pipe_kwargs(tmp_path, "jax", **over))
    jpipe.params = jpipe._init_params_from_rollout(
        jget_rollout(jgroup.valid)[0])
    model.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, jpipe.params)))
    pipe = Simulator(model, dataset=group, device="cpu",
                     **pipe_kwargs(tmp_path, "port", **over))
    return jpipe, pipe


@pytest.fixture(scope="module")
def hrnet_pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hrnet")
    scenes = _make_scenes(n_scenes=2, frames=8, n=6)
    jmodel = JHRNet(precision="highest", **hrnet_kwargs())
    model = HRNet(device="cpu", **hrnet_kwargs())
    return simulators(tmp, scenes, jmodel, model)


def rel_close(got, want, rtol=1e-4, atol=1e-7):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("chunk", [0, 3])
def test_run_rollout_matches_jax(hrnet_pair, chunk):
    jpipe, pipe = hrnet_pair
    data = jget_rollout(jpipe.dataset.valid)
    want = jpipe.run_rollout(data, 8)
    pipe.cfg.cfg_dict["rollout_chunk"] = chunk
    try:
        got = pipe.run_rollout(data, 8)
    finally:
        pipe.cfg.cfg_dict["rollout_chunk"] = 0
    for (gp, gv), (wp, wv) in zip(got, want):
        assert gp.shape == wp.shape == (8, 6, 3)
        np.testing.assert_allclose(gp, wp, atol=1e-5)
        np.testing.assert_allclose(gv, wv, atol=1e-4)
    if chunk:
        whole = pipe.run_rollout(data, 8)
        for (gp, gv), (hp, hv) in zip(got, whole):
            np.testing.assert_array_equal(gp, hp)
            np.testing.assert_array_equal(gv, hv)


def test_run_inference_matches_jax(hrnet_pair):
    from dmcf_tpu.data import pad_rollout_state

    jpipe, pipe = hrnet_pair
    st = pad_rollout_state(jget_rollout(jpipe.dataset.valid)[1], bucket=8)
    state = {k: st[k][2] if k in ("pos", "vel", "grav") else st[k]
             for k in ("pos", "vel", "grav", "box", "box_normals",
                       "fluid_mask", "box_mask")}
    want = jpipe.run_inference({k: J(v) for k, v in state.items()})
    got = pipe.run_inference({k: T(np.ascontiguousarray(v))
                              for k, v in state.items()})
    np.testing.assert_allclose(got["pos"].numpy(), np.asarray(want["pos"]),
                               atol=1e-5)
    np.testing.assert_allclose(got["vel"].numpy(), np.asarray(want["vel"]),
                               atol=1e-4)
    assert got["box"] is not None and "n_fluid" not in got


@pytest.mark.parametrize("full", [True, False], ids=["full", "subset"])
def test_run_valid_matches_jax(hrnet_pair, full):
    jpipe, pipe = hrnet_pair
    for p in (jpipe, pipe):
        p.cfg.cfg_dict["valid_full_metrics"] = full
    want = jpipe.run_valid(epoch=0)
    got = pipe.run_valid(epoch=0)
    assert set(got) == (FULL_KEYS if full else
                        {"mse_val", "chamfer_val", "mse_single_val", "loss"})
    assert all(np.isfinite(v) for v in got.values())
    rel_close(got, want)


def test_max_density_reads_window_dens(hrnet_pair):
    """``max_dens_val`` scores with the model's ``window_dens`` (cubic
    here), which the port's model keeps, as JAX's does."""
    jpipe, pipe = hrnet_pair
    data = jget_rollout(jpipe.dataset.valid)[0]
    (ps, _), = jpipe.run_rollout([data], 8)
    want = jpipe._seq_device_metrics(data, ps, True)
    got = pipe._seq_device_metrics(data, ps, True)
    rel_close(got, want)
    assert pipe.model.window_dens == "cubic"
    pipe.model.window_dens = None
    try:
        other = pipe._seq_device_metrics(data, ps, True)
    finally:
        pipe.model.window_dens = "cubic"
    assert np.abs(other["max_dens_val"] - got["max_dens_val"]).max() > 1e-3


def test_run_test_writes_the_same_hdf5(hrnet_pair):
    jpipe, pipe = hrnet_pair
    jpipe.run_test(epoch=3)
    pipe.run_test(epoch=3)
    for i in range(2):
        paths = [os.path.join(p.cfg.out_dir, "visual", "%04d" % i,
                              "0003.hdf5") for p in (pipe, jpipe)]
        with h5py.File(paths[0]) as got, h5py.File(paths[1]) as want:
            assert list(got) == list(want) == ["HRNet"]
            assert list(got["HRNet"]) == list(want["HRNet"])
            for name in want["HRNet"]:
                g, w = got["HRNet"][name], want["HRNet"][name]
                assert dict(g.attrs).keys() == dict(w.attrs).keys()
                assert g.attrs["type"] == w.attrs["type"]
                np.testing.assert_array_equal(g.attrs["dim"], w.attrs["dim"])
                assert g.dtype == w.dtype
                np.testing.assert_allclose(g[()], w[()], atol=1e-5)


def narrow_momentum_cfg(tmp_path):
    with open(MOMENTUM) as f:
        cfg = yaml.safe_load(f)
    cfg["model"].update(kernel_size=[1, 4, 4], sym_kernel_size=[1, 4, 4],
                        strides=[1], particle_radii=[0.02],
                        scale_size_factor=[1.0], precision="highest",
                        out_scale=[1e-2, 1e-2, 0.0],
                        layer_channels=[[[4]], [[4]], [[2]]])
    return cfg


def test_bbox_clip_makes_clipped_metrics_model_independent(tmp_path):
    """ROADMAP §3: a momentum scene's one boundary point is its bbox, so
    every clipped prediction sits on it and ``mse_val`` is the same for
    two weight sets, while ``mse_single_val`` (not clipped) differs; in
    both packages.  The data are scaled by 0.9 so the finest radius holds
    neighbours and the correction is not 0."""
    cfg = narrow_momentum_cfg(tmp_path)
    np.random.seed(43)
    scenes = gen_momentum_data(data_cnt=1, timesteps=4, res=100, radius=12,
                               dt=0.0025, speed=30.0)
    dg = {"scale": [0.9, 0.9, 0.0], "valid": {"time_end": 4}}
    jpipe, pipe = simulators(tmp_path, scenes, jbuild_model(cfg["model"]),
                             build_model(cfg["model"], device="cpu"),
                             data_generator=dg, valid_full_metrics=True)
    results = []
    for scale in (1.0, 1.5):  # two weight sets: as drawn, and scaled
        jpipe.params = jax.tree.map(lambda x: x * scale, jpipe.params)
        pipe.model.load_state_dict(params_from_flax(
            jax.tree.map(np.asarray, jpipe.params)))
        results.append((jpipe.run_valid(epoch=0), pipe.run_valid(epoch=0)))
    for want, got in results:
        rel_close(got, want)
    (j0, t0), (j1, t1) = results
    for a, b in ((j0, j1), (t0, t1)):
        assert a["mse_val"] == b["mse_val"]
        assert a["emd"] == b["emd"] and a["chamfer_val"] == b["chamfer_val"]
        assert abs(a["mse_single_val"] - b["mse_single_val"]) > 1e-3 * abs(
            a["mse_single_val"])


def test_momentum_config_correction_is_zero():
    """ROADMAP §3: at configs/other/momentum.yml's own widths the finest
    radius (0.02) is below the generator's spacing (0.020625): each
    particle's only neighbour at that radius is itself, in both packages'
    searches, so the ASCC layer (coincident points dropped) sees none and
    the port's correction is exactly 0 whatever the weights."""
    from dmcf_tpu.data import pad_rollout_state
    from dmcf_tpu.ops.neighbors import fixed_radius_search

    with open(MOMENTUM) as f:
        mcfg = yaml.safe_load(f)["model"]
    scenes = gen_momentum_data(data_cnt=1, timesteps=1, res=100, radius=12)
    seq = jget_rollout(JDataset(scenes), scale=[1.0, 1.0, 0.0])[0]
    st = pad_rollout_state(seq)
    pos = st["pos"][0][st["fluid_mask"]]
    nl = fixed_radius_search(J(pos), J(pos), mcfg["particle_radii"][0], 8)
    assert np.asarray(nl.count).max() == 1
    s = {k: T(np.ascontiguousarray(st[k][0] if k in ("pos", "vel", "grav")
                                   else st[k]))
         for k in ("pos", "vel", "grav", "box", "box_normals", "fluid_mask",
                   "box_mask")}
    for seed in (0, 1):
        model = build_model(mcfg, device="cpu",
                            generator=torch.Generator().manual_seed(seed))
        with torch.no_grad():
            _, _, aux = model(s)
        assert int(aux["neighbor_overflow"]) == 1
        assert not aux["pos_correction"].any()


# ---------------------------------------------------------------------------
# entry points


def test_run_pipeline_valid_on_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    loss = run_pipeline.main([
        "--cfg_file", MOMENTUM, "--split", "valid", "--device", "cpu",
        "--main_log_dir", "logs", "--output_dir", "out",
        "--pipeline.train_sum_dir", "sum", "--dataset.valid.data_cnt", "1",
        "--dataset.valid.timesteps", "2",
        "--pipeline.data_generator.valid.time_end", "2"])
    assert set(loss) == FULL_KEYS
    assert all(np.isfinite(v) for v in loss.values())
    assert os.listdir(tmp_path / "cache")


def test_bench_fields_on_a_small_cpu_scene():
    result = bench.run(device="cpu", steps=1, n_fluid=64)
    assert result["metric"] == "WaterRamps_SymNet_rollout_steps_per_sec"
    assert result["unit"] == "steps/s" and result["value"] > 0
    d = result["detail"]
    assert {"exact", "horizon", "n_fluid", "n_boundary", "ms_per_step",
            "finite", "device", "power_limit", "max_neighbors",
            "neighbor_k", "pair_overflow", "flops_per_step", "mfu_pct",
            "canyon", "baseline_assumption_steps_per_sec"} <= set(d)
    assert d["exact"] and d["finite"] and d["device"] == "cpu"
    assert d["horizon"] == 1 and d["n_fluid"] == 64
    assert d["canyon"] is None and d["mfu_pct"] is None
    assert result["vs_baseline"] == round(result["value"] / 20.0, 2)


def test_entry_points_raise_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.run(steps=1, n_fluid=64)
    with pytest.raises(RuntimeError, match="cuda"):
        run_pipeline.main(["--cfg_file", MOMENTUM, "--split", "valid"])
    with pytest.raises(RuntimeError, match="cuda"):
        Simulator(HRNet(device="cpu", **hrnet_kwargs()),
                  **pipe_kwargs(tmp_path, "gpu"))
