"""Every shipped config in the port, and the options that unblocked the
last of them, against the JAX package on the CPU:

- every file under ``configs/`` builds (``build_model``);
- ``grav_eqvar`` (``configs/WBC-SPH.yml``): ``ops.sph.align_vector``, the
  model's ``transform``/``inv_transform`` rotation, a narrow WBC-SPH step
  and rollout with bridged weights on a scene whose gravity is turned,
  and the data path's alignment (``get_rollout``, ``WindowSampler``);
- ``k_chunk`` (``configs/Liquid3d.yml``): the model with its K-list convs
  chunked every 24 slots and no cached taps (the JAX package's
  ``TestKChunkedConv`` setup) at both precisions, and the layer's chunks;
- the port's bench reports the voxel pyramid's fit.

Tolerances: rotations 1e-6 (fp32 norms and products summed in another
order); the data path exactly (numpy both sides); model outputs as in
``test_torch_model.py`` (position correction 1e-5 of its max at
"highest", positions 1e-6, velocities 1e-4) and 2e-3 of the correction's
max at the default precision (a bf16 T can flip by one bf16 step where
the sums' order differs); the chunked conv at "highest" within 1e-6 of
the unchunked one (fp32 sums in another order), while at the default
precision each chunk rounds its own T.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dmcf_tpu.data import dataflow as jflow
from dmcf_tpu.data import generators as jgen
from dmcf_tpu.models import build_model as jax_build_model
from dmcf_tpu.ops import sph as jsph
from dmcf_tpu_torch import bench
from dmcf_tpu_torch.data import dataflow, dataset
from dmcf_tpu_torch.interop import params_from_flax
from dmcf_tpu_torch.models import build_model
from dmcf_tpu_torch.models.layers import ContinuousConv
from dmcf_tpu_torch.ops import neighbors, sph
from dmcf_tpu_torch.ops import cconv as tcc
from dmcf_tpu_torch.ops.windows import get_window_func
from dmcf_tpu_torch.rollout import rollout
from dmcf_tpu_torch.scene import bench_sample, build_scene

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
CONFIGS = sorted(glob.glob(os.path.join(CONFIG_DIR, "*.yml"))
                 + glob.glob(os.path.join(CONFIG_DIR, "*", "*.yml")))


def model_cfg(name):
    with open(os.path.join(CONFIG_DIR, name)) as f:
        return yaml.safe_load(f)["model"]


def to_jax(sample):
    return {k: jnp.asarray(v.numpy()) for k, v in sample.items()}


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.relpath(p, CONFIG_DIR)
                              for p in CONFIGS])
def test_every_config_builds_on_cpu(path):
    with open(path) as f:
        cfg = yaml.safe_load(f)["model"]
    model = build_model(cfg, device="cpu")
    assert type(model).__name__ == cfg["name"]
    assert sum(p.numel() for p in model.parameters()) > 0


def test_eleven_shipped_configs():
    assert len(CONFIGS) == 11


@pytest.mark.parametrize("v1", [
    [0.0, -9.81, 0.0], [4.905, -8.496, 0.0], [0.3, 0.2, -0.9],
    [0.0, 2.0, 0.0]], ids=["aligned", "30deg", "oblique", "antiparallel"])
def test_align_vector_matches_jax(v1):
    v0 = np.array([0.0, -1.0, 0.0], np.float32)
    v1 = np.array(v1, np.float32)
    want = np.asarray(jsph.align_vector(jnp.asarray(v0), jnp.asarray(v1)))
    got = sph.align_vector(torch.from_numpy(v0), torch.from_numpy(v1))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_allclose(dataflow.align_vector_np(v0, v1),
                               jflow.align_vector_np(v0, v1), atol=0)
    # v0 taken to v1's direction
    np.testing.assert_allclose(got.numpy() @ v0,
                               v1 / np.linalg.norm(v1), atol=1e-6)


def turned_scene(n_fluid=200, degrees=30.0):
    """The bench scene (spacing 0.01) jittered by 0.002, with its gravity
    turned by ``degrees`` in the x-y plane.  On the unjittered lattice
    the ASCC output cancels to ~1e-6 of its terms, and fp32 sums in
    another order are then 1e-4 of it (measured); jittered, the
    correction is ~650 times larger and the ports agree to 1e-6 of it."""
    pos, box, nrm = build_scene(n_fluid)
    pos[:, :2] -= 0.04  # the lowest rows within the finest radius of the
    #                     floor
    pos[:, :2] += np.random.RandomState(1).normal(
        scale=0.002, size=pos[:, :2].shape).astype(np.float32)
    sample = bench_sample(pos, box, nrm, device="cpu")
    a = np.deg2rad(degrees)
    g = 9.81 * np.array([np.sin(a), -np.cos(a), 0.0], np.float32)
    sample["grav"] = torch.from_numpy(
        np.broadcast_to(g, sample["pos"].shape).copy())
    return sample


def wbc_cfg():
    """configs/WBC-SPH.yml (grav_eqvar) at narrow widths."""
    cfg = model_cfg("WBC-SPH.yml")
    cfg.update(kernel_size=[1, 4, 4], sym_kernel_size=[1, 4, 4],
               precision="highest", out_scale=[1e-2, 1e-2, 0.0],
               layer_channels=[[[4]], [[8], [4], [4], [4]],
                               [[8], [4], [4], [4]], [[8]], [[2]]])
    return cfg


@pytest.fixture(scope="module")
def wbc():
    cfg = wbc_cfg()
    sample = turned_scene()
    jsample = to_jax(sample)
    jmodel = jax_build_model(cfg)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda key, s: jmodel.init(key, s, training=False))(
            jax.random.PRNGKey(0), jsample))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_flax(params))
    return dict(cfg=cfg, sample=sample, jsample=jsample, jmodel=jmodel,
                params=params, model=model)


def test_grav_eqvar_transform_matches_jax(wbc):
    js, jR = wbc["jmodel"].apply(wbc["params"], wbc["jsample"],
                                 method=lambda m, s: m.transform(s))
    ts, tR = wbc["model"].transform(wbc["sample"])
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-6)
    fm = wbc["sample"]["fluid_mask"].numpy()
    for k in ("pos", "vel", "grav", "box", "box_normals"):
        got, want = ts[k].numpy(), np.asarray(js[k])
        if k in ("pos", "vel", "grav"):
            got, want = got[fm], want[fm]
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=k)
    # gravity now points along the configured vector
    g = ts["grav"][0].numpy()
    np.testing.assert_allclose(g / np.linalg.norm(g), [0.0, -1.0, 0.0],
                               atol=1e-6)
    jp, jv = wbc["jmodel"].apply(
        wbc["params"], js["pos"], js["vel"], jR,
        method=lambda m, p, v, r: m.inv_transform(p, v, r))
    tp, tv = wbc["model"].inv_transform(ts["pos"], ts["vel"], tR)
    np.testing.assert_allclose(tp.numpy()[fm], np.asarray(jp)[fm],
                               atol=1e-6)
    np.testing.assert_allclose(tp.numpy()[fm],
                               wbc["sample"]["pos"].numpy()[fm], atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)


def _check_step(jout, tout):
    jp, jv, jaux = jout
    tp, tv, taux = tout
    pc_j = np.asarray(jaux["pos_correction"])
    scale = np.abs(pc_j).max()
    assert scale > 0
    np.testing.assert_allclose(taux["pos_correction"].numpy(), pc_j,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)
    for k in ("neighbor_overflow", "pair_overflow", "scale_counts",
              "scale_caps"):
        np.testing.assert_array_equal(taux[k].numpy(), np.asarray(jaux[k]),
                                      err_msg=k)


def test_grav_eqvar_step_and_rollout_match_jax(wbc):
    step = jax.jit(lambda p, s: wbc["jmodel"].apply(p, s, training=False))
    jout = step(wbc["params"], wbc["jsample"])
    with torch.no_grad():
        tout = wbc["model"](wbc["sample"])
    _check_step(jout, tout)
    # three steps on from there
    js, ts = dict(wbc["jsample"]), dict(wbc["sample"])
    for _ in range(3):
        jp, jv, _ = step(wbc["params"], js)
        js["pos"], js["vel"] = jp, jv
    tp, _, gate = rollout(wbc["model"], ts, 3)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=2e-6)
    assert gate["exact"]


def test_grav_eqvar_output_turns_with_the_scene(wbc):
    """The model sees every turned copy of a scene in one frame: the step
    of the turned scene, turned back, is the step of the scene."""
    model = wbc["model"]
    upright = turned_scene(degrees=0.0)
    turned = turned_scene(degrees=30.0)
    a = np.deg2rad(30.0)
    # row vectors times rot: turned counterclockwise by 30 degrees, as
    # turned_scene turns gravity
    rot = torch.tensor([[np.cos(a), np.sin(a), 0.0],
                        [-np.sin(a), np.cos(a), 0.0],
                        [0.0, 0.0, 1.0]], dtype=torch.float32)
    fm = upright["fluid_mask"]
    turned["pos"] = torch.where(fm[:, None], upright["pos"] @ rot,
                                upright["pos"])
    for k in ("box", "box_normals"):
        turned[k] = upright[k] @ rot
    with torch.no_grad():
        pu, _, au = model(upright)
        pt, _, _ = model(turned)
    back = pt[fm] @ rot.T
    np.testing.assert_allclose(back.numpy(), pu[fm].numpy(), atol=2e-6)
    assert float(au["pos_correction"].abs().max()) > 0


def test_grav_eqvar_data_paths_match_jax():
    scenes = jgen.gen_free_fall_data(data_cnt=2, timesteps=6, radius=6)
    g = np.array([3.0, -8.0, 0.0])
    for sc in scenes:
        for f in sc:
            f["grav"] = g / 100.0
    kw = dict(grav_eqvar=[0, -1, 0], translate=[0.1, 0.0, 0.0],
              scale=[1.0, 1.0, 0.0])
    got = dataflow.get_rollout(dataset.Dataset(scenes), **kw)
    want = jflow.get_rollout(dataset.Dataset(scenes), **kw)
    for g_, w_ in zip(got, want):
        assert set(g_) == set(w_)
        for k in w_:
            np.testing.assert_array_equal(g_[k], w_[k], err_msg=k)
    tw = dataflow.WindowSampler(dataset.Dataset(scenes), window=2, seed=3,
                                shuffle=True, **kw)
    jw = jflow.WindowSampler(dataset.Dataset(scenes), window=2, seed=3,
                             shuffle=True, **kw)
    for g_, w_ in zip(tw, jw):
        for k in w_:
            np.testing.assert_array_equal(g_[k], w_[k], err_msg=k)


def klist_sample(n=96, n_valid=80, b=24, b_valid=16, seed=13):
    """The JAX package's ``make_sample`` scene of ``TestKChunkedConv``
    (3D, random points, padded), as the port's padded sample."""
    rng = np.random.RandomState(seed)
    pos = np.zeros((n, 3), np.float32)
    pos[:n_valid] = rng.uniform(-0.2, 0.2, (n_valid, 3))
    vel = np.zeros((n, 3), np.float32)
    vel[:n_valid] = rng.randn(n_valid, 3) * 0.01
    box = np.zeros((b, 3), np.float32)
    box[:b_valid] = rng.uniform(-0.3, 0.3, (b_valid, 3))
    normals = np.zeros((b, 3), np.float32)
    normals[:b_valid, 1] = 1.0
    fluid_mask = torch.from_numpy(np.arange(n) < n_valid)
    g = np.zeros((n, 3), np.float32)
    g[:, 1] = -9.81
    return {
        "pos": sph.masked_positions(torch.from_numpy(pos), fluid_mask),
        "vel": torch.from_numpy(vel), "box": torch.from_numpy(box),
        "box_normals": torch.from_numpy(normals), "fluid_mask": fluid_mask,
        "box_mask": torch.from_numpy(np.arange(b) < b_valid),
        "grav": torch.from_numpy(g)}


def k_chunk_cfg(prec, chunk=24):
    cfg = model_cfg("Liquid3d.yml")
    # narrower than the config (its kernel sizes, budgets and depth)
    cfg.update(neighbor_k_pairs=[[32, 48, 96], [32, 32, 64], [32, 32, 32]],
               conv_k_chunk=chunk, tap_cache_max_elems=0, precision=prec,
               layer_channels=[[[4]], [[8], [4], [4]], [[8], [4], [4]],
                               [[8]], [[3]]])
    return cfg


@pytest.mark.parametrize("prec", ["highest", "default"])
def test_k_chunk_model_matches_jax(prec):
    """At the default the chunked correction lies 3.4e-7 of its max from
    JAX's (measured; tolerance 2e-6), while rounding T once over all of K
    instead of once a chunk moves it by 4.9e-5 and the fp32 path by 1.7e-4
    (measured): both are held apart here."""
    cfg = k_chunk_cfg(prec)
    sample = klist_sample()
    jsample = to_jax(sample)
    jmodel = jax_build_model(cfg)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda key, s: jmodel.init(key, s, training=False))(
            jax.random.PRNGKey(3), jsample))
    jout = jax.jit(lambda p, s: jmodel.apply(p, s, training=False))(
        params, jsample)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_flax(params))
    calls = []
    real = tcc.cconv_klist

    def counting(idx, *args, **kw):
        calls.append(idx.shape[1])
        return real(idx, *args, **kw)

    tcc.cconv_klist = counting
    try:
        with torch.no_grad():
            tout = model(sample)
    finally:
        tcc.cconv_klist = real
    if prec == "highest":
        _check_step(jout, tout)
    else:
        pc_j = np.asarray(jout[2]["pos_correction"])
        scale = np.abs(pc_j).max()
        got = tout[2]["pos_correction"]
        np.testing.assert_allclose(got.numpy(), pc_j, atol=2e-6 * scale)
        np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                                   atol=1e-6)
        # each chunk's T is rounded to bf16 on its own, at bf16
        for other in (k_chunk_cfg("default", chunk=0),
                      k_chunk_cfg("highest")):
            ref = build_model(other, device="cpu")
            ref.load_state_dict(model.state_dict())
            with torch.no_grad():
                alt = ref(sample)[2]["pos_correction"]
            assert float((got - alt).abs().max()) > 2e-5 * scale
    # every K-list conv ran in chunks of at most 24 slots
    assert calls and max(calls) <= 24
    assert len(calls) > 19


def test_k_chunk_layer_sums_its_chunks():
    rng = np.random.RandomState(0)
    pts = torch.from_numpy(rng.uniform(-0.2, 0.2, (128, 3)).astype(
        np.float32))
    feats = torch.from_numpy(rng.randn(128, 4).astype(np.float32))
    nl = neighbors.fixed_radius_search(pts, pts, 0.2, 100)
    assert int(nl.count.max()) > 48
    gen = torch.Generator().manual_seed(0)
    kw = dict(window_function=get_window_func("poly6"), device="cpu",
              precision="highest")
    full = ContinuousConv(4, 5, (4, 4, 4), generator=gen, **kw)
    chunked = ContinuousConv(4, 5, (4, 4, 4), k_chunk=24, **kw)
    chunked.load_state_dict(full.state_dict())
    want = full(feats, pts, pts, 0.4, nl)
    got = chunked(feats, pts, pts, 0.4, nl)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    # cached taps are never chunked (the reference's rule)
    assert torch.equal(chunked(feats, pts, pts, 0.4, nl, cached_taps=True),
                       want)


def test_bench_reports_the_pyramid_fit(capsys):
    assert bench.main(["--device", "cpu", "--steps", "5", "--n_fluid",
                       "256"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    d = line["detail"]
    assert len(d["scale_counts"]) == len(d["scale_caps"]) == 3
    assert d["scales_fit"] == all(c <= k for c, k in zip(d["scale_counts"],
                                                         d["scale_caps"]))
    assert d["exact"] is True


def test_liquid3d_pyramid_matches_jax():
    """``chip_smoke.py``'s Liquid3d scene: the JAX package and the port
    build the same voxel pyramid from the first step's advected positions
    (``scripts/liquid_pyramid.py``), and both overflow scale 1's cap, so
    the smoke's Liquid3d figures are those of a cut pyramid in either."""
    from scripts.liquid_pyramid import pyramids

    jax_counts, port_counts, caps = pyramids()
    assert port_counts == jax_counts
    assert jax_counts[1] > caps[1]
