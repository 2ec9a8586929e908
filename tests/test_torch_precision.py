"""The port's bf16 trunk mode against the JAX package at its default
``precision="default"`` (JAX's ``fast_bf16`` contraction: taps, features,
T and the filter rounded to bf16, sums and outputs fp32), on the CPU.

The op and model cases also hold the port's fp32 path or JAX's
``"highest"`` against JAX's default, so that they fail if the port
computed fp32 where JAX computes bf16.
Tolerances (of each output's or gradient's max abs):
- conv outputs 1e-4 (sum orders before T's rounding can flip an element of
  T by one bf16 ulp; measured 2.6e-7-4.5e-6), against a 1e-3 gap to
  "highest" (measured ~3e-3);
- the filter gradient 1e-5 (JAX's is rounded to bf16 once; measured 0);
  features and positions 2e-2 (JAX scatter-adds the slots' feature
  gradients in bf16, the port in fp32 rounded once; measured 5.6e-3-6.3e-3
  for the features, 1.4e-7-3.4e-7 for the positions);
- a narrow SymNet step and rollout from ``configs/WaterRamps.yml`` with no
  ``precision`` key, and a train step's gradients: as stated at each test.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dmcf_tpu.models import build_model as jax_build_model
from dmcf_tpu.ops import cconv as jcc
from dmcf_tpu.ops import neighbors as jnb
from dmcf_tpu.ops import windows as jwin
from dmcf_tpu_torch.interop import params_from_flax
from dmcf_tpu_torch.kernels.cconv_klist import (cconv_klist_bwd_reference,
                                                cconv_klist_reference)
from dmcf_tpu_torch.models import build_model
from dmcf_tpu_torch.ops import cconv, neighbors, windows
from dmcf_tpu_torch.rollout import rollout
from dmcf_tpu_torch.scene import bench_sample, build_scene
from tests.test_torch_train import make_batch, narrow_cfg, run_both

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

T = torch.from_numpy
CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


def _klist_inputs(dim):
    """A 256-point cloud, its radius-0.075 lists (K 16), features and a
    filter: [1, 8, 8] in 2D (the trunk's), [4, 4, 4] in 3D."""
    rng = np.random.RandomState(4)
    pts = rng.uniform(-0.3, 0.3, (256, 3)).astype(np.float32)
    pts[:, dim:] = 0.0
    feats = rng.randn(256, 8).astype(np.float32)
    ksize = (1, 8, 8) if dim == 2 else (4, 4, 4)
    kern = (rng.randn(*ksize, 8, 4) * 0.1).astype(np.float32)
    nl = jax.jit(lambda p: jnb.fixed_radius_search(p, p, 0.075, 16))(
        jnp.asarray(pts))
    return pts, feats, kern, nl


def _torch_nl(nl):
    return neighbors.NeighborList(
        idx=T(np.array(nl.idx)), mask=T(np.array(nl.mask)),
        dist=T(np.array(nl.dist)), count=T(np.array(nl.count)),
        disp=T(np.array(nl.disp)))


@pytest.mark.parametrize("dim", [2, 3])
def test_klist_conv_bf16_matches_jax_default(dim):
    pts, feats, kern, nl = _klist_inputs(dim)
    win = "poly6"

    def jax_conv(precision):
        return np.asarray(jax.jit(lambda k, p, f: jcc.continuous_conv(
            k, p, p, f, nl, 0.15, window_fn=jwin.get_window_func(win),
            precision=precision))(jnp.asarray(kern), jnp.asarray(pts),
                                  jnp.asarray(feats)))

    want, highest = jax_conv("default"), jax_conv("highest")
    args = (T(kern), T(pts), T(pts), T(feats), _torch_nl(nl), 0.15)
    kw = dict(window_fn=windows.get_window_func(win))
    got = cconv.continuous_conv(*args, precision="default", **kw)
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 1e-4
    assert _rel(highest, want) > 1e-3  # the modes are told apart
    assert _rel(cconv.continuous_conv(*args, precision="highest", **kw),
                want) > 1e-3
    assert torch.equal(cconv.continuous_conv_reference(
        *args, precision=None, **kw), got)


@pytest.mark.parametrize("n_chunk", [0, 100])
def test_dense_conv_bf16_matches_jax_default(n_chunk):
    rng = np.random.RandomState(7)
    src = rng.uniform(-0.3, 0.3, (300, 3)).astype(np.float32)
    dst = rng.uniform(-0.3, 0.3, (120, 3)).astype(np.float32)
    src[:, 2] = dst[:, 2] = 0.0
    rel = (src[None] - dst[:, None]) / 0.12
    d2 = (rel * rel).sum(-1)
    valid = d2 <= 1.0
    rel = np.where(valid[..., None], rel, 1.0).astype(np.float32)
    a = np.where(valid, np.asarray(jwin.poly6(jnp.asarray(d2))),
                 0.0).astype(np.float32)
    feats = rng.randn(300, 8).astype(np.float32)
    kern = (rng.randn(1, 8, 8, 8, 4) * 0.1).astype(np.float32)

    def jax_dense(precision):
        return np.asarray(jcc.continuous_conv_dense(
            jnp.asarray(kern), jnp.asarray(rel), jnp.asarray(a),
            jnp.asarray(feats), precision=precision, n_chunk=n_chunk))

    want = jax_dense("default")
    got = cconv.continuous_conv_dense(T(kern), T(rel), T(a), T(feats),
                                      n_chunk=n_chunk, precision="default")
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 1e-4
    assert _rel(jax_dense("highest"), want) > 1e-3


@pytest.mark.parametrize("dim", [2, 3])
def test_klist_conv_bf16_vjp_matches_jax(dim):
    """Gradients of sum(dout * conv) in the filter, the features and the
    positions (through the window weights and filter coordinates), the
    port's autograd and ``cconv_klist_bwd_reference`` against jax.vjp."""
    pts, feats, kern, nl = _klist_inputs(dim)
    idx, mask = np.asarray(nl.idx), np.asarray(nl.mask)
    count = np.asarray(nl.count)
    dout = np.random.RandomState(11).randn(256, 4).astype(np.float32)
    win = "poly6"

    def jconv(kernel, feat, p):
        disp = jnp.where(mask[..., None], p[idx] - p[:, None], 0.0)
        n = jnb.NeighborList(
            idx=jnp.asarray(idx), mask=jnp.asarray(mask),
            dist=jnp.where(mask, (disp ** 2).sum(-1), 0.0),
            count=jnp.asarray(count), disp=disp)
        return jcc.continuous_conv(
            kernel, p, p, feat, n, 0.15, window_fn=jwin.get_window_func(win),
            precision="default")

    want = [np.asarray(g) for g in jax.jit(
        lambda *x: jax.vjp(jconv, *x[:3])[1](x[3]))(
            *(jnp.asarray(x) for x in (kern, feats, pts, dout)))]
    leaves = [T(x.copy()).requires_grad_(True) for x in (kern, feats, pts)]
    k_, f_, p_ = leaves
    ti, tm = T(idx.copy()), T(mask.copy())
    disp = torch.where(tm[..., None], p_[ti.long()] - p_[:, None], 0.0)
    tnl = neighbors.NeighborList(
        idx=ti, mask=tm, dist=torch.where(tm, (disp ** 2).sum(-1), 0.0),
        count=T(count), disp=disp)
    out = cconv.continuous_conv(k_, p_, p_, f_, tnl, 0.15,
                                window_fn=windows.get_window_func(win),
                                precision="default")
    got = [g.numpy() for g in torch.autograd.grad(out, leaves, T(dout))]
    assert _rel(got[0], want[0]) <= 1e-5
    assert _rel(got[1], want[1]) <= 2e-2
    assert _rel(got[2][:, :dim], want[2][:, :dim]) <= 2e-2
    # the plain backward on the contract, with its casts
    geom = cconv.klist_geometry(tnl, 0.15, kern.shape[:3],
                                window_fn=windows.get_window_func(win))
    args = (T(dout), *(x.detach() for x in geom), T(feats),
            T(kern).reshape(-1, 4), kern.shape[:3])
    dfeats, dqfeats, dw, da, dt = cconv_klist_bwd_reference(
        *args, precision="default")
    assert dqfeats is None
    assert _rel(dw.reshape(kern.shape), want[0]) <= 1e-5
    dw32 = cconv_klist_bwd_reference(*args, precision="highest")[2]
    assert _rel(dw32.reshape(kern.shape), want[0]) > 1e-3
    assert _rel(dfeats, want[1]) <= 2e-2
    for g in (dfeats, dw):  # rounded to bf16 once
        assert torch.equal(g, g.to(torch.bfloat16).float())


def test_symmetric_conv_at_bf16_raises():
    pts, feats, kern, nl = _klist_inputs(3)
    kern = cconv.build_symmetric_kernel(T(kern[:, :, :2]), 2)
    with pytest.raises(NotImplementedError):
        cconv.continuous_conv(kern, T(pts), T(pts), T(feats), _torch_nl(nl),
                              0.15, symmetric=True, query_features=T(feats),
                              precision="default")
    q, k = np.asarray(nl.idx).shape
    with pytest.raises(NotImplementedError):
        cconv_klist_reference(T(np.asarray(nl.idx)), torch.ones(q, k),
                              torch.zeros(q, k, 3), T(feats),
                              kern.reshape(-1, 4), (4, 4, 4),
                              qfeats=T(feats), precision="default")


def _waterramps_cfg(**over):
    with open(os.path.join(CONFIG_DIR, "WaterRamps.yml")) as f:
        cfg = yaml.safe_load(f)["model"]
    assert "precision" not in cfg  # the shipped default: JAX's bf16 trunk
    cfg.update(kernel_size=[1, 4, 4], sym_kernel_size=[1, 4, 4],
               out_scale=[1e-2, 1e-2, 0.0],
               scale_size_factor=[1.0, 1.0, 0.5],
               layer_channels=[[[4]], [[8], [4], [4]], [[8], [4], [4]],
                               [[8], [4], [4]], [[8]], [[2]]], **over)
    return cfg


def test_unknown_precision_raises():
    with pytest.raises(ValueError, match="precision"):
        build_model(_waterramps_cfg(precision="fast"), device="cpu")


def test_symnet_step_and_rollout_match_jax_default():
    """A narrow WaterRamps SymNet (kernel [1,4,4], the 3-scale trunk with
    its dense downsampling pairs, the ASCC stack) built with no
    ``precision`` key, flax weights carried across, on a 256-fluid scene
    that touches the boundary: the position correction within 2e-4 of its
    max of JAX's at its default (measured 2.6e-5: bf16 flips of T carried
    through 27 convs), while the port's fp32 path lies 1.1e-3 from it;
    positions over a 3-step rollout within 1e-5.  The scale-0 and trunk
    convs round their window weights to bf16 before the taps, as JAX's
    model-cached bf16 taps do (``models/pbf.py:caches_taps``): without it
    the step lay 1.3e-3 from JAX's."""
    cfg = _waterramps_cfg()
    pos, box, nrm = build_scene(256)
    pos[:, :2] -= 0.04
    sample = bench_sample(pos, box, nrm, device="cpu")
    jsample = {k: jnp.asarray(v.numpy()) for k, v in sample.items()}
    jmodel = jax_build_model(cfg)
    params = jax.jit(lambda key, s: jmodel.init(key, s, training=False))(
        jax.random.PRNGKey(0), jsample)
    jstep = jax.jit(lambda p, s: jmodel.apply(p, s, training=False))
    state = params_from_flax(jax.tree.map(np.asarray, params))
    model = build_model(cfg, device="cpu")
    assert model.precision == "default"
    assert model.sym_conv0.precision == "highest"
    model.load_state_dict(state)
    fp32 = build_model(dict(cfg, precision="highest"), device="cpu")
    fp32.load_state_dict(state)

    _, _, jaux = jstep(params, jsample)
    want = np.asarray(jaux["pos_correction"])
    with torch.no_grad():
        got = model(sample)[2]["pos_correction"].numpy()
        off = fp32(sample)[2]["pos_correction"].numpy()
    assert _rel(got, want) <= 2e-4
    assert _rel(off, want) > 5e-4

    js = dict(jsample)
    for _ in range(3):
        js["pos"], js["vel"], _ = jstep(params, js)
    tp, _, gate = rollout(model, sample, 3)
    np.testing.assert_allclose(tp.numpy(), np.asarray(js["pos"]), atol=1e-5)
    assert gate["exact"]


def test_train_step_bf16_grads_match_jax():
    """The narrow two-scale momentum SymNet of ``test_torch_train.py`` at
    the default precision: one train step (batch 2, window 2) in both
    packages from the same weights; each parameter's gradient within 2e-2
    of that tensor's largest JAX gradient (bf16 roundings through 2 x 13
    convs and their VJPs; measured 2.2e-3, the port's fp32 path 5.5e-3)."""
    import types

    from dmcf_tpu.data.generators import gen_momentum_data
    from dmcf_tpu.models import losses as jlosses
    from dmcf_tpu_torch.models import losses

    cfg = narrow_cfg()
    del cfg["precision"]
    np.random.seed(42)
    scene = gen_momentum_data(data_cnt=1, timesteps=4, res=100, radius=12,
                              dt=0.0025, speed=30.0)[0]
    jmodel = jax_build_model(cfg)
    first = make_batch(scene, [0], 2)
    s0 = {k: jnp.asarray(first[k][0][0] if k in ("pos", "vel")
                         else first[k][0])
          for k in ("pos", "vel", "box", "box_normals", "fluid_mask",
                    "box_mask")}
    params = jax.jit(lambda key, s: jmodel.init(key, s, training=False))(
        jax.random.PRNGKey(0), s0)
    lcfg = cfg["loss"]["weighted_mse"]
    setup = types.SimpleNamespace(
        cfg=cfg, jmodel=jmodel, params=params,
        jloss={"weighted_mse": jlosses.get_loss(**lcfg)},
        loss={"weighted_mse": losses.get_loss(**lcfg)})
    batch = make_batch(scene, [0, 1], 2)
    (jl, _, jgrads), (tl, _, tgrads), model = run_both(
        setup, batch, 2, np.ones(2, np.float32))
    assert model.precision == "default"
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    for name, want in jgrads.items():
        scale = float(want.abs().max())
        err = float((tgrads[name] - want).abs().max())
        assert err <= 2e-2 * scale, (name, err, scale)
    assert float(tgrads["sym_conv0.kernel"].abs().max()) > 0


def test_entry_points_name_and_take_the_precision():
    """``run_pipeline --model.precision highest`` builds the fp32 model and
    the config's own precision is the bf16 trunk; the bench's JSON line
    names the precision it ran."""
    from dmcf_tpu_torch import bench, run_pipeline
    from dmcf_tpu_torch.utils import Config

    momentum = os.path.join(CONFIG_DIR, "other", "momentum.yml")
    for extra, want in (([], "default"),
                        (["--model.precision", "highest"], "highest")):
        args, over = run_pipeline.parse_args(
            ["--cfg_file", momentum, "--split", "valid"] + extra)
        _, _, mcfg = Config.merge_cfg_file(
            Config.load_from_file(args.cfg_file), args, over)
        assert build_model(mcfg, device="cpu").precision == want
    d = bench.run(device="cpu", steps=1, n_fluid=64)["detail"]
    assert d["precision"] == "default" and d["exact"]
