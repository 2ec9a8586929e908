"""The port's training path against the JAX package's on the CPU: the
training losses, the curriculum helpers, the seeded window sampler and
batcher, the BPTT train step (gradients, Adam, weight decay, the per-tensor
clip, the divergence-guarded warm-up, ``grad_accum``) on a narrow SymNet
with weights carried from the flax tree, and ``run_pipeline --split train``
with a checkpoint that resumes.

Both packages' models are built with ``precision: highest`` (fp32; the
bf16 trunk, the default, is held in ``test_torch_precision.py``).
Tolerances: losses 1e-6 relative (same formulas); the train step's loss
vector 1e-4 relative and each parameter's gradient within 1e-4 of that
tensor's largest JAX gradient (fp32 sums in another order through a
two-step window of 25 convs; measured ~5e-6); Adam's parameters 1e-7
absolute (the same update, rounded in another order).
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from dmcf_tpu.data import Dataset as JDataset
from dmcf_tpu.data import get_dataloader as jget_dataloader
from dmcf_tpu.data.dataflow import WindowSampler as JWindowSampler
from dmcf_tpu.data.dataflow import batch_samples as jbatch_samples
from dmcf_tpu.data.generators import gen_momentum_data
from dmcf_tpu.models import build_model as jbuild_model
from dmcf_tpu.models import losses as jlosses
from dmcf_tpu.pipelines import simulator as jsim
from dmcf_tpu_torch import run_pipeline
from dmcf_tpu_torch.data import Dataset, WindowSampler, batch_samples, \
    get_dataloader
from dmcf_tpu_torch.interop import params_from_flax
from dmcf_tpu_torch.models import build_model
from dmcf_tpu_torch.models import losses
from dmcf_tpu_torch.pipelines import simulator as sim
from tests.test_pipeline import _make_scenes

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
MOMENTUM = os.path.join(ROOT, "configs", "other", "momentum.yml")
T = torch.from_numpy
J = jnp.asarray
OPT_CFG = {"lr_boundaries": [1], "lr_values": [1e-3, 5e-4]}


# ---------------------------------------------------------------------------
# losses and curriculum helpers


@pytest.mark.parametrize("typ", ["mse", "weighted_mse", "vel",
                                 "weighted_vel", "momentum"])
def test_training_losses_match_jax(typ):
    rng = np.random.RandomState(0)
    target, pred, inp, prev, corr = (
        rng.uniform(-0.3, 0.3, (40, 3)).astype(np.float32) for _ in range(5))
    mask = rng.rand(40) < 0.8
    nbrs = rng.randint(0, 20, 40).astype(np.float32)
    kw = dict(fac=3.0, gamma=0.5, neighbor_scale=0.0625, pre_scale=0.1) \
        if typ != "momentum" else dict(fac=3.0)
    if typ in ("vel", "weighted_vel", "momentum"):
        kw.pop("pre_scale", None)

    def call(fn, cv):
        if typ == "momentum":  # its own signature in both packages
            return fn(cv(corr), cv(mask))
        return fn(cv(target), cv(pred), cv(mask),
                  num_fluid_neighbors=cv(nbrs), input_pos=cv(inp),
                  target_prev=cv(prev), pre_steps=2)

    got = call(losses.get_loss(typ, **kw), T)
    want = call(jlosses.get_loss(typ, **kw), J)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_time_weights_curriculum_and_clip_match_jax():
    windows, bnds = [3, 5, 10], [20, 40]
    for step in (0, 19, 20, 25, 60, 239, 240):
        for window_it in range(3):
            np.testing.assert_array_equal(
                sim.compute_time_weights(step, window_it, windows, bnds, 200),
                jsim.compute_time_weights(step, window_it, windows, bnds,
                                          200))
        state = (0, 0, 0)
        args = (windows, bnds, [0, 5, 10], [30, 50], [0, 1, 2], [10])
        assert sim.advance_curriculum(step, state, *args) == \
            jsim.advance_curriculum(step, state, *args)
    schedule = sim.lr_schedule(OPT_CFG)
    jschedule = jsim.Simulator._make_lr_schedule(None, OPT_CFG)
    assert [schedule(i) for i in range(3)] == [1e-3, 5e-4, 5e-4]
    # JAX's values are float32
    np.testing.assert_allclose([float(jschedule(i)) for i in range(3)],
                               [1e-3, 5e-4, 5e-4], rtol=1e-7)
    g = np.random.RandomState(1).randn(4, 5).astype(np.float32)
    for norm in (0.5, 100.0):
        np.testing.assert_allclose(
            sim._clip_by_norm(T(g), norm).numpy(),
            np.asarray(jsim._clip_by_norm(J(g), norm)), rtol=1e-6)


# ---------------------------------------------------------------------------
# the training loader

AUGMENT = {"rotate": {"rot_axis": 1},
           "jitter": {"channels": {"pos": 1e-3}},
           "jitter_inp": {"channels": {"vel": 1e-2}}}


def test_window_sampler_and_batches_match_jax():
    scenes = _make_scenes(n_scenes=3, frames=9, n=6)
    kw = dict(window=2, pre_frames=1, shuffle=True, sample_cnt=3,
              augment=AUGMENT, translate=[0.1, 0.0, 0.0],
              scale=[0.9, 0.9, 0.9], seed=5)
    got = list(WindowSampler(Dataset(scenes), **kw))
    want = list(JWindowSampler(JDataset(scenes), **kw))
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert set(g) == set(w) and g["pre"] == w["pre"]
        for k in ("pos", "vel", "grav", "box", "box_normals", "frame_id"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    gb, wb = batch_samples(got[:4], bucket=8), jbatch_samples(want[:4],
                                                             bucket=8)
    assert set(gb) == set(wb)
    for k in gb:
        np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)
    # the seeded loader: one worker, a shuffle buffer, repeats
    lkw = dict(batch_size=2, window=2, pre_frames=1, repeat=True,
               shuffle_buffer=4, num_workers=1, augment=AUGMENT, seed=3,
               sample_cnt=3)
    loader, jloader = (get_dataloader(Dataset(scenes), **lkw),
                       jget_dataloader(JDataset(scenes), **lkw))
    try:
        for _ in range(6):  # past one pass over the 9 samples
            g, w = next(loader), next(jloader)
            for k in g:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    finally:
        loader.close()
        jloader.close()
    assert not any(t.is_alive() for t in loader.threads)


# ---------------------------------------------------------------------------
# the train step


def narrow_cfg():
    """configs/other/momentum.yml cut to a narrow two-scale SymNet."""
    with open(MOMENTUM) as f:
        cfg = yaml.safe_load(f)["model"]
    cfg.update(kernel_size=[1, 4, 4], sym_kernel_size=[1, 4, 4],
               strides=[1, 2], particle_radii=[0.02, 0.04],
               scale_size_factor=[1.0, 0.5], precision="highest",
               out_scale=[1e-2, 1e-2, 0.0], neighbor_k=16,
               neighbor_k_gaps=[32],
               layer_channels=[[[4]], [[4], [4]], [[4], [4]], [[4]], [[2]]])
    return cfg


def capture_grads():
    """An optax transformation that keeps the gradients in its state and
    leaves the parameters as they are."""
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        lambda u, s, p=None: (jax.tree.map(jnp.zeros_like, u), {"g": u}))


@pytest.fixture(scope="module")
def slice_setup():
    cfg = narrow_cfg()
    np.random.seed(42)
    scene = gen_momentum_data(data_cnt=1, timesteps=6, res=100, radius=12,
                              dt=0.0025, speed=30.0)[0]
    jmodel = jbuild_model(cfg)
    lcfg = cfg["loss"]["weighted_mse"]
    first = make_batch(scene, [0], 2)
    s0 = {k: J(first[k][0][0] if k in ("pos", "vel") else first[k][0])
          for k in ("pos", "vel", "box", "box_normals", "fluid_mask",
                    "box_mask")}
    params = jax.jit(lambda key, s: jmodel.init(key, s, training=False))(
        jax.random.PRNGKey(0), s0)
    return types.SimpleNamespace(
        cfg=cfg, scene=scene, jmodel=jmodel, params=params,
        jloss={"weighted_mse": jlosses.get_loss(**lcfg)},
        loss={"weighted_mse": losses.get_loss(**lcfg)})


def make_batch(scene, starts, window, pre=0, frozen=False):
    """A momentum batch (data scaled by 0.9 so the finest radius holds
    neighbours): items starting at ``starts``, ``pre`` warm-up frames.
    ``frozen`` holds every frame's positions at the first's (with the
    velocities kept), so a self-rollout's error grows every step."""
    items = []
    for st in starts:
        fr = scene[st:st + pre + window + 1]
        pos = np.stack([f["pos"] for f in fr]) * np.float32(0.9)
        if frozen:
            pos[:] = pos[:1]
        items.append({
            "pos": pos, "vel": np.stack([f["vel"] for f in fr])
            * np.float32(0.9), "grav": None, "pre": pre,
            "box": np.asarray(scene[0]["box"], np.float32).reshape(-1, 3)
            * np.float32(0.9),
            "box_normals": np.zeros((1, 3), np.float32)})
    return jbatch_samples(items)


def run_both(setup, batch, window, time_w, **kw):
    """JAX's make_train_step (gradients captured) and the port's on the
    same batch from the same weights.  Returns (JAX (lvec, pre_eff, grads
    as a state dict), port (lvec, pre_eff, grads), the port's model)."""
    step = jsim.make_train_step(setup.jmodel, setup.jloss, capture_grads(),
                                window=window, **kw)
    jb = {k: J(v) for k, v in batch.items() if v is not None}
    params = jax.tree.map(jnp.copy, setup.params)
    _, state, lvec, pre, _ = step(params, capture_grads().init(params), jb,
                                  J(time_w))
    jgrads = params_from_flax(jax.tree.map(np.asarray, state["g"]))
    model = build_model(setup.cfg, device="cpu")
    model.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, setup.params)))
    opt, sch = sim.make_optimizer(model, OPT_CFG)
    tstep = sim.make_train_step(model, setup.loss, opt, sch, window=window,
                                **kw)
    tl, tpre, _ = tstep({k: T(v) for k, v in batch.items()
                         if v is not None}, time_w)
    tgrads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return (np.asarray(lvec), np.asarray(pre), jgrads), \
        (tl.numpy(), tpre.numpy(), tgrads), model


def check_grads(tgrads, jgrads):
    assert set(tgrads) == set(jgrads)
    moved = 0
    for name, want in jgrads.items():
        scale = float(want.abs().max())
        err = float((tgrads[name] - want).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)
        moved += scale > 0
    return moved


def test_train_step_matches_jax(slice_setup):
    """The slice's parity: loss vector, every parameter's gradient, and
    Adam (with the LR boundary crossed) fed JAX's gradients against
    optax.adam."""
    batch = make_batch(slice_setup.scene, [0, 2], 2)
    time_w = np.asarray([0.5, 1.0], np.float32)
    (jl, _, jgrads), (tl, _, tgrads), model = run_both(
        slice_setup, batch, 2, time_w)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    # every trunk conv and the ASCC conv learns (obs_conv sees no boundary)
    assert check_grads(tgrads, jgrads) >= len(jgrads) - 4
    assert float(tgrads["sym_conv0.kernel"].abs().max()) > 0

    params = jax.tree.map(jnp.copy, slice_setup.params)
    tx = optax.adam(jsim.Simulator._make_lr_schedule(None, OPT_CFG),
                    eps=1e-6)
    # JAX's gradients as a flax tree ({"params": {module: {leaf: ...}}})
    jg = jax.tree_util.tree_map_with_path(
        lambda path, _: J(jgrads[".".join(p.key for p in path[1:])]
                          .numpy()), params)
    state = tx.init(params)
    model.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, slice_setup.params)))
    opt, sch = sim.make_optimizer(model, OPT_CFG)
    for _ in range(2):
        upd, state = tx.update(jg, state, params)
        params = optax.apply_updates(params, upd)
        for name, p in model.named_parameters():
            p.grad = jgrads[name].clone()
        opt.step()
        sch.step()
    flat = params_from_flax(jax.tree.map(np.asarray, params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), flat[name].numpy(),
                                   atol=1e-7, err_msg=name)


def test_train_step_options_match_jax(slice_setup):
    """Weight decay, the per-tensor clip and the divergence-guarded
    warm-up, in one step of each package: the batch's positions are held
    at their first frame, so the self-rollout's error grows by ~|v| dt a
    step, and ``max_err`` at 1.5 times the first step's error stops the
    warm-up at its second step (pre_eff 1)."""
    batch = make_batch(slice_setup.scene, [0, 1], 2, pre=2, frozen=True)
    fm = batch["fluid_mask"][0]
    err0 = float(np.abs(batch["vel"][0, 0][fm] * 0.0025).sum(-1).max())
    kw = dict(w_decay=1e-3, grad_norm=1e-4, max_err=1.5 * err0)
    (jl, jpre, jgrads), (tl, tpre, tgrads), _ = run_both(
        slice_setup, batch, 2, np.ones(2, np.float32), **kw)
    np.testing.assert_array_equal(tpre, jpre)
    assert list(tpre) == [1, 1]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    check_grads(tgrads, jgrads)
    norms = [float(g.norm()) for g in tgrads.values()]
    assert max(norms) == pytest.approx(1e-4, rel=1e-5)  # clipped
    assert min(norms) < 0.5e-4                          # not clipped


def test_grad_accum_equals_full_batch(slice_setup):
    batch = {k: T(v) for k, v in make_batch(slice_setup.scene, [0, 1, 2, 3],
                                             2).items() if v is not None}
    grads = []
    for ga in (1, 2):
        model = build_model(slice_setup.cfg, device="cpu")
        model.load_state_dict(params_from_flax(
            jax.tree.map(np.asarray, slice_setup.params)))
        opt, sch = sim.make_optimizer(model, OPT_CFG)
        step = sim.make_train_step(model, slice_setup.loss, opt, sch,
                                   window=2, grad_accum=ga)
        lvec, _, _ = step(batch, np.ones(2, np.float32))
        grads.append((lvec, [p.grad.clone() for p in model.parameters()]))
    (l1, g1), (l2, g2) = grads
    # the same arithmetic; PyTorch's CPU scatter-adds (the gathers'
    # backward) sum across threads in any order, so 1e-6 of each max
    torch.testing.assert_close(l1, l2, rtol=1e-6, atol=0)
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-6 * float(b.abs().max()))
    with pytest.raises(ValueError, match="grad_accum"):
        sim.make_train_step(model, slice_setup.loss, opt, window=2,
                            grad_accum=3)(batch, np.ones(2, np.float32))


# ---------------------------------------------------------------------------
# the entry point


def test_run_pipeline_train_writes_metrics_and_resumes(tmp_path,
                                                        monkeypatch):
    """``run_pipeline --split train`` on the CPU: two steps of one item,
    the scalars in metrics.jsonl, a checkpoint with the optimizer's state;
    a second run resumes from it (epoch 1, the optimizer's step count going
    on); a third with ``data_parallel: true`` trains on over a world of
    one rank."""
    monkeypatch.chdir(tmp_path)
    args = ["--cfg_file", MOMENTUM, "--split", "train", "--device", "cpu",
            "--main_log_dir", "logs", "--output_dir", "out",
            "--pipeline.train_sum_dir", "sum", "--pipeline.iter", "2",
            "--pipeline.log_every", "1", "--dataset.cache_dir", "none",
            "--dataset.train.data_cnt", "1", "--dataset.train.timesteps",
            "8", "--dataset.valid.data_cnt", "1",
            "--dataset.valid.timesteps", "3", "--dataset.test.data_cnt",
            "1", "--dataset.test.timesteps", "2",
            "--pipeline.data_generator.valid.time_end", "3",
            "--pipeline.data_generator.scale", "[0.9,0.9,0.0]",
            "--pipeline.run_test_every_epoch", "false",
            "--pipeline.batch_size", "1"]
    first = run_pipeline.main(args + ["--pipeline.max_epoch", "0"])
    assert [e["step"] for e in first] == [0, 1]
    assert all(np.isfinite(e["loss"]) for e in first)
    ckpt_dir = tmp_path / "logs" / "SymNet_Momentum_momentum" / "checkpoint"
    state = torch.load(ckpt_dir / "ckpt_00000.pt", weights_only=True)
    assert {"model", "optimizer", "scheduler", "epoch"} <= set(state)
    assert state["scheduler"]["last_epoch"] == 2
    second = run_pipeline.main(args + ["--pipeline.max_epoch", "1"])
    assert [e["step"] for e in second] == [2, 3]
    state = torch.load(ckpt_dir / "ckpt_00001.pt", weights_only=True)
    assert state["scheduler"]["last_epoch"] == 4
    assert all(float(s["step"]) == 4
               for s in state["optimizer"]["state"].values())
    (run,) = [d for d in os.listdir(tmp_path / "sum") if d.startswith(
        "00001")]
    tags = {json.loads(line)["tag"] for line in open(
        tmp_path / "sum" / run / "metrics.jsonl")}
    assert {"train/loss", "train/weighted_mse", "train/learning_rate",
            "valid/mse_val", "valid/loss"} <= tags
    # data_parallel: true outside torchrun trains over a world of one
    # rank (the collectives run; test_torch_dp_pipeline.py has two)
    third = run_pipeline.main(args + ["--pipeline.max_epoch", "2",
                                      "--pipeline.data_parallel", "true"])
    assert [e["step"] for e in third] == [4, 5]
    assert all(np.isfinite(e["loss"]) for e in third)
    assert not torch.distributed.is_initialized()
