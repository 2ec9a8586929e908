"""The slice as a whole: a WaterRamps SymNet (``configs/WaterRamps.yml``
cut to narrow widths, as ``test_torch_model.py`` cuts it, and to two
trunk stages) with
``interpolation: nearest_neighbor`` in every conv and the tap cache,
against the JAX package with the same weights, at ``precision:
highest``, on the CPU: one step, and one train step's gradients (batch 1,
window 1, a bench scene's next frame as the target).

Tolerances: the position correction to 1e-5 of its max, positions to
1e-6, integer aux exactly (as ``test_torch_model.py``); the loss to 1e-4
relative and every parameter's gradient to 1e-4 of that tensor's max
(fp32 through the trunk's convs, as ``test_torch_train.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmcf_tpu.data.dataflow import batch_samples as jbatch_samples
from dmcf_tpu.models import build_model as jax_build_model
from dmcf_tpu.models import losses as jlosses
from dmcf_tpu.pipelines import simulator as jsim
from dmcf_tpu_torch.interop import params_from_flax
from dmcf_tpu_torch.models import build_model, losses
from dmcf_tpu_torch.pipelines import simulator as sim
from dmcf_tpu_torch.scene import bench_sample, build_scene
from tests.test_torch_model import narrow_cfg
from tests.test_torch_train import OPT_CFG, capture_grads, check_grads

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def nearest():
    cfg = dict(narrow_cfg(), interpolation="nearest_neighbor",
               layer_channels=[[[4]], [[8], [4], [4]], [[8]], [[2]]])
    pos, box, nrm = build_scene(256)
    pos[:, :2] -= 0.04  # the fluid within r0 of the floor
    sample = bench_sample(pos, box, nrm, device="cpu")
    jsample = {k: jnp.asarray(v.numpy()) for k, v in sample.items()}
    jmodel = jax_build_model(cfg)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda key, s: jmodel.init(key, s, training=False))(
            jax.random.PRNGKey(0), jsample))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_flax(params))
    assert {m.interpolation for m in model.modules()
            if hasattr(m, "interpolation")} == {"nearest_neighbor"}
    return dict(cfg=cfg, pos=pos, box=box, nrm=nrm, sample=sample,
                jsample=jsample, jmodel=jmodel, params=params, model=model)


def test_step_matches_jax(nearest):
    jp, _, jaux = jax.jit(lambda p, s: nearest["jmodel"].apply(
        p, s, training=False))(nearest["params"], nearest["jsample"])
    with torch.no_grad():
        tp, _, taux = nearest["model"](nearest["sample"])
    want = np.asarray(jaux["pos_correction"])
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(taux["pos_correction"].numpy(), want,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    for k in ("neighbor_overflow", "pair_overflow", "scale_counts"):
        np.testing.assert_array_equal(taux[k].numpy(), np.asarray(jaux[k]),
                                      err_msg=k)


def test_train_step_grads_match_jax(nearest):
    """One train step (batch 1, window 1) in each package from the same
    weights: the loss and every parameter's gradient."""
    rng = np.random.RandomState(0)
    n = len(nearest["pos"])
    vel = rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)
    vel[:, 2] = 0.0
    steps = np.arange(2, dtype=np.float32)[:, None, None] * 0.0025
    pos = nearest["pos"][None] + steps * vel[None]
    pos[1:] += rng.normal(scale=1e-3, size=(1, n, 3)).astype(np.float32) \
        * np.asarray([1, 1, 0], np.float32)
    batch = jbatch_samples([{
        "pos": pos.astype(np.float32), "vel": np.repeat(vel[None], 2, 0),
        "grav": None, "pre": 0, "box": nearest["box"],
        "box_normals": nearest["nrm"]}])
    lcfg = nearest["cfg"]["loss"]["weighted_mse"]
    time_w = np.ones(1, np.float32)
    step = jsim.make_train_step(
        nearest["jmodel"], {"weighted_mse": jlosses.get_loss(**lcfg)},
        capture_grads(), window=1)
    params = jax.tree.map(jnp.asarray, nearest["params"])
    _, state, jl, _, _ = step(
        params, capture_grads().init(params),
        {k: jnp.asarray(v) for k, v in batch.items() if v is not None},
        jnp.asarray(time_w))
    jgrads = params_from_flax(jax.tree.map(np.asarray, state["g"]))
    model = build_model(nearest["cfg"], device="cpu")
    model.load_state_dict(params_from_flax(nearest["params"]))
    opt, sch = sim.make_optimizer(model, OPT_CFG)
    tstep = sim.make_train_step(
        model, {"weighted_mse": losses.get_loss(**lcfg)}, opt, sch,
        window=1)
    tl, _, _ = tstep({k: torch.from_numpy(v) for k, v in batch.items()
                      if v is not None}, time_w)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4)
    tgrads = {k: p.grad for k, p in model.named_parameters()}
    assert check_grads(tgrads, jgrads) >= len(jgrads) - 4
