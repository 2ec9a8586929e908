"""Data-parallel training of the port (``dmcf_tpu_torch/parallel/
data_parallel.py``, ``make_train_step(group=)``, ``Simulator`` with
``data_parallel``) on 2 gloo ranks (``parallel.dist.spawn``; rank bodies
in ``_torch_ranks.py``) against the single-process step and the JAX
package's ``make_train_step``, on the CPU, with ``test_torch_train.py``'s
narrow momentum SymNet cut to one trunk layer (``precision: highest``;
JAX compiles the step in ~8 s instead of ~12) and weights carried from
the flax tree.  The ranks run while the parent computes the references.

Tolerances: against the single-process step JAX's ``test_parallel.py``
ones, the loss vector rtol 2e-4 and the parameters after the Adam step
atol 2e-5 (one item a rank: the gradients are summed in another order);
against JAX's step ``test_torch_train.py``'s, the loss vector 1e-4
relative and each gradient within 1e-4 of that tensor's largest JAX
gradient (``test_torch_dp_pipeline.py`` holds ``run_pipeline`` under
data parallelism).
"""

import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmcf_tpu.data.generators import gen_momentum_data
from dmcf_tpu.models import build_model as jbuild_model
from dmcf_tpu.models import losses as jlosses
from dmcf_tpu.pipelines import simulator as jsim
from dmcf_tpu_torch.interop import params_from_flax
from dmcf_tpu_torch.models import build_model
from dmcf_tpu_torch.models import losses
from dmcf_tpu_torch.parallel import batch_sharding, shard_batch
from dmcf_tpu_torch.parallel.dist import spawn
from dmcf_tpu_torch.pipelines import simulator as sim

import _torch_ranks
from tests.test_torch_train import (OPT_CFG, capture_grads, check_grads,
                                    make_batch, narrow_cfg)

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def dp_setup():
    cfg = dict(narrow_cfg(),
               layer_channels=[[[4]], [[4], [4]], [[4]], [[2]]])
    np.random.seed(42)
    scene = gen_momentum_data(data_cnt=1, timesteps=6, res=100, radius=12,
                              dt=0.0025, speed=30.0)[0]
    jmodel = jbuild_model(cfg)
    first = make_batch(scene, [0], 1)
    s0 = {k: jnp.asarray(first[k][0][0] if k in ("pos", "vel")
                         else first[k][0])
          for k in ("pos", "vel", "box", "box_normals", "fluid_mask",
                    "box_mask")}
    params = jax.jit(lambda key, s: jmodel.init(key, s, training=False))(
        jax.random.PRNGKey(0), s0)
    lcfg = cfg["loss"]["weighted_mse"]
    return types.SimpleNamespace(
        cfg=cfg, scene=scene, jmodel=jmodel, params=params,
        jloss={"weighted_mse": jlosses.get_loss(**lcfg)},
        loss={"weighted_mse": losses.get_loss(**lcfg)})


def test_shard_batch_takes_contiguous_slices():
    class G:
        world_size, rank = 2, 1
    batch = {"pos": np.arange(8).reshape(4, 2), "pre": np.arange(4),
             "grav": None}
    got = shard_batch(batch, G)
    np.testing.assert_array_equal(got["pos"], batch["pos"][2:])
    np.testing.assert_array_equal(got["pre"], [2, 3])
    assert got["grav"] is None
    with pytest.raises(ValueError):
        batch_sharding(3, G)


def _references(setup, batch, window, time_w, state):
    """JAX's step on the whole batch (its gradients captured) and the
    port's one-process step (its model after the step)."""
    jstep = jsim.make_train_step(setup.jmodel, setup.jloss, capture_grads(),
                                 window=window)
    params = jax.tree.map(jnp.copy, setup.params)
    _, jstate, jl, _, _ = jstep(
        params, capture_grads().init(params),
        {k: jnp.asarray(v) for k, v in batch.items() if v is not None},
        jnp.asarray(time_w))
    jgrads = params_from_flax(jax.tree.map(np.asarray, jstate["g"]))
    model = build_model(setup.cfg, device="cpu")
    model.load_state_dict(state)
    step = sim.make_train_step(model, setup.loss,
                               *sim.make_optimizer(model, OPT_CFG),
                               window=window)
    tl, tpre, _ = step({k: torch.as_tensor(v) for k, v in batch.items()
                        if v is not None}, time_w)
    return np.asarray(jl), jgrads, tl, tpre, model


def test_dp_train_step_matches_single_process_and_jax(dp_setup):
    setup = dp_setup
    window = 1
    batch = make_batch(setup.scene, [0, 2], window)
    time_w = np.ones(window, np.float32)
    state = params_from_flax(jax.tree.map(np.asarray, setup.params))
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, _torch_ranks.dp_train, 2,
                            args=(setup.cfg, state, batch, window, OPT_CFG,
                                  setup.cfg["loss"]))
        jl, jgrads, tl, tpre, model = _references(setup, batch, window,
                                                  time_w, state)
        ranks = ranks.result()
    for r in ranks:
        np.testing.assert_allclose(r["lvec"].numpy(), tl.numpy(), rtol=2e-4)
        np.testing.assert_allclose(r["lvec"].numpy(), jl, rtol=1e-4)
        np.testing.assert_array_equal(r["pre"].numpy(), tpre.numpy())
        for name, p in model.named_parameters():
            np.testing.assert_allclose(r["params"][name].numpy(),
                                       p.detach().numpy(), rtol=0,
                                       atol=2e-5, err_msg=name)
        assert check_grads(r["grads"], jgrads) >= len(jgrads) - 4
    # the ranks hold the same parameters after the step
    for name in ranks[0]["params"]:
        assert torch.equal(ranks[0]["params"][name],
                           ranks[1]["params"][name]), name
