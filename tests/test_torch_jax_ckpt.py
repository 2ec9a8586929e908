"""The JAX package's orbax training checkpoints in the port
(``scripts/jax_ckpt_to_torch.py``), on the CPU.

A narrow 2D SymNet's flax params and the ``optax.adam`` state of the JAX
package's optimizer (``dmcf_tpu/pipelines/simulator.py``: Adam, eps 1e-6,
its piecewise-constant schedule) after one update on fixed gradients are
saved by the JAX package's own ``BasePipeline.save_ckpt`` at epoch 3 with
``save_ckpt_freq`` 2, then converted.  The port's pipeline resumes from
the file at the epoch the JAX package resumes at (7), its model loads the
params strictly and bit for bit, the Adam moments and count arrive bit
for bit, and its next Adam step on the next fixed gradients, at the
schedule's second learning rate, equals optax's next update:

* within 1e-6 of each tensor's largest element, optax evaluated in
  float64 on the same state (``jax.enable_x64``; measured 2.3e-7);
* within 2e-5 of it, optax in float32 as the JAX package trains.  optax
  forms the bias corrections ``1 - beta ** count`` in float32, where
  ``1 - 0.999 ** 2`` lands 1.96e-5 from its value, and torch's Adam forms
  them in float64; the update takes the square root of the second, so
  the two differ by ~1e-5 (measured at most 1.03e-5) at the second
  update, less as the count grows.

A checkpoint without ``opt_state`` converts to params only.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from dmcf_tpu.models import build_model as jax_build_model
from dmcf_tpu.pipelines.base import BasePipeline as JaxPipeline
from dmcf_tpu.pipelines.simulator import Simulator as JaxSimulator
from dmcf_tpu_torch.interop import params_from_flax
from dmcf_tpu_torch.models import build_model
from dmcf_tpu_torch.pipelines.base import BasePipeline
from dmcf_tpu_torch.pipelines.simulator import make_optimizer
from scripts import jax_ckpt_to_torch
from test_torch_options import BASE, make_sample

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

SYMNET = dict(BASE, name="SymNet", sym_kernel_size=[1, 4, 4], sym_axis=1,
              layer_channels=[[[8]], [[8], [4]], [[8]], [[3]]])
OPT = {"lr_boundaries": [1], "lr_values": [1e-3, 5e-4]}
FREQ = 2


def dirs(root):
    return dict(name="Simulator", main_log_dir=str(root / "logs"),
                output_dir=str(root / "out"),
                train_sum_dir=str(root / "sum"), save_ckpt_freq=FREQ)


def jax_state():
    """(model, params, optimizer) of the JAX package: seeded params of the
    ``eval_shape`` template, optax.adam as ``Simulator._get_optimizer``
    builds it."""
    jmodel = jax_build_model(SYMNET)
    js = {k: jnp.asarray(v) for k, v in make_sample().items()}
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), js, training=True))
    rng = np.random.RandomState(0)
    params = jax.tree.map(lambda a: jnp.asarray(rng.uniform(
        -0.3, 0.3, a.shape).astype(np.float32)), shapes)
    opt = optax.adam(JaxSimulator._make_lr_schedule(None, OPT), eps=1e-6)
    return jmodel, params, opt


def grads_like(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: jnp.asarray(rng.randn(*a.shape).astype(
        np.float32)), params)


def convert(tmp_path, jmodel, params, opt_state):
    """Save through the JAX package's pipeline at epoch 3, convert into
    the port's checkpoint directory; returns (JAX resume epoch, port
    pipeline, converted file)."""
    jp = JaxPipeline(jmodel, **dirs(tmp_path / "jax"))
    jp.params, jp.opt_state = params, opt_state
    jp.save_ckpt(3)
    resume = JaxPipeline(jmodel, **dirs(tmp_path / "jax")).load_ckpt()
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(yaml.safe_dump({"model": SYMNET, "pipeline": {
        "save_ckpt_freq": FREQ, "optimizer": OPT}}))
    pp = BasePipeline(build_model(SYMNET, device="cpu"), device="cpu",
                      **dirs(tmp_path / "port"))
    path = jax_ckpt_to_torch.main([os.path.join(jp._ckpt_dir, "3"), "-c",
                                   str(cfg), "-o", pp._ckpt_dir])
    return resume, pp, path


def test_params_and_adam_state_carry_across(tmp_path):
    jmodel, params, opt = jax_state()
    state = opt.init(params)
    updates, state = opt.update(grads_like(params, 1), state, params)
    params = optax.apply_updates(params, updates)
    resume, pp, path = convert(tmp_path, jmodel, params, state)
    assert os.path.basename(path) == "ckpt_%05d.pt" % (3 * FREQ)

    pp.optimizer, pp.scheduler = make_optimizer(pp.model, OPT)
    assert pp.load_ckpt() == resume == 3 * FREQ + 1
    want = params_from_flax(params)
    got = pp.model.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)

    adam = pp.optimizer.state_dict()["state"]
    names = [n for n, _ in pp.model.named_parameters()]
    mu, nu = params_from_flax(state[0].mu), params_from_flax(state[0].nu)
    for i, name in enumerate(names):
        assert torch.equal(adam[i]["exp_avg"], mu[name])
        assert torch.equal(adam[i]["exp_avg_sq"], nu[name])
        assert float(adam[i]["step"]) == int(state[0].count) == 1

    # optax's second update: count 1, the schedule's second value
    g2 = grads_like(params, 2)
    updates, _ = opt.update(g2, state, params)
    with jax.enable_x64(True):
        wide = jax.tree.map(lambda a: jnp.asarray(
            np.asarray(a, np.float64 if a.dtype == np.float32 else a.dtype)),
            (g2, state, params))
        updates64, _ = opt.update(*wide)
        updates64 = jax.tree.map(np.asarray, updates64)
    assert pp.optimizer.param_groups[0]["lr"] == OPT["lr_values"][1]
    g2 = params_from_flax(g2)
    with torch.no_grad():
        for name, p in pp.model.named_parameters():
            p.zero_()            # Adam's step does not read the params:
            p.grad = g2[name]    # from zero, the step is the update
    pp.optimizer.step()
    pp.scheduler.step()
    for want, tol in ((updates64, 1e-6), (updates, 2e-5)):
        want = {k: v.double() for k, v in params_from_flax(jax.tree.map(
            lambda a: np.asarray(a, np.float64), want)).items()}
        for name, p in pp.model.named_parameters():
            scale = float(want[name].abs().max())
            err = float((p.detach().double() - want[name]).abs().max())
            assert err <= tol * scale, (name, err, scale, tol)
    assert pp.scheduler.last_epoch == 2


def test_params_only_checkpoint(tmp_path):
    jmodel, params, _ = jax_state()
    resume, pp, path = convert(tmp_path, jmodel, params, None)
    state = torch.load(path, weights_only=True)
    assert set(state) == {"model", "epoch"}
    assert pp.load_ckpt() == resume
    want = params_from_flax(params)
    assert all(torch.equal(pp.model.state_dict()[k], want[k]) for k in want)
