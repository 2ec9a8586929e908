"""Convert a checkpoint of the JAX package's training (orbax, written by
``dmcf_tpu/pipelines/base.py:BasePipeline.save_ckpt``) into the port's
checkpoint format (``dmcf_tpu_torch/pipelines/base.py``):

    python scripts/jax_ckpt_to_torch.py logs/SymNet_data_v0/checkpoint/12 \\
        -c configs/WaterRamps.yml -o logs_port/SymNet_data_v0/checkpoint

The input is a ``CheckpointManager`` step directory (``<step>/default``
holds the state) or a bare ``StandardSave`` directory, as the JAX
package's ``load_ckpt`` accepts.  The output is ``ckpt_<epoch>.pt`` with
``{"model", "epoch", "optimizer", "scheduler"}``:

* ``model``: the flax params through ``interop.params_from_flax``, loaded
  strictly into the config's model (so a mismatch fails here);
* ``optimizer``: the optax Adam state as ``torch.optim.Adam``'s
  (``mu`` -> ``exp_avg``, ``nu`` -> ``exp_avg_sq``, ``count`` -> ``step``,
  in ``model.parameters()`` order), the learning rate of the next update;
* ``scheduler``: the LR schedule's count as ``LambdaLR.last_epoch``;
* ``epoch``: for a step directory ``step * save_ckpt_freq`` (the config's
  ``pipeline.save_ckpt_freq``), so the port's ``run_pipeline`` resumes at
  ``epoch + 1``, the epoch at which the JAX package resumes
  (``latest * save_ckpt_freq + 1``); 0 for a bare directory, which both
  packages load only as an explicit ``ckpt_path`` (and start at epoch 0).

A checkpoint without ``opt_state`` converts to ``model`` and ``epoch``
only.  Runs where JAX and orbax are (they read the checkpoint); the port
itself imports neither.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def read_orbax(path):
    """(state tree of numpy arrays, CheckpointManager step or None)."""
    import jax
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    step = None
    if os.path.exists(os.path.join(path, "default", "_METADATA")):
        base = os.path.basename(path.rstrip("/"))
        step = int(base) if base.isdigit() else None
        path = os.path.join(path, "default")
    ckptr = ocp.StandardCheckpointer()
    meta = ckptr.metadata(path)
    meta = getattr(meta, "item_metadata", meta)
    shard = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    template = jax.tree.map(
        lambda m: jax.ShapeDtypeStruct(m.shape, m.dtype, sharding=shard),
        meta)
    state = ckptr.restore(path, template)
    return jax.tree.map(np.asarray, state), step


def convert(state, cfg, step=None):
    """The port's checkpoint dict for a restored JAX ``state`` (``params``
    and optionally ``opt_state``) under the config ``cfg``."""
    import torch

    from dmcf_tpu_torch.interop import params_from_flax
    from dmcf_tpu_torch.models import build_model
    from dmcf_tpu_torch.pipelines.simulator import lr_schedule, make_optimizer

    model = build_model(cfg["model"], device="cpu")
    model.load_state_dict(params_from_flax(state["params"]), strict=True)
    pipe = cfg.get("pipeline") or {}
    freq = int(pipe.get("save_ckpt_freq", 1))
    out = {"model": model.state_dict(),
           "epoch": 0 if step is None else int(step) * freq}
    opt_state = state.get("opt_state")
    if opt_state is None:
        return out
    adam, sched = opt_state          # optax.adam: (ScaleByAdam, ScaleBySchedule)
    count, sched_count = int(adam["count"]), int(sched["count"])
    mu, nu = params_from_flax(adam["mu"]), params_from_flax(adam["nu"])
    opt_cfg = dict(pipe.get("optimizer") or {})
    optimizer, scheduler = make_optimizer(model, opt_cfg)
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": mu[name].clone(),
            "exp_avg_sq": nu[name].clone()}
    lr = lr_schedule(opt_cfg)(sched_count)
    for group in optimizer.param_groups:
        group["lr"] = lr
    sd = scheduler.state_dict()
    sd.update(last_epoch=sched_count, _last_lr=[lr] * len(sd["base_lrs"]),
              _step_count=sched_count + 1)
    scheduler.load_state_dict(sd)
    out["optimizer"] = optimizer.state_dict()
    out["scheduler"] = scheduler.state_dict()
    return out


def main(argv=None):
    import jax
    import torch
    import yaml

    jax.config.update("jax_platforms", "cpu")
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("path", help="CheckpointManager step directory or "
                        "bare StandardSave directory")
    parser.add_argument("-c", "--cfg_file", required=True,
                        help="the config the checkpoint was trained with")
    parser.add_argument("-o", "--out_dir", default=".",
                        help="where ckpt_<epoch>.pt goes (the port's "
                             "<logs_dir>/checkpoint to resume there)")
    args = parser.parse_args(argv)
    with open(args.cfg_file) as f:
        cfg = yaml.safe_load(f)
    state, step = read_orbax(args.path)
    out = convert(state, cfg, step)
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, "ckpt_%05d.pt" % out["epoch"])
    torch.save(out, path)
    print(f"wrote {path} (epoch {out['epoch']}, "
          f"{'params and optimizer' if 'optimizer' in out else 'params only'}"
          f")")
    return path


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
