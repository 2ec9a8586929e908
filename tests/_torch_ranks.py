"""Rank bodies of the port's multi-process CPU tests.

``dmcf_tpu_torch.parallel.dist.spawn`` starts each rank in a new process
that imports the module of the function it runs, so the bodies live here,
in a module that imports no JAX (the tests that spawn them do).  Each
takes the rank's ``Group`` first and returns CPU tensors or numpy.
"""

import numpy as np
import torch

from dmcf_tpu_torch.models import build_model
from dmcf_tpu_torch.parallel.halo import make_halo_search_conv, shard_parts
from dmcf_tpu_torch.parallel.halo_model import (halo_rollout_host,
                                                make_halo_model_step,
                                                shard_model_parts)


def _model(cfg, state):
    model = build_model(dict(cfg), device="cpu")
    model.load_state_dict(state)
    return model


def halo_search(group, parts, kernel, radius, k, halo_cap, small_cap):
    """This rank's neighbour counts and conv rows, and the halo overflow
    at ``halo_cap`` and at ``small_cap``."""
    from dmcf_tpu_torch.ops.windows import get_window_func

    mine = shard_parts(parts, group.rank, "cpu")
    run = make_halo_search_conv(group, radius=radius, k=k, halo_cap=halo_cap,
                                window_fn=get_window_func("poly6"))
    counts, over = run(mine)
    conv, over_conv = run(mine, torch.as_tensor(kernel))
    _, over_small = make_halo_search_conv(
        group, radius=radius, k=k, halo_cap=small_cap)(mine)
    return {"counts": counts, "conv": conv, "over": int(over),
            "over_conv": int(over_conv), "over_small": int(over_small)}


def halo_step(group, cfg, state, parts, halo_width, halo_cap, target):
    """This rank's halo step, its loss against ``target`` (this rank's
    [fcap, 2, 3] rows) and the loss's parameter gradients summed over the
    ranks."""
    model = _model(cfg, state)
    mine = shard_model_parts(parts, group.rank, "cpu")
    step = make_halo_model_step(model, group, halo_width=halo_width,
                                halo_cap=halo_cap, axis=parts["axis"])
    with torch.no_grad():
        p, v, aux = step(mine)
    loss = step.loss(mine, torch.as_tensor(target[group.rank]), w_pos=1.0,
                     w_vel=0.5)
    loss.backward()
    group.psum_grads(model.parameters())
    return {"pos": p, "vel": v, "aux": aux, "loss": float(loss),
            "grads": {n: q.grad for n, q in model.named_parameters()}}


def halo_rollout(group, cfg, state, sample, n_steps, kw):
    """``halo_rollout_host`` on this rank (frames and report)."""
    model = _model(cfg, state)
    return halo_rollout_host(model, group, sample, n_steps, **kw)


def exchange_grad(group):
    """``Group.exchange`` of a tensor that requires a gradient (raises)."""
    x = torch.zeros(4, 3, requires_grad=True)
    try:
        group.exchange(x, x.detach())
    except ValueError as e:
        return str(e)
    return None


def dp_train(group, cfg, state, batch, window, opt_cfg, loss_cfg):
    """One data-parallel train step on this rank's slice of ``batch``;
    returns its loss vector, warm-up counts and the parameters after it."""
    from dmcf_tpu_torch.models.losses import get_loss
    from dmcf_tpu_torch.parallel import replicated_sharding, shard_batch
    from dmcf_tpu_torch.pipelines.simulator import (make_optimizer,
                                                    make_train_step)

    model = build_model(dict(cfg), device="cpu",
                        generator=torch.Generator().manual_seed(group.rank))
    if group.rank == 0:
        model.load_state_dict(state)
    replicated_sharding(model, group)   # the other ranks take rank 0's
    losses = {k: get_loss(**v) for k, v in loss_cfg.items()}
    step = make_train_step(model, losses, *make_optimizer(model, opt_cfg),
                           window=window, group=group)
    mine = {k: torch.as_tensor(v) for k, v in
            shard_batch(batch, group).items() if v is not None}
    lvec, pre, _ = step(mine, np.ones(window, np.float32))
    return {"lvec": lvec, "pre": pre,
            "params": {n: q.detach().clone()
                       for n, q in model.named_parameters()},
            "grads": {n: q.grad.clone() for n, q in model.named_parameters()}}


def run_sample_rank_dirs(group, argv, out_dirs):
    """``run_sample.main`` on this rank (the group already up), writing
    under ``out_dirs[rank]``."""
    from dmcf_tpu_torch import run_sample

    return run_sample.main(argv + ["--output_dir", out_dirs[group.rank]])


def run_pipeline_main(group, workdir, args):
    """``run_pipeline.main(args)`` on this rank from ``workdir`` (the group
    already up); returns its logged train steps and what rank 0 wrote."""
    import os

    from dmcf_tpu_torch import run_pipeline

    os.chdir(workdir)
    logged = run_pipeline.main(args)
    return {"logged": logged,
            "ckpts": sorted(os.listdir(os.path.join(
                "logs", "SymNet_Momentum_momentum", "checkpoint")))
            if os.path.isdir(os.path.join("logs", "SymNet_Momentum_momentum",
                                          "checkpoint")) else []}


def _conv_rows(neighbors):
    """(query rows, slots or sources, rows of the whole set) of a
    ContinuousConv call's neighbor structure."""
    from dmcf_tpu_torch.ops.neighbors import DensePair, LazyDensePair

    if isinstance(neighbors, LazyDensePair):
        q, k = neighbors.dst_pos.shape[0], neighbors.src_pos.shape[0]
    elif isinstance(neighbors, DensePair):
        q, k = neighbors.rel.shape[:2]
    else:
        q, k = neighbors.idx.shape
    return q, k, q if neighbors.rows is None else neighbors.rows.n


def record_conv_rows(model):
    """Forward hooks on every ContinuousConv of ``model``: the returned
    list gets each call's ``_conv_rows``."""
    from dmcf_tpu_torch.models.layers import ContinuousConv

    calls = []
    for m in model.modules():
        if isinstance(m, ContinuousConv):
            m.register_forward_hook(
                lambda mod, args, out: calls.append(_conv_rows(args[4])))
    return calls


def sharded_step(group, cfg, state, sample):
    """The particle-sharded step (``parallel.spatial.make_sharded_step``)
    on this rank's ``shard_sample`` block: its pos/vel block, aux, every
    ContinuousConv call's rows and the step's collectives."""
    from dmcf_tpu_torch.parallel.spatial import (make_sharded_step,
                                                 shard_sample)

    model = _model(cfg, state)
    calls = record_conv_rows(model)
    step = make_sharded_step(model, group)
    mine = {k: None if v is None else torch.as_tensor(v)
            for k, v in shard_sample(sample, group).items()}
    pos, vel, aux = step(mine)
    split = step.split
    return {"pos": pos, "vel": vel, "aux": aux, "calls": calls,
            "gathers": split.gathers, "gather_bytes": split.gather_bytes,
            "reductions": split.reductions}


def sharded_cases(group, cases):
    """``sharded_step`` of each case ((model config, state dict, numpy
    sample) by name), beside the one-process step in this rank (its
    pos, vel, aux and conv calls as ``ref_*`` and ``one_calls``)."""
    out = {}
    for name, (cfg, state, sample) in cases.items():
        one = _model(cfg, state)
        one_calls = record_conv_rows(one)
        with torch.no_grad():
            pos, vel, aux = one({k: torch.as_tensor(v)
                                 for k, v in sample.items()})
        out[name] = dict(sharded_step(group, cfg, state, sample),
                         ref_pos=pos, ref_vel=vel, ref_aux=aux,
                         one_calls=one_calls)
    return out
