"""Data-parallel training over ranks (port of
dmcf_tpu/parallel/data_parallel.py).

JAX shards the batch dimension over a 1-D mesh, replicates the
parameters, and XLA derives the gradient all-reduce from the shardings.
Here the mesh is the process group (``make_mesh``, one process a rank),
each rank takes its contiguous slice of the SAME global batch
(``shard_batch``; not ``DistributedSampler``, which would change which
items a step sees), the parameters start equal by a broadcast from rank 0
(``replicated_sharding``), and the train step sums the gradients in one
flat all-reduce (``Group.psum_grads``, ``pipelines/simulator.py``).

Usage (one process a rank, e.g. under ``torchrun``):

    group = make_mesh("cuda")                 # cuda:LOCAL_RANK, NCCL
    replicated_sharding(model, group)
    step = make_train_step(model, ..., group=group)
    step(shard_batch(batch, group), time_w)   # batch: the global batch
"""

from __future__ import annotations

from .dist import init_group


#: the data-parallel process group
make_mesh = init_group


def batch_sharding(batch_size, group, rank=None):
    """Rank ``rank``'s (default this rank's) slice of a global batch of
    ``batch_size`` items: the ``batch_size / world_size`` items from
    ``rank * that`` on."""
    if batch_size % group.world_size:
        raise ValueError(f"data parallel: batch {batch_size} not divisible "
                         f"by the world size {group.world_size}")
    per = batch_size // group.world_size
    rank = group.rank if rank is None else rank
    return slice(rank * per, (rank + 1) * per)


def replicated_sharding(module, group):
    """``module``'s parameters and buffers set to rank 0's; returns it."""
    group.broadcast_params(module, src=0)
    return module


def shard_batch(batch, group, rank=None):
    """Rank ``rank``'s (default this rank's) items of a global batch
    dict: every [B, ...] value sliced by ``batch_sharding``; None passes
    through."""
    sl = None
    out = {}
    for k, v in batch.items():
        if v is None:
            out[k] = None
            continue
        if sl is None:
            sl = batch_sharding(len(v), group, rank)
        out[k] = v[sl]
    return out
