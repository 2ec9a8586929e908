"""Spatial (particle-dimension) parallelism for one large scene (port of
dmcf_tpu/parallel/spatial.py).

``make_spatial_mesh`` is the process group, and ``shard_sample`` gives a
rank its contiguous block of every particle array, the layout the JAX
package's mesh sharding gives.  Two steps run over it: the slab halo
(``parallel/halo_model.py``, each rank a slab of space) and
``make_sharded_step``, the port of JAX's GSPMD-partitioned step.

``make_sharded_step`` splits the per-query work by query rows, as GSPMD
splits the jitted step of the JAX package.  The step all-gathers the
sample, so every rank holds every point, and runs the point-side work on
every rank: advection, the boundary crop, the voxel or farthest-point
pyramid (the FPS kernel on every rank, over all rows), the dense layers
and merges, and the equivariant output's own search.  Every search of the
step (``SearchCache``) searches this rank's block of the query rows
against all the points, and every ``ContinuousConv`` (on the card the
K-list kernels, fp32 and bf16) computes those rows alone and all-gathers
them before a later layer reads its neighbours.  Decisions that read a
size (the search method, whether the reference caches a pair's taps, the
lazy dense pairs, the K chunking) read the set's, never the rank's, so
every rank takes the branch one process takes.  A transpose search that
``transpose_search_reuse`` inverts is gathered whole first; the cell
search sorts every query into the one-process query blocks and searches
its share of the blocks.  ``aux`` holds global values: the largest
counts and overflows over the ranks, ``avg_neighbors`` from the summed
counts, and the per-row values gathered.  The step equals one process's:
bit for bit with one rank, and with several wherever each query row is
computed alone (the K-list kernels, the searches); a dense pair's plain
product may block by the rank's rows and differ in the last bits.  A
point set of Q rows gives rank r ``dist.row_block(Q, W, r)``: at most
``ceil(Q / W)`` rows, none empty where Q >= W.  It runs under ``torch.no_grad`` (JAX's step is
``training=False``): its gathers are not differentiated.

On the CPU, ranks spawned over gloo (``tests/test_torch_sharded.py``)::

    from dmcf_tpu_torch.parallel.dist import spawn
    spawn(body, 2)       # body(group): step = make_sharded_step(model,
                         # group); pos, vel, aux = step(shard_sample(s, group))

On the card: ``python3 chip_smoke.py`` phase 26, or alone
``python scripts/torch_multi_rank.py --sharded``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .dist import init_group, row_block


#: the spatial process group
make_spatial_mesh = init_group


def shard_sample(sample, group):
    """This rank's contiguous block of each [N, ...] value of a padded
    sample (N divisible by the world size); None passes through."""
    out = {}
    for k, v in sample.items():
        if v is None:
            out[k] = None
            continue
        n = len(v)
        if n % group.world_size:
            raise ValueError(f"shard_sample: {k} has {n} rows, not "
                             f"divisible by {group.world_size} ranks")
        per = n // group.world_size
        out[k] = v[group.rank * per:(group.rank + 1) * per]
    return out


class Rows(NamedTuple):
    """This rank's block ``lo:hi`` of an ``n``-row query set (the ``rows``
    of a neighbor structure)."""

    split: "RowSplit"
    lo: int
    hi: int
    n: int

    def take(self, t):
        return t[self.lo:self.hi]

    def gather(self, t):
        """Every row of a per-row result ``t`` of these rows."""
        return self.split.gather(t, self.n)


class RowSplit:
    """The query-row split of one sharded step: each point set's block
    for this rank and the collectives that put the rows back together.
    Counts its all-gathers (``gathers``, and ``gather_bytes`` of the
    gathered arrays) and its reductions (``reductions``) since
    ``reset``."""

    def __init__(self, group):
        self.group = group
        self.reset()

    def reset(self):
        self.gathers = self.gather_bytes = self.reductions = 0

    def block(self, n):
        """(lo, hi) of this rank's rows of an n-row set (empty where n is
        below the world size)."""
        return row_block(n, self.group.world_size, self.group.rank)

    def rows(self, n):
        """This rank's ``Rows`` of an n-row query set."""
        if n < self.group.world_size:
            raise ValueError(f"a query set of {n} rows cannot be split "
                             f"over {self.group.world_size} ranks")
        return Rows(self, *self.block(n), n)

    def gather(self, t, n):
        out = self.group.all_gather_rows(t, n)
        self.gathers += 1
        self.gather_bytes += out.numel() * out.element_size()
        return out

    def pmax(self, t):
        self.reductions += 1
        return self.group.pmax(t)

    def psum(self, t):
        self.reductions += 1
        return self.group.psum(t)


def make_sharded_step(model, group):
    """The inference step of a ``PBFNet``-family ``model`` (this rank's
    module, parameters equal on every rank: ``group.broadcast_params``)
    with the query rows split over ``group``'s ranks.  Returns
    ``step(sample_shard) -> (pos, vel, aux)``: ``sample_shard`` is this
    rank's ``shard_sample`` block, ``pos`` and ``vel`` this rank's block
    of the step's rows, ``aux`` the one-process step's, on every rank.
    ``step.split`` counts the last step's collectives."""
    split = RowSplit(group)

    def step(sample_shard):
        split.reset()
        full = {k: None if v is None else
                split.gather(v, v.shape[0] * group.world_size)
                for k, v in sample_shard.items()}
        with torch.no_grad():
            pos, vel, aux = model(full, training=False, split=split)
        lo, hi = row_block(pos.shape[0], group.world_size, group.rank)
        return pos[lo:hi], vel[lo:hi], aux

    step.split = split
    return step
