"""Spatial (particle-dimension) parallelism for one large scene: the
process group and the sample layout (port of the group half of
dmcf_tpu/parallel/spatial.py).

``make_spatial_mesh`` is the group that ``run_sample --spatial halo``
runs over, and ``shard_sample`` gives a rank its contiguous block of
every particle array, the layout the JAX package's mesh sharding gives.
The decomposition that runs a step is the slab halo
(``parallel/halo_model.py``).  JAX's ``make_sharded_step`` (GSPMD's
automatic partitioning of one jitted step) has no PyTorch counterpart and
is not ported (ROADMAP queue 1).
"""

from __future__ import annotations

from .dist import init_group


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
