"""Multi-GPU paths: data-parallel training and the slab-decomposed halo
step over ``torch.distributed`` (port of dmcf_tpu/parallel; the process
group plumbing in ``dist``)."""

from .data_parallel import (batch_sharding, make_mesh, replicated_sharding,
                            shard_batch)

__all__ = ["make_mesh", "batch_sharding", "replicated_sharding",
           "shard_batch"]
