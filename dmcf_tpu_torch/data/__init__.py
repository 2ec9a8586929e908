from .dataflow import (WindowSampler, batch_samples, get_dataloader,
                       get_normalization_stats, get_rollout,
                       pad_rollout_state)
from .dataset import (Dataset, DatasetGroup, read_msgpack_zst,
                      write_msgpack_zst)
from .generators import gen_free_fall_data, gen_momentum_data
from .writers import write_results

__all__ = [
    "Dataset",
    "DatasetGroup",
    "read_msgpack_zst",
    "write_msgpack_zst",
    "gen_free_fall_data",
    "gen_momentum_data",
    "WindowSampler",
    "batch_samples",
    "get_dataloader",
    "get_normalization_stats",
    "get_rollout",
    "pad_rollout_state",
    "write_results",
]
