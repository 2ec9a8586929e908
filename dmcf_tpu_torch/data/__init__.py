from .dataflow import (Prefetcher, WindowSampler, batch_samples,
                       get_dataloader, get_normalization_stats, get_rollout,
                       pad_rollout_state)
from .dataset import (Dataset, DatasetGroup, read_msgpack_zst,
                      write_msgpack_zst)
from .generators import (SPH1D, gen_column_data, gen_free_fall_data,
                         gen_momentum_data)
from .writers import read_results, write_results

__all__ = [
    "Dataset",
    "DatasetGroup",
    "read_msgpack_zst",
    "write_msgpack_zst",
    "SPH1D",
    "gen_column_data",
    "gen_free_fall_data",
    "gen_momentum_data",
    "WindowSampler",
    "Prefetcher",
    "batch_samples",
    "get_dataloader",
    "get_normalization_stats",
    "get_rollout",
    "pad_rollout_state",
    "read_results",
    "write_results",
]
