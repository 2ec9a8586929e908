"""The ops' public names (the JAX package's ``dmcf_tpu.ops`` exports).

Resolved at first access: the kernel wrappers import ``ops.coords``, so
importing the ops modules here, at import time, would be circular."""

import importlib

_WHERE = {
    "NeighborList": ".neighbors",
    "fixed_radius_search": ".neighbors",
    "invert_neighbors_list": ".neighbors",
    "radius_search": ".neighbors",
    "search": ".neighbors",
    "grid_fixed_radius_search": ".grid_search",
    "continuous_conv": ".cconv",
    "point_sampling": ".cconv",
    "reduce_neighbor_count": ".cconv",
    "build_symmetric_kernel": ".cconv",
    "build_circular_kernel": ".cconv",
    "get_window_func": ".windows",
    "farthest_point_sample": "..kernels.fps",
    **dict.fromkeys(
        ("align_vector", "compute_density", "compute_pressure",
         "compute_transformed_dx", "get_dilated_pos", "grid_pos",
         "masked_positions", "nn_distance", "pad_sentinel_positions",
         "prob_sample", "quat_conj", "quat_mean", "quat_mult", "quat_rot"),
        ".sph"),
}

__all__ = list(_WHERE)


def __getattr__(name):
    if name not in _WHERE:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(_WHERE[name], __name__), name)


def __dir__():
    return sorted(set(globals()) | set(__all__))
