"""Host-side evaluation metrics in numpy and scipy (the port's copy of the
functions of dmcf_tpu/pipelines/metrics.py that the valid suite runs)."""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree
from scipy.stats import entropy


def distance(x, y):
    """Per-particle L2 position error."""
    return np.linalg.norm(x - y, axis=-1)


def chamfer_distance(pred, gt):
    """For each gt point, distance to the nearest pred point."""
    tree = cKDTree(pred)
    d, _ = tree.query(gt)
    return d


def compare_dist(x, y, bin_size=25):
    """KL divergence between d-dimensional histograms of two vector
    distributions (velocity-distribution metric)."""
    x = np.asarray(x)
    y = np.asarray(y)
    assert x.shape == y.shape
    cnt, dim = x.shape[0], x.shape[-1]
    bin_cnt_per_dim = int((cnt // bin_size) ** (1 / dim))
    bin_cnt_per_dim = max(bin_cnt_per_dim, 1)

    both = np.concatenate((x, y), axis=0)
    min_v = np.percentile(both, 5, axis=0)
    max_v = np.percentile(both, 95, axis=0)
    bin_w = (max_v - min_v + 1e-6) / bin_cnt_per_dim

    shape = (bin_cnt_per_dim + 1,) * dim
    bins_x = np.zeros(shape) + 1e-5
    bins_y = np.zeros(shape) + 1e-5

    def to_idx(vals):
        return tuple(np.clip(((vals - min_v) / bin_w).astype("int32"), 0,
                             bin_cnt_per_dim).T)

    np.add.at(bins_x, to_idx(x), 1)
    np.add.at(bins_y, to_idx(y), 1)
    return entropy(bins_x.reshape(-1), bins_y.reshape(-1))


def merge_dicts(dicts, op, start_val=0):
    out = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = op(out.get(k, start_val), v)
    return out
