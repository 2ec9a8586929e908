"""Host-side evaluation metrics in numpy and scipy (the port's copy of
dmcf_tpu/pipelines/metrics.py)."""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment
from scipy.spatial import cKDTree, distance_matrix
from scipy.stats import entropy


def to_host(x):
    """A tensor or an array as a numpy array."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else \
        np.asarray(x)


def distance(x, y):
    """Per-particle L2 position error."""
    return np.linalg.norm(x - y, axis=-1)


def optimal_assignment_distance(x, y):
    """The distances of the pairs of the assignment of x's points to y's
    that minimises their sum."""
    dist = distance_matrix(x, y)
    rows, cols = linear_sum_assignment(dist)
    return dist[rows, cols]


def chamfer_distance(pred, gt):
    """For each gt point, distance to the nearest pred point."""
    tree = cKDTree(pred)
    d, _ = tree.query(gt)
    return d


def chamfer_loss(target, pred, mask=None, fac=1.0, mode=0, **kw):
    """The mean chamfer distance of the valid points as a loss (mode 0:
    target to prediction, else the other way), on the host: a float, no
    gradient."""
    t, p = to_host(target), to_host(pred)
    if mask is not None:
        m = to_host(mask).astype(bool)
        t, p = t[m], p[m]
    if mode > 0:
        t, p = p, t
    return fac * float(np.mean(chamfer_distance(p, t)))


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


def compute_stats(x):
    return {
        "mean": np.mean(x),
        "mse": np.mean(x**2),
        "var": np.var(x),
        "min": np.min(x),
        "max": np.max(x),
        "median": np.median(x),
        "num_particles": x.shape[0],
    }


def merge_dicts(dicts, op, start_val=0):
    out = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = op(out.get(k, start_val), v)
    return out
