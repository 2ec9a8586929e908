"""Hash-probe cell-list fixed-radius search (port of
dmcf_tpu/ops/grid_search.py).

Points are binned into cells of edge ``radius`` by a stable sort of their
hashed cell keys; each query probes its 27 (9 with ``planar_axis``)
neighbour cells by ``searchsorted`` ranges, takes up to ``cell_cap``
candidates a cell, keeps those whose exact integer cell is the probed one
(which removes hash collisions and duplicates) and lie within the radius,
and compacts them into K slots by position.  A cell holding more than
``cell_cap`` points is reported per query in ``cell_overflow``.

``_hash_cells`` is the reference's uint32 mix computed in int64 held to
32 bits (PyTorch's uint32 arithmetic is incomplete); its hashes equal the
reference's bit for bit.
"""

from __future__ import annotations

from itertools import product

import torch

from .neighbors import (NeighborList, metric_dist, radius_threshold,
                        recompute_dist, select_k_valid)

_KEY_MAX = 2 ** 31 - 1
_M32 = 0xFFFFFFFF


def _mul32(h, c):
    """(h * c) mod 2^32 for h in [0, 2^32) int64 and a 32-bit constant c,
    in two 16-bit halves so that no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def _hash_cells(c):
    """[..., 3] int32 cell coords -> int32 hash (the reference's
    murmur-style mix, non-negative so the invalid key sorts last)."""
    c = c.to(torch.int64) & _M32          # the int32 -> uint32 view
    h = (_mul32(c[..., 0], 73856093) ^ _mul32(c[..., 1], 19349663)
         ^ _mul32(c[..., 2], 83492791))
    h = h ^ (h >> 13)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 16)
    return (h % 2147483629).to(torch.int32)


def _cell_coords(pos, radius):
    r = torch.tensor(float(radius), dtype=pos.dtype, device=pos.device)
    return torch.floor(pos * (1.0 / r)).to(torch.int32)


def contact_weight(points, queries, radius, points_mask=None,
                   queries_mask=None):
    """Per-query point count over the query's 27 hashed cells: > 0 for
    every query within ``radius`` of a point (a superset of the contact
    set: farther points and hash collisions also count).  int32 [Q]."""
    n = points.shape[0]
    dev = points.device
    pm = (torch.ones((n,), dtype=torch.bool, device=dev)
          if points_mask is None else points_mask.to(torch.bool))
    key = torch.where(pm, _hash_cells(_cell_coords(points, radius)),
                      _KEY_MAX)
    skey = torch.sort(key).values
    offsets = torch.tensor(list(product((-1, 0, 1), repeat=3)),
                           dtype=torch.int32, device=dev)
    cq = _cell_coords(queries, radius)
    probe = _hash_cells(cq[:, None, :] + offsets[None, :, :]).reshape(-1)
    lo = torch.searchsorted(skey, probe)
    hi = torch.searchsorted(skey, probe, side="right")
    wgt = (hi - lo).reshape(-1, 27).sum(dim=1).to(torch.int32)
    if queries_mask is not None:
        wgt = torch.where(queries_mask.to(torch.bool), wgt, 0)
    return wgt


def grid_fixed_radius_search(points, queries, radius, k, points_mask=None,
                             queries_mask=None, metric: str = "L2",
                             ignore_query_point: bool = False,
                             cell_cap: int = 32, planar_axis=None,
                             query_chunk: int = 8192) -> NeighborList:
    """Fixed-radius search by hashed cells (module docstring); queries in
    chunks of ``query_chunk`` (results do not depend on it)."""
    n, q = points.shape[0], queries.shape[0]
    dev = points.device
    thresh = radius_threshold(radius, metric, points)
    pm = (torch.ones((n,), dtype=torch.bool, device=dev)
          if points_mask is None else points_mask.to(torch.bool))
    qm = (torch.ones((q,), dtype=torch.bool, device=dev)
          if queries_mask is None else queries_mask.to(torch.bool))

    cp = _cell_coords(points, radius)
    key = torch.where(pm, _hash_cells(cp), _KEY_MAX)
    order = torch.argsort(key, stable=True)
    skey = key[order]
    axes = [(-1, 0, 1)] * 3
    if planar_axis is not None:
        axes[planar_axis] = (0,)
    offsets = torch.tensor(list(product(*axes)), dtype=torch.int32,
                           device=dev)
    n_off = offsets.shape[0]
    sorted_points, sorted_cells, sorted_mask = (points[order], cp[order],
                                                pm[order])
    slots = torch.arange(cell_cap, dtype=torch.int64, device=dev)

    def process(qs, qmask):
        c = qs.shape[0]
        probe_cells = _cell_coords(qs, radius)[:, None, :] + offsets
        probe_keys = _hash_cells(probe_cells).reshape(-1)
        lo = torch.searchsorted(skey, probe_keys).reshape(c, n_off)
        hi = torch.searchsorted(skey, probe_keys,
                                side="right").reshape(c, n_off)
        cand_pos = lo[..., None] + slots                   # [C, O, cap]
        in_range = cand_pos < hi[..., None]
        cell_over = torch.clamp(hi - lo - cell_cap, min=0)
        flat = cand_pos.clamp(0, max(n - 1, 0)).reshape(c, -1)
        cand_cells = sorted_cells[flat].reshape(c, n_off, cell_cap, 3)
        exact = (cand_cells == probe_cells[:, :, None, :]).all(dim=-1)
        valid = (in_range & exact).reshape(c, -1) & sorted_mask[flat]
        dist = metric_dist(qs[:, None, :] - sorted_points[flat], metric)
        valid &= dist <= thresh
        if ignore_query_point:
            valid &= dist > 0
        valid &= qmask[:, None]
        sel, mask_k, _, count = select_k_valid(valid, None, k)
        idx = torch.where(
            mask_k, order[torch.gather(flat, 1, sel.long())], 0)
        dist_k = recompute_dist(points, qs, idx, mask_k, metric)
        return (idx.to(torch.int32), mask_k, dist_k, count,
                cell_over.sum(dim=1).to(torch.int32))

    outs = [process(queries[s:s + query_chunk], qm[s:s + query_chunk])
            for s in range(0, q, query_chunk)]
    idx, mask_k, dist_k, count, cell_over = (torch.cat(x)
                                             for x in zip(*outs))
    return NeighborList(idx=idx, mask=mask_k, dist=dist_k, count=count,
                        cell_overflow=cell_over)
