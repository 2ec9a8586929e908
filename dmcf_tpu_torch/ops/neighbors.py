"""Fixed-radius neighbor search with fixed-shape padded neighbor lists
(port of dmcf_tpu/ops/neighbors.py, dense path).

Conventions kept from the reference: membership by the expansion form
``|q|^2 + |p|^2 - 2 q.p`` clamped at 0 in fp32; the first K valid points
*by index* survive (not the nearest K); ``dist`` (squared) and ``disp``
(``points[idx] - queries``) are recomputed from gathered positions and are
0 on invalid slots; ``count`` is the true in-radius count before capping.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class DensePair(NamedTuple):
    """Dense [Q, N] pair field for the no-neighbor-list conv path.

    rel:   [Q, N, 3] displacement (src - query) / radius; 1.0 where invalid.
    qnorm: [Q, N] squared distance / radius^2; 2.0 where invalid.
    valid: [Q, N] in-radius & both-masks validity.
    count: [Q] true in-radius neighbor count.
    """

    rel: torch.Tensor
    qnorm: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor


class NeighborList(NamedTuple):
    """Padded fixed-K neighbor list.

    idx:   [Q, K] int32 indices into the point array (0 where invalid).
    mask:  [Q, K] bool validity.
    dist:  [Q, K] squared distance (0 where invalid).
    count: [Q] int32 true number of in-radius neighbors (before capping).
    disp:  [Q, K, 3] ``points[idx] - queries`` (0 where invalid).
    """

    idx: torch.Tensor
    mask: torch.Tensor
    dist: torch.Tensor
    count: torch.Tensor
    disp: Optional[torch.Tensor] = None


def select_k_valid(valid, dist, k):
    """Compact the first K valid entries of each row into K slots.

    Returns (idx [Q,K] int32 column indices, mask [Q,K], dist_k [Q,K] or
    None, count [Q] int32).  The (j+1)-th valid column of a row is found by
    a binary search of the row's running count, as the reference does.
    """
    q = valid.shape[0]
    count = valid.sum(dim=1, dtype=torch.int32)
    targets = torch.arange(1, k + 1, dtype=torch.int32, device=valid.device)
    mask = targets[None, :] <= count[:, None]
    csum = torch.cumsum(valid.to(torch.int32), dim=1, dtype=torch.int32)
    idx = torch.searchsorted(csum, targets.expand(q, k).contiguous())
    idx = torch.where(mask, idx, 0).to(torch.int32)
    if dist is None:
        return idx, mask, None, count
    dist_k = torch.where(mask, torch.gather(dist, 1, idx.long()), 0.0)
    return idx, mask, dist_k, count


def fixed_radius_search(points, queries, radius, k, points_mask=None,
                        queries_mask=None, metric: str = "L2",
                        ignore_query_point: bool = False,
                        fast_path_max: int = 8192) -> NeighborList:
    """All points within ``radius`` of each query, capped at K per query
    (squared-L2 comparison and distances).  Only the reference's dense
    single-shot path (N <= ``fast_path_max``) is ported; the chunked
    running-top-K path raises."""
    n = points.shape[0]
    if metric != "L2":
        raise NotImplementedError(f"metric {metric!r} is not ported yet")
    if n > fast_path_max:
        raise NotImplementedError(
            "the chunked running-top-K search (N > fast_path_max) is not "
            "ported yet")
    r = torch.tensor(float(radius), dtype=points.dtype, device=points.device)
    thresh = r * r  # squared in the working dtype, as the reference does
    pm = (torch.ones((n,), dtype=torch.bool, device=points.device)
          if points_mask is None else points_mask.to(torch.bool))
    qn = (queries * queries).sum(dim=-1)
    pn = (points * points).sum(dim=-1)
    cross = queries @ points.T
    d = torch.clamp(qn[:, None] + pn[None, :] - 2.0 * cross, min=0.0)
    valid = (d <= thresh) & pm[None, :]
    if ignore_query_point:
        same = (queries[:, None, :] == points[None, :, :]).all(dim=-1)
        valid &= ~same
    if queries_mask is not None:
        valid &= queries_mask.to(torch.bool)[:, None]
    idx, mask, _, count = select_k_valid(valid, None, k)
    d3 = points[idx.long()] - queries[:, None, :]
    dist = torch.where(mask, (d3 * d3).sum(dim=-1), 0.0)
    disp = torch.where(mask[..., None], d3, 0.0)
    return NeighborList(idx=idx, mask=mask, dist=dist, count=count,
                        disp=disp)


def search(points, queries, radius, k, *, method="auto", points_mask=None,
           queries_mask=None, metric="L2", ignore_query_point=False):
    """Dispatching fixed-radius search.  This port has the brute (dense)
    method only: 'auto' picks it where the reference does (N*Q <= 3e7);
    'cell'/'grid' and the larger problems the reference sends to them
    raise ``NotImplementedError``."""
    if method == "auto":
        if points.shape[0] * queries.shape[0] > 3e7:
            raise NotImplementedError(
                "search(method='auto') at N*Q > 3e7 selects the cell "
                "search, which is not ported yet")
        method = "brute"
    if method != "brute":
        raise NotImplementedError(
            f"search method {method!r} is not ported yet")
    return fixed_radius_search(points, queries, radius, k,
                               points_mask=points_mask,
                               queries_mask=queries_mask, metric=metric,
                               ignore_query_point=ignore_query_point)
