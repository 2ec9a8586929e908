"""Fixed-radius neighbor search with fixed-shape padded neighbor lists
(port of dmcf_tpu/ops/neighbors.py).

Conventions kept from the reference.  The dense path (N <= ``fast_path_max``)
tests membership by the expansion form ``|q|^2 + |p|^2 - 2 q.p`` clamped
at 0 in fp32 and keeps the first K valid points *by index*; ``dist``
(squared) and ``disp`` (``points[idx] - queries``) are recomputed from
gathered positions and are 0 on invalid slots.  The chunked path (larger
N) scans the points in chunks of direct-difference distances and keeps a
running top-K of the nearest, ties to the lower index as
``jax.lax.top_k`` breaks them; it returns no ``disp``.  ``count`` is the
true in-radius count before capping.  ``search`` dispatches to the
cell-list (``cell_search``) and hash-probe grid (``grid_search``) searches
as the reference does.  Every search takes the reference's three metrics:
"L2" (squared distances against r^2, the dense path by the expansion form),
"L1" and "Linf" (direct differences against r).  ``radius_search`` takes a
radius a query.
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


class LazyDensePair(NamedTuple):
    """Deferred-geometry form of :class:`DensePair` for large pairs: only
    the two point sets; ``ops.cconv.continuous_conv_dense_lazy`` rebuilds
    the pair field a source chunk at a time, so nothing [Q, N]-shaped is
    kept.

    src_pos/src_mask: [N, 3] / [N] source points and validity.
    dst_pos/dst_mask: [Q, 3] / [Q] query points and validity.
    radius: python float search/window radius.
    """

    src_pos: torch.Tensor
    src_mask: torch.Tensor
    dst_pos: torch.Tensor
    dst_mask: torch.Tensor
    radius: float


class NeighborList(NamedTuple):
    """Padded fixed-K neighbor list.

    idx:   [Q, K] int32 indices into the point array (0 where invalid).
    mask:  [Q, K] bool validity.
    dist:  [Q, K] squared distance (0 where invalid).
    count: [Q] int32 true number of in-radius neighbors (before capping).
    cell_overflow: [Q] int32 candidate slots a cell-structured search
           (``cell_search``, ``grid_search``) dropped (> 0: neighbours may
           be lost even where count <= K); None for the other searches.
    disp:  [Q, K, 3] ``points[idx] - queries`` (0 where invalid); None
           where the search did not keep it (chunked, cell, grid).
    """

    idx: torch.Tensor
    mask: torch.Tensor
    dist: torch.Tensor
    count: torch.Tensor
    cell_overflow: Optional[torch.Tensor] = None
    disp: Optional[torch.Tensor] = None


def sq_norm(d):
    """Squared L2 norm over the last axis (of size 3), summed left to
    right as XLA reduces it."""
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
        + d[..., 2] * d[..., 2]


METRICS = ("L2", "L1", "Linf")


def metric_dist(d, metric):
    """The distance of differences ``d`` [..., 3] a search compares:
    squared for "L2", |x| + |y| + |z| for "L1", the largest |coordinate|
    for "Linf" (each reduced left to right, as XLA reduces it)."""
    if metric == "L2":
        return sq_norm(d)
    a = d.abs()
    if metric == "L1":
        return a[..., 0] + a[..., 1] + a[..., 2]
    if metric == "Linf":
        return torch.maximum(torch.maximum(a[..., 0], a[..., 1]), a[..., 2])
    raise NotImplementedError(f"unknown metric: {metric}")


def radius_threshold(radius, metric, like):
    """The bound a metric's distance is held to, in ``like``'s dtype: r^2
    (rounded in that dtype, as the reference does) for L2, else r."""
    if metric not in METRICS:
        raise NotImplementedError(f"unknown metric: {metric}")
    r = torch.tensor(float(radius), dtype=like.dtype, device=like.device)
    return r * r if metric == "L2" else r


_GATHER_SLOTS = 1 << 24  # slots of one [Q, K, 3] gather in recompute_dist


def recompute_dist(points, queries, idx, mask, metric="L2"):
    """Exact distance of each selected neighbour from gathered positions
    (the reference's ``_recompute_dist``: squared for L2), 0 on invalid
    slots.  The [Q, K, 3] gather runs over slices of K of at most
    _GATHER_SLOTS slots (values do not depend on it)."""
    q, k = idx.shape
    kc = max(_GATHER_SLOTS // max(q, 1), 8)
    parts = [metric_dist(points[idx[:, s:s + kc].long()]
                         - queries[:, None, :], metric)
             for s in range(0, k, kc)]
    dist = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return torch.where(mask, dist, 0.0)


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
                        ignore_query_point: bool = False, chunk: int = 4096,
                        fast_path_max: int = 8192) -> NeighborList:
    """All points within ``radius`` of each query, capped at K per query
    (``metric_dist`` against ``radius_threshold``: squared for L2).  N <=
    ``fast_path_max``: the dense single-shot path (the first K by index,
    exact-coincidence ``ignore_query_point``); beyond it the chunked
    running top-K over chunks of ``chunk`` points (the K nearest,
    ``ignore_query_point`` as d > 0, no ``disp``)."""
    n = points.shape[0]
    thresh = radius_threshold(radius, metric, points)
    if n > fast_path_max:
        return _chunked_search(points, queries, thresh, k, points_mask,
                               queries_mask, ignore_query_point, chunk,
                               metric)
    pm = (torch.ones((n,), dtype=torch.bool, device=points.device)
          if points_mask is None else points_mask.to(torch.bool))
    if metric == "L2":
        qn = (queries * queries).sum(dim=-1)
        pn = (points * points).sum(dim=-1)
        cross = queries @ points.T
        d = torch.clamp(qn[:, None] + pn[None, :] - 2.0 * cross, min=0.0)
    else:
        d = metric_dist(queries[:, None, :] - points[None, :, :], metric)
    valid = (d <= thresh) & pm[None, :]
    if ignore_query_point:
        same = (queries[:, None, :] == points[None, :, :]).all(dim=-1)
        valid &= ~same
    if queries_mask is not None:
        valid &= queries_mask.to(torch.bool)[:, None]
    idx, mask, _, count = select_k_valid(valid, None, k)
    d3 = points[idx.long()] - queries[:, None, :]
    dist = torch.where(mask, (d3 * d3).sum(dim=-1) if metric == "L2"
                       else metric_dist(d3, metric), 0.0)
    disp = torch.where(mask[..., None], d3, 0.0)
    return NeighborList(idx=idx, mask=mask, dist=dist, count=count,
                        disp=disp)


def _chunked_search(points, queries, thresh, k, points_mask, queries_mask,
                    ignore_query_point, chunk, metric="L2"):
    """The reference's chunked scan: per chunk of points the [Q, C]
    direct-difference distances fold into a running top-K.  A stable sort
    of the concatenated (kept, new) distances keeps the lower position on
    ties, as ``lax.top_k`` does, so the kept set matches under overflow."""
    n, q = points.shape[0], queries.shape[0]
    dev = points.device
    chunk = min(chunk, max(n, 1))
    pm = (torch.ones((n,), dtype=torch.bool, device=dev)
          if points_mask is None else points_mask.to(torch.bool))
    best_d = torch.full((q, k), torch.inf, dtype=points.dtype, device=dev)
    best_i = torch.zeros((q, k), dtype=torch.int32, device=dev)
    count = torch.zeros((q,), dtype=torch.int32, device=dev)
    for base in range(0, n, chunk):
        # the last chunk is as wide as the others, its tail masked off, as
        # the reference pads it (zero positions, invalid)
        pts = points[base:base + chunk]
        mask_c = pm[base:base + chunk]
        if pts.shape[0] < chunk:
            pad = chunk - pts.shape[0]
            pts = torch.cat([pts, pts.new_zeros((pad, 3))])
            mask_c = torch.cat([mask_c, mask_c.new_zeros((pad,))])
        d = metric_dist(queries[:, None, :] - pts[None, :, :], metric)
        valid = (d <= thresh) & mask_c[None, :]
        if ignore_query_point:
            valid &= d > 0
        count += valid.sum(dim=1, dtype=torch.int32)
        cat_d = torch.cat([best_d, torch.where(valid, d, torch.inf)], dim=1)
        idx_c = torch.arange(base, base + chunk, dtype=torch.int32,
                             device=dev)
        cat_i = torch.cat([best_i, idx_c.expand(q, chunk)], dim=1)
        best_d, arg = torch.sort(cat_d, dim=1, stable=True)
        best_d = best_d[:, :k].contiguous()
        best_i = torch.gather(cat_i, 1, arg[:, :k])
    mask = torch.isfinite(best_d)
    if queries_mask is not None:
        qm = queries_mask.to(torch.bool)
        mask &= qm[:, None]
        count = torch.where(qm, count, 0)
    return NeighborList(idx=torch.where(mask, best_i, 0), mask=mask,
                        dist=torch.where(mask, best_d, 0.0), count=count)


def batched_fixed_radius_search(points, queries, radii, k, points_mask=None,
                                queries_mask=None,
                                metric: str = "L2") -> NeighborList:
    """P stacked (points [P, N, 3], queries [P, Q, 3], radius) problems,
    each through the dense path (the reference vmaps it with
    ``fast_path_max`` = N): a NeighborList with a leading pair axis."""
    p = points.shape[0]
    nls = [fixed_radius_search(
        points[i], queries[i], float(radii[i]), k,
        points_mask=None if points_mask is None else points_mask[i],
        queries_mask=None if queries_mask is None else queries_mask[i],
        metric=metric, fast_path_max=points.shape[1]) for i in range(p)]
    return NeighborList(*(torch.stack(f) if f[0] is not None else None
                          for f in zip(*nls)))


def search(points, queries, radius, k, *, method="auto", points_mask=None,
           queries_mask=None, metric="L2", ignore_query_point=False,
           cell_cap=32, planar_axis=None, occ_cap=128):
    """Dispatching fixed-radius search, as the reference's: 'cell' (the
    sorted-window cell list), 'grid' (the hash-probe cell list), 'brute'
    (``fixed_radius_search``), or 'auto': the cell search where N*Q > 3e7,
    else brute."""
    if method == "auto":
        method = ("cell" if points.shape[0] * queries.shape[0] > 3e7
                  else "brute")
    if method == "cell":
        from .cell_search import cell_fixed_radius_search
        return cell_fixed_radius_search(
            points, queries, radius, k, points_mask=points_mask,
            queries_mask=queries_mask, metric=metric,
            ignore_query_point=ignore_query_point, occ_cap=occ_cap)
    if method == "grid":
        from .grid_search import grid_fixed_radius_search
        return grid_fixed_radius_search(
            points, queries, radius, k, points_mask=points_mask,
            queries_mask=queries_mask, metric=metric,
            ignore_query_point=ignore_query_point, cell_cap=cell_cap,
            planar_axis=planar_axis)
    return fixed_radius_search(points, queries, radius, k,
                               points_mask=points_mask,
                               queries_mask=queries_mask, metric=metric,
                               ignore_query_point=ignore_query_point)


def radius_search(points, queries, radii, k, points_mask=None,
                  queries_mask=None, metric: str = "L2",
                  ignore_query_point: bool = False,
                  normalize_distances: bool = True) -> NeighborList:
    """Per-query-radius search (the reference's ``radius_search``, Open3D's
    ``RadiusSearch``): brute force over all points, each query ``radii``
    [Q] its own radius (squared for L2, ``radius_threshold``); the K
    nearest by distance, ties to the lower index (``lax.top_k``'s rule, a
    stable sort), no ``disp``.  With ``normalize_distances`` the distances
    are divided by the query's threshold."""
    d = metric_dist(queries[:, None, :] - points[None, :, :], metric)
    radii = torch.as_tensor(radii, dtype=points.dtype, device=points.device)
    thresh = radii * radii if metric == "L2" else radii
    valid = d <= thresh[:, None]
    if points_mask is not None:
        valid &= points_mask.to(torch.bool)[None, :]
    if queries_mask is not None:
        valid &= queries_mask.to(torch.bool)[:, None]
    if ignore_query_point:
        valid &= d > 0
    count = valid.sum(dim=1, dtype=torch.int32)
    if normalize_distances:
        d = d / torch.clamp(thresh[:, None], min=1e-20)
    d_m = torch.where(valid, d, torch.inf)
    if d_m.shape[1] < k:  # top_k of fewer than K columns pads with inf
        d_m = torch.cat([d_m, d_m.new_full((d_m.shape[0],
                                            k - d_m.shape[1]), torch.inf)],
                        dim=1)
    best, idx = torch.sort(d_m, dim=1, stable=True)
    best, idx = best[:, :k], idx[:, :k]
    mask = torch.isfinite(best)
    return NeighborList(idx=torch.where(mask, idx, 0).to(torch.int32),
                        mask=mask, dist=torch.where(mask, best, 0.0),
                        count=count)


def invert_neighbors_list(nl: NeighborList, num_points: int,
                          k_out: int) -> NeighborList:
    """Transpose a padded neighbor list: for each of ``num_points`` input
    points, the queries that list it, in ascending query row (a stable
    sort of the flattened pairs by input index), capped at ``k_out``;
    ``count`` is the number of pairs that name it.  Distances carry over,
    displacements flip sign.  An L2 ball is symmetric, so the inverse of a
    search A->B is the search B->A wherever the forward list kept every
    in-radius neighbour (``SearchCache``'s ``transpose_reuse``)."""
    q, k = nl.idx.shape
    dev = nl.idx.device
    flat_idx = torch.where(nl.mask, nl.idx, num_points).reshape(-1)
    rows = torch.arange(q * k, dtype=torch.int32, device=dev) // k
    sorted_idx, order = torch.sort(flat_idx, stable=True)
    targets = torch.arange(num_points, dtype=sorted_idx.dtype, device=dev)
    starts = torch.searchsorted(sorted_idx, targets, side="left")
    ends = torch.searchsorted(sorted_idx, targets, side="right")
    counts = (ends - starts).to(torch.int32)
    slot = torch.arange(k_out, device=dev)
    valid = slot[None, :] < counts[:, None]
    gather = order[torch.clamp(starts[:, None] + slot[None, :], 0,
                               q * k - 1)]
    out_idx = torch.where(valid, rows[gather], 0).to(torch.int32)
    out_dist = torch.where(valid, nl.dist.reshape(-1)[gather], 0.0)
    disp = None
    if nl.disp is not None:
        disp = torch.where(valid[..., None],
                           -nl.disp.reshape(q * k, -1)[gather], 0.0)
    return NeighborList(idx=out_idx, mask=valid, dist=out_dist,
                        count=counts, disp=disp)
