"""Sorted-window cell-list fixed-radius search and the exact contact count
(port of dmcf_tpu/ops/cell_search.py).

Cells of edge ``radius``, shifted by the scene's min cell so probe offsets
never go negative, are packed into one int32 linear id ``(cz * G + cy) * G
+ cx`` with G = 1024.  After one stable sort of the points by id, each
(cz, cy, cx-1..cx+1) run of three cells is a contiguous range of the
sorted array, so a query's 27 cells are 9 windows.  Queries are sorted by
id too and taken in blocks of ``block_q``; a block reads the union of its
queries' windows (``searchsorted`` bounds, side "left"), at most
W = 3 * ``occ_cap`` rows a window.  A running max over the windows' ends
drops rows that an earlier window of the block already covered, the
in-radius candidates are compacted into K slots by index
(``select_k_valid``) and their distances recomputed from the positions.
A window that needed more than W rows, or a scene wider than G - 2 cells
on an axis, is reported per query in ``cell_overflow``.

Sorts are stable, as ``jnp.argsort`` is: cell ids tie all the time, and
the tie order decides the neighbour order and, under overflow, which
neighbours survive.  Chunking over blocks (and over queries in the
contact count) bounds each [chunk, ..., 3] transient by
``TRANSIENT_BYTES``; results do not depend on it.
"""

from __future__ import annotations

import torch

from .neighbors import (NeighborList, metric_dist, radius_threshold,
                        recompute_dist, select_k_valid, sq_norm, take_rows,
                        to_int32_saturating)

_G = 1024  # virtual grid cells per axis (scene must fit G-2 per axis)
_INVALID_ID = 2 ** 30
_I32_MAX = 2 ** 31 - 1
TRANSIENT_BYTES = 2 << 30  # bound of one chunk's [.., 3] fp32 difference


def _cells(pos, inv_cell):
    """Integer cells, saturating as XLA does (a masked sentinel row, 1e9
    and up, lands at the int32 bound on every device)."""
    return to_int32_saturating(torch.floor(pos * inv_cell))


def _linear_ids(c):
    return (c[..., 2] * _G + c[..., 1]) * _G + c[..., 0]


def cell_fixed_radius_search(points, queries, radius, k, points_mask=None,
                             queries_mask=None, metric: str = "L2",
                             ignore_query_point: bool = False,
                             occ_cap: int = 64, block_q: int = 32,
                             block_chunk: int = 1024,
                             rows=None) -> NeighborList:
    """Fixed-radius search by the sorted-window cell list (module
    docstring): the in-radius points of each query capped at K by sorted
    position, ``count`` the true count seen, ``cell_overflow`` the rows its
    block's windows dropped (plus 2^20 where the scene's span does not fit
    the grid).

    ``rows`` (the sharded step's block of the query rows): a block's
    windows span its queries, so the list depends on which queries share a
    block.  Every rank sorts all the queries into the one-process blocks,
    searches its share of the blocks, gathers the blocks' slots and
    returns the list of its ``rows``: the one-process list's rows, window
    drops included."""
    n, q = points.shape[0], queries.shape[0]
    dev, dt = points.device, points.dtype
    r = torch.tensor(float(radius), dtype=dt, device=dev)
    thresh = radius_threshold(radius, metric, points)
    pm = (torch.ones((n,), dtype=torch.bool, device=dev)
          if points_mask is None else points_mask.to(torch.bool))
    qm = (torch.ones((q,), dtype=torch.bool, device=dev)
          if queries_mask is None else queries_mask.to(torch.bool))

    w = 3 * occ_cap
    n_blocks = -(-q // block_q)
    q_pad = n_blocks * block_q

    inv_cell = 1.0 / r
    cp = _cells(points, inv_cell)
    cq = _cells(queries, inv_cell)

    # shift by the joint min cell - 1: coordinates land in [1, span + 1]
    big = torch.tensor(_I32_MAX, dtype=torch.int32, device=dev)
    cmin = torch.minimum(
        torch.where(pm[:, None], cp, big).amin(dim=0),
        torch.where(qm[:, None], cq, big).amin(dim=0)) - 1
    cmax = torch.maximum(
        torch.where(pm[:, None], cp, -big).amax(dim=0),
        torch.where(qm[:, None], cq, -big).amax(dim=0))
    span_bad = ((cmax - cmin) >= (_G - 1)).any()
    cp = cp - cmin
    cq = cq - cmin

    # points sorted by cell id (invalid rows last), then W far rows so a
    # window starting at the end still reads W rows
    invalid = torch.tensor(_INVALID_ID, dtype=torch.int32, device=dev)
    pkey = torch.where(pm, _linear_ids(cp), invalid)
    order = torch.argsort(pkey, stable=True).to(torch.int32)
    skey = pkey[order.long()]
    far = torch.tensor(2e9, dtype=dt, device=dev)
    spts_pad = torch.cat(
        [points[order.long()],
         far + torch.arange(w, dtype=dt, device=dev)[:, None]
         * torch.ones((1, 3), dtype=dt, device=dev)], dim=0)

    # queries sorted by cell id, padded to whole blocks
    qkey = torch.where(qm, _linear_ids(cq), invalid)
    qorder = torch.argsort(qkey, stable=True).to(torch.int32)
    sqk = torch.cat([qkey[qorder.long()],
                     invalid.expand(q_pad - q)])
    sqry = torch.cat([queries[qorder.long()],
                      torch.full((q_pad - q, 3), 2e9, dtype=dt,
                                 device=dev)])

    kb = sqk.reshape(n_blocks, block_q)
    bvalid = kb < _INVALID_ID
    first = torch.where(bvalid, kb, invalid).amin(dim=1)
    last = torch.where(bvalid, kb, -1).amax(dim=1)

    # window bounds: 9 (dz, dy) offsets x the block's x-run union
    offs = torch.tensor([(dz * _G + dy) * _G for dz in (-1, 0, 1)
                         for dy in (-1, 0, 1)], dtype=torch.int32,
                        device=dev)
    lo_id = first[:, None] + offs[None, :] - 1
    hi_id = last[:, None] + offs[None, :] + 2           # exclusive
    lo = torch.searchsorted(skey, lo_id.reshape(-1).contiguous(),
                            side="left", out_int32=True).reshape(n_blocks, 9)
    hi = torch.searchsorted(skey, hi_id.reshape(-1).contiguous(),
                            side="left", out_int32=True).reshape(n_blocks, 9)
    hi = torch.maximum(hi, lo)
    cnt = hi - lo
    win_over = torch.clamp(cnt - w, min=0).sum(dim=1, dtype=torch.int32)
    cnt = torch.clamp(cnt, max=w)

    jw = torch.arange(w, dtype=torch.int32, device=dev)
    sq_blocks = sqry.reshape(n_blocks, block_q, 3)
    neg1 = torch.full((1,), -1, dtype=torch.int32, device=dev)

    def process(lo_c, cnt_c, qblk, qv):
        bc = lo_c.shape[0]
        rows = (lo_c[:, :, None] + jw).long()            # [bc, 9, W]
        cand = spts_pad[rows].reshape(bc, 1, 9 * w, 3)
        dist = metric_dist(qblk[:, :, None, :] - cand, metric)  # [bc,bq,9W]
        in_win = jw[None, None, :] < cnt_c[:, :, None]
        # a later offset's window may re-cover rows of an earlier one: a
        # row is a duplicate iff it lies below the running max of the
        # earlier windows' ends
        m = torch.cummax(lo_c + cnt_c, dim=1).values
        m = torch.cat([neg1.expand(bc, 1), m[:, :-1]], dim=1)
        in_win &= (lo_c[:, :, None] + jw) >= m[:, :, None]
        valid = in_win.reshape(bc, 1, 9 * w) & (dist <= thresh)
        if ignore_query_point:
            valid &= dist > 0
        valid &= qv[:, :, None]
        sel, kmask, _, count = select_k_valid(
            valid.reshape(bc * block_q, 9 * w), None, k)
        off_sel = (sel // w).long()
        pos_sorted = torch.gather(
            lo_c.repeat_interleave(block_q, dim=0), 1, off_sel) + sel % w
        return (pos_sorted.reshape(bc, block_q, k),
                kmask.reshape(bc, block_q, k),
                count.reshape(bc, block_q))

    per_block = block_q * 9 * w * 3 * points.element_size()
    bc = max(1, min(block_chunk, TRANSIENT_BYTES // per_block))
    b_lo, b_hi = ((0, n_blocks) if rows is None else
                  rows.split.block(n_blocks))
    outs = [process(lo[s:e], cnt[s:e], sq_blocks[s:e], bvalid[s:e])
            for s in range(b_lo, b_hi, bc) for e in [min(s + bc, b_hi)]]
    if outs:
        pos_sorted, kmask, count = (torch.cat(x) for x in zip(*outs))
    else:                  # a rank with no block (fewer blocks than ranks)
        pos_sorted = torch.zeros((0, block_q, k), dtype=torch.long,
                                 device=dev)
        kmask = torch.zeros((0, block_q, k), dtype=torch.bool, device=dev)
        count = torch.zeros((0, block_q), dtype=torch.int32, device=dev)
    if rows is not None:   # every block's slots, from the ranks
        pos_sorted, kmask, count = (
            rows.split.gather(x, n_blocks) for x in
            (pos_sorted.to(torch.int32), kmask, count))

    # rows back to the original query order (this rank's rows)
    iperm = torch.empty((q,), dtype=torch.long, device=dev)
    iperm[qorder.long()] = torch.arange(q, device=dev)
    iperm, qm = take_rows(rows, iperm), take_rows(rows, qm)
    queries = take_rows(rows, queries)
    idx_sorted = pos_sorted.reshape(q_pad, k)[iperm]
    mask_k = kmask.reshape(q_pad, k)[iperm] & qm[:, None]
    count_q = torch.where(qm, count.reshape(q_pad)[iperm], 0)

    idx = torch.where(mask_k,
                      order[idx_sorted.clamp(0, max(n - 1, 0)).long()], 0)
    dist_k = recompute_dist(points, queries, idx, mask_k, metric)

    hard = torch.where(span_bad, 1 << 20, 0).to(torch.int32)
    cell_over = torch.where(qm, win_over[iperm // block_q] + hard, 0)
    return NeighborList(idx=idx.to(torch.int32), mask=mask_k, dist=dist_k,
                        count=count_q.to(torch.int32),
                        cell_overflow=cell_over.to(torch.int32))


def contact_weight_dense(points, queries, radius, points_mask=None,
                         queries_mask=None, chunk=16384):
    """Exact count of ``points`` within ``radius`` of each query (the
    boundary crop's contact weight): direct-difference squared distances
    over chunks of at most ``chunk`` queries, int32."""
    n, q = points.shape[0], queries.shape[0]
    dev = points.device
    pm = (torch.ones((n,), dtype=torch.bool, device=dev)
          if points_mask is None else points_mask.to(torch.bool))
    r = torch.tensor(float(radius), dtype=points.dtype, device=dev)
    r2 = r * r
    chunk = max(1, min(chunk, TRANSIENT_BYTES // max(
        1, n * 3 * points.element_size())))
    parts = []
    for s in range(0, q, chunk):
        d2 = sq_norm(queries[s:s + chunk, None, :] - points[None, :, :])
        parts.append(((d2 <= r2) & pm[None, :]).sum(dim=1,
                                                    dtype=torch.int32))
    wgt = torch.cat(parts) if parts else torch.zeros(
        (0,), dtype=torch.int32, device=dev)
    if queries_mask is not None:
        wgt = torch.where(queries_mask.to(torch.bool), wgt, 0)
    return wgt
