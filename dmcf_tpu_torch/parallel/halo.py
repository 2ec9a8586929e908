"""Slab-decomposed neighbour search and continuous conv with a halo
exchange between neighbouring ranks (port of dmcf_tpu/parallel/halo.py).

Space is split into D slabs along one axis; rank d OWNS the points of
slab d, and each step only the boundary-zone points (within the search
radius of a slab plane) go to the two neighbouring ranks, through
``Group.exchange`` (JAX's paired ``ppermute``).  Each rank then builds its
cell list over its owned plus received rows and searches and convolves
its owned queries alone:

    points a rank      ~ N/D + 2H   (H: the halo zone's occupancy)
    compute a rank     ~ 1/D of the single-process step
    communication      ~ 2H rows, point to point

A query of slab s has its in-radius neighbours in [lo_s - r, hi_s + r];
with the halo width at least r and every slab at least that wide
(``min_slab_width``), the owned rows and the two received halos cover
that interval, so the neighbour sets equal the single-process search's.

``slab_partition`` and ``min_slab_width`` are numpy and give the JAX
package's arrays bit for bit; every rank runs them over the same global
arrays and takes its own row of the result (``shard_parts``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.grid_search import grid_fixed_radius_search
from ..ops.neighbors import select_k_valid

#: pad rows of a slab sit from here (+ 7 a row): far from every real cell
PAD_FAR = 1e9
#: unused send slots sit from 2e9 (+ 1 a slot), unmatched receive slots
#: from 3e9 (left) and 6e9 (right)
HALO_FAR = 2e9
RECV_FAR = 3e9


def slab_partition(points, mask, n_dev, *, axis=None, payload=None):
    """Partition a masked point set into ``n_dev`` equal-count slabs.

    Valid points are sorted along ``axis`` (default: the axis of largest
    extent) and split into ``n_dev`` contiguous, equal-count groups, each
    padded to the common per-rank capacity (a multiple of 8).

    Returns a dict: pos [D, cap, 3], mask [D, cap], src [D, cap] int32
    (the row of the input; 0 where invalid), bounds [D, 2] float32 (the
    slab's [lo, hi) planes, -inf / +inf at the ends), payload
    [D, cap, C] (when given), ``axis`` and ``cap``.
    """
    points = np.asarray(points)
    mask = np.asarray(mask).astype(bool)
    valid_idx = np.nonzero(mask)[0]
    n_valid = valid_idx.size
    if axis is None:
        if n_valid:
            ext = points[valid_idx].max(0) - points[valid_idx].min(0)
            axis = int(np.argmax(ext))
        else:
            axis = 0
    order = valid_idx[np.argsort(points[valid_idx, axis], kind="stable")]
    cap = max(-(-n_valid // n_dev), 1)
    cap = int(-(-cap // 8) * 8)

    pos_sh = np.zeros((n_dev, cap, 3), points.dtype)
    mask_sh = np.zeros((n_dev, cap), bool)
    src_sh = np.zeros((n_dev, cap), np.int32)
    pay_sh = None
    if payload is not None:
        payload = np.asarray(payload)
        pay_sh = np.zeros((n_dev, cap) + payload.shape[1:], payload.dtype)
    bounds = np.zeros((n_dev, 2), np.float64)
    splits = np.linspace(0, n_valid, n_dev + 1).round().astype(int)
    for d in range(n_dev):
        sel = order[splits[d]:splits[d + 1]]
        k = sel.size
        pos_sh[d, :k] = points[sel]
        # pad rows far away, so that no rank's cell hashes meet them
        pos_sh[d, k:] = PAD_FAR + np.arange(cap - k)[:, None] * 7.0
        mask_sh[d, :k] = True
        src_sh[d, :k] = sel
        if pay_sh is not None:
            pay_sh[d, :k] = payload[sel]
        lo = -np.inf if d == 0 else bounds[d - 1, 1]
        if d == n_dev - 1:
            hi = np.inf
        elif splits[d + 1] < n_valid:
            hi = 0.5 * (points[order[splits[d + 1] - 1], axis]
                        + points[order[splits[d + 1]], axis]) \
                if splits[d + 1] > 0 else -np.inf
        else:
            hi = np.inf
        bounds[d] = (lo, hi)
    out = {"pos": pos_sh, "mask": mask_sh, "src": src_sh,
           "bounds": bounds.astype(np.float32), "axis": axis, "cap": cap}
    if pay_sh is not None:
        out["payload"] = pay_sh
    return out


def min_slab_width(bounds):
    """Smallest finite slab width (the halo width must not exceed it)."""
    b = np.asarray(bounds, np.float64)
    widths = b[:, 1] - b[:, 0]
    finite = np.isfinite(widths)
    return float(widths[finite].min()) if finite.any() else np.inf


def _halo_select(pos, mask, payload, axis, plane, side, h_cap):
    """The owned rows within the halo zone of a slab plane, compacted in
    input order into ``h_cap`` fixed slots: side +1 the zone
    [``plane``, ...) at the slab's right edge, side -1 (..., ``plane``] at
    its left.  Returns (pos [h_cap, 3], payload [h_cap, C], mask [h_cap],
    the zone's count, which may pass ``h_cap``)."""
    coord = pos[:, axis]
    in_zone = mask & ((coord >= plane) if side > 0 else (coord <= plane))
    idx, m, _, count = select_k_valid(in_zone[None, :], None, h_cap)
    idx, m = idx[0].long(), m[0]
    far = HALO_FAR + torch.arange(h_cap, dtype=pos.dtype,
                                  device=pos.device)[:, None]
    hpos = torch.where(m[:, None], pos[idx], far)
    hpay = torch.where(m[:, None], payload[idx], 0.0)
    return hpos, hpay, m, count[0]


def exchange_halo(group, pos, mask, payload, axis, lo, hi, width, h_cap,
                  far=(RECV_FAR, 2 * RECV_FAR)):
    """A rank's owned rows with both neighbours' halo rows appended.

    The zones within ``width`` of the slab planes go to the neighbours in
    one message a direction: position, payload and mask packed into one
    float buffer of ``h_cap`` rows (NCCL and gloo do not both move
    ``bool``).  The sender's mask rides along: a zone test against this
    rank's planes would let unused slots' sentinels in, and drop owned
    rows that drifted into this slab.  Unmatched receive slots sit at
    ``far`` (left, right) plus the slot.

    Returns (local pos [cap + 2 h_cap, 3], local mask, local payload, the
    rows beyond ``h_cap`` that the two zones dropped: 0 iff exact)."""
    c = payload.shape[1]
    send_r_pos, send_r_pay, send_r_m, cnt_r = _halo_select(
        pos, mask, payload, axis, hi - width, +1, h_cap)
    send_l_pos, send_l_pay, send_l_m, cnt_l = _halo_select(
        pos, mask, payload, axis, lo + width, -1, h_cap)
    over = (torch.clamp(cnt_r - h_cap, min=0)
            + torch.clamp(cnt_l - h_cap, min=0))

    def pack(p, pay, m):
        return torch.cat([p, pay.to(p.dtype), m[:, None].to(p.dtype)], 1)

    recv_l, recv_r = group.exchange(pack(send_r_pos, send_r_pay, send_r_m),
                                    pack(send_l_pos, send_l_pay, send_l_m))
    slot = torch.arange(h_cap, dtype=pos.dtype, device=pos.device)[:, None]
    lmask, rmask = recv_l[:, -1] > 0.5, recv_r[:, -1] > 0.5
    lpos = torch.where(lmask[:, None], recv_l[:, :3], far[0] + slot)
    rpos = torch.where(rmask[:, None], recv_r[:, :3], far[1] + slot)
    local_pos = torch.cat([pos, lpos, rpos], 0)
    local_mask = torch.cat([mask, lmask, rmask], 0)
    local_pay = torch.cat([payload, recv_l[:, 3:3 + c].to(payload.dtype),
                           recv_r[:, 3:3 + c].to(payload.dtype)], 0)
    return local_pos, local_mask, local_pay, over


def make_halo_search_conv(group, *, radius, k, halo_cap, axis=0,
                          cell_cap=32, window_fn=None,
                          coordinate_mapping="ball_to_cube_volume_preserving",
                          interpolation="linear", precision="highest"):
    """The halo search (and conv) a rank runs.

    Returns ``run(parts, kernel=None) -> (out, halo_overflow)``: ``parts``
    this rank's ``shard_parts``, its features in ``parts['payload']``;
    ``out`` [cap, Cout] this rank's rows (``parts['src']`` maps them to
    input rows; concatenated in rank order they are the JAX package's
    shard-order output), the per-query neighbour count [cap, 1] when
    ``kernel`` is None; ``halo_overflow`` the zone rows beyond
    ``halo_cap`` summed over the ranks (exact iff 0).  On CUDA tensors the
    conv is the K-list kernel."""

    def run(parts, kernel=None):
        from ..ops.cconv import continuous_conv

        pos, mask, payload = parts["pos"], parts["mask"], parts["payload"]
        lo, hi = parts["bounds"][0], parts["bounds"][1]
        local_pos, local_mask, local_pay, over = exchange_halo(
            group, pos, mask, payload, axis, lo, hi, radius, halo_cap)
        nl = grid_fixed_radius_search(
            local_pos, pos, radius, k, points_mask=local_mask,
            queries_mask=mask, cell_cap=cell_cap)
        if kernel is None:
            out = nl.count[:, None].to(torch.float32)
        else:
            out = continuous_conv(
                kernel, pos, local_pos, local_pay, nl, 2.0 * radius,
                window_fn=window_fn, coordinate_mapping=coordinate_mapping,
                interpolation=interpolation, precision=precision)
            out = torch.where(mask[:, None], out, 0.0)
        return out, group.psum(over)

    return run


def shard_parts(parts, rank, device, keys=("pos", "mask", "src", "bounds",
                                           "payload")):
    """Rank ``rank``'s row of ``slab_partition``'s (or
    ``partition_model_sample``'s) arrays as tensors on ``device``; the
    metadata (``axis``, ``cap``, ...) passes through."""
    out = dict(parts)
    for key in keys:
        if key in parts:
            out[key] = torch.as_tensor(np.asarray(parts[key])[rank],
                                       device=device)
    return out
