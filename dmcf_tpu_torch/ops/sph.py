"""Sentinel padding, the voxel position pyramid, SPH number density and
nearest-neighbour distances (port of the parts of dmcf_tpu/ops/sph.py that
the rollout and evaluation paths run).

Padded entries sit at far, spread-out sentinel positions so they never
enter any neighborhood; all functions take and return padded tensors plus
masks and counts.
"""

from __future__ import annotations

import numpy as np
import torch

from .neighbors import fixed_radius_search

PAD_POS = 1e8  # sentinel coordinate for padded particles

_I32_MAX = 2**31 - 1


def _to_int32_saturating(x):
    """float -> int32 that saturates out-of-range values, as XLA's convert
    does (a plain ``.to(torch.int32)`` is undefined there)."""
    inner = torch.clamp(x, -2.0**31, 2.0**31 - 128.0).to(torch.int32)
    return torch.where(x >= 2.0**31, _I32_MAX, inner)


def _dedup_cells(cells, cmask, out_max):
    """Fixed-shape unique rows of int32 cell coordinates.

    The reference's 3-column ``lexsort`` becomes three stable sorts, least
    significant column first; masked rows carry the int32-max sentinel so
    they sort last.  Returns (cells [out_max, 3], mask [out_max], count).
    """
    cs = torch.where(cmask[:, None], cells, _I32_MAX)
    order = torch.arange(cs.shape[0], device=cs.device)
    for col in (2, 1, 0):
        order = order[torch.argsort(cs[order, col], stable=True)]
    scs = cs[order]
    first = torch.cat([
        torch.ones((1,), dtype=torch.bool, device=cs.device),
        (scs[1:] != scs[:-1]).any(dim=-1)])
    uniq = first & cmask[order]
    count = uniq.sum(dtype=torch.int32)
    # stable sort by ~uniq brings unique entries to the front
    order2 = torch.argsort((~uniq).to(torch.uint8), stable=True)[:out_max]
    return scs[order2], uniq[order2], count


def pad_sentinel_positions(n, start=0.0, dtype=torch.float32, device=None):
    """Spread-out sentinel positions so padded points have no neighbors
    (not even each other)."""
    i = torch.arange(n, dtype=dtype, device=device)
    zeros = torch.zeros_like(i)
    return torch.stack([PAD_POS + start + i * 1e3, zeros, zeros], dim=-1)


def masked_positions(pos, mask):
    """Replace invalid rows with spread sentinel positions."""
    sent = pad_sentinel_positions(pos.shape[0], dtype=pos.dtype,
                                  device=pos.device)
    return torch.where(mask[:, None], pos, sent)


def compute_density(out_pos, in_pos, radius, win, out_mask=None,
                    in_mask=None, k=64):
    """SPH number density at ``out_pos``: the window summed over the first
    ``k`` in-radius points of ``in_pos`` by index, self included."""
    if win is None:
        win = lambda x: x  # noqa: E731
    nl = fixed_radius_search(in_pos, out_pos, radius, k,
                             points_mask=in_mask, queries_mask=out_mask)
    r = torch.tensor(float(radius), dtype=out_pos.dtype,
                     device=out_pos.device)
    w = torch.where(nl.mask, win(nl.dist / (r * r)), 0.0)
    return w.sum(dim=1)


def nn_distance(a, b, a_mask=None, b_mask=None):
    """Bidirectional nearest-neighbour (Chamfer) distances, brute force:
    for every point of each set, the squared distance to (and index of)
    the nearest valid point of the other set; 0 on invalid rows.  Returns
    (dist_a, idx_a, dist_b, idx_b)."""
    d = ((a[:, None, :] - b[None, :, :]) ** 2).sum(dim=-1)
    if b_mask is not None:
        d = torch.where(b_mask[None, :], d, torch.inf)
    if a_mask is not None:
        d = torch.where(a_mask[:, None], d, torch.inf)
    dist_a, idx_a = d.min(dim=1)
    dist_b, idx_b = d.min(dim=0)
    if a_mask is not None:
        dist_a = torch.where(a_mask, dist_a, 0.0)
    if b_mask is not None:
        dist_b = torch.where(b_mask, dist_b, 0.0)
    return dist_a, idx_a.to(torch.int32), dist_b, idx_b.to(torch.int32)


def grid_pos(pos, mask, voxel_size, out_max, centralize=False, pad=0,
             hyst=0.1):
    """Occupied-voxel centers of a point set, padded to ``out_max``.

    Each point stamps the voxels around it (hysteresis duplication +/-hyst
    plus a (2+2*pad)^d offset neighborhood on active axes), duplicates are
    removed and voxel centers emitted.  ``voxel_size`` is a static
    3-vector; axes with voxel_size < 1e-5 are inactive.

    Returns (positions [out_max, 3], mask [out_max], count).
    """
    voxel_size = np.asarray(voxel_size, np.float32)
    active = voxel_size >= 1e-5
    vs = torch.as_tensor(np.maximum(voxel_size, np.float32(1e-5)),
                         device=pos.device)
    dtype = pos.dtype

    if centralize:
        denom = torch.clamp(mask.sum(), min=1)
        center = torch.where(mask[:, None], pos, 0.0).sum(dim=0) / denom
        p = pos - center
    else:
        center = None
        p = pos

    base = p / vs
    h = torch.as_tensor(np.where(active, hyst, 0.0), dtype=dtype,
                        device=pos.device)
    cand = _to_int32_saturating(torch.cat([torch.floor(base - h),
                                           torch.floor(base + h)], dim=0))

    ranges = [np.arange(-pad, 2 + pad) if a else np.arange(0, 1)
              for a in active]
    offs = np.stack(np.meshgrid(*ranges, indexing="ij"),
                    axis=-1).reshape(-1, 3).astype(np.int32)
    offs = torch.as_tensor(offs, device=pos.device)
    cells = (cand[:, None, :] + offs[None, :, :]).reshape(-1, 3)
    cmask = torch.cat([mask, mask]).repeat_interleave(offs.shape[0])

    out_cells, out_mask, count = _dedup_cells(cells, cmask, out_max)

    vsd = torch.as_tensor(voxel_size, dtype=dtype, device=pos.device)
    if centralize:
        gp = out_cells.to(dtype) * vsd + center
    else:
        gp = out_cells.to(dtype) * vsd + vsd / 2.0
    gp = masked_positions(gp, out_mask)
    return gp, out_mask, count


def get_dilated_pos(pos, mask, strides, out_maxes, voxel_size=None,
                    centralize=False, pad=0, hyst=0.1):
    """Multi-scale position pyramid (voxel branch).

    Returns (positions, masks, counts) lists, one entry per stride: stride
    1 is the input itself, coarser scales are occupied voxel grids at
    ``voxel_size * stride`` padded to ``out_maxes[s]``.  The
    farthest-point-sampling branch (``voxel_size=None``) is not ported.
    """
    if voxel_size is None:
        raise NotImplementedError(
            "the farthest-point-sampling pyramid (voxel_size=None) is not "
            "ported yet")
    pcount = mask.sum(dtype=torch.int32)
    positions, masks, counts = [], [], []
    for si, stride in enumerate(strides):
        if stride == 1:
            positions.append(pos)
            masks.append(mask)
            counts.append(pcount)
        else:
            vs = np.asarray(voxel_size, np.float32) * stride
            gp, gm, gc = grid_pos(pos, mask, vs, out_maxes[si],
                                  centralize=centralize, pad=pad, hyst=hyst)
            positions.append(gp)
            masks.append(gm)
            counts.append(gc)
    return positions, masks, counts
