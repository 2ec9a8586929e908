"""Sentinel padding, the position pyramid (voxel grids or farthest-point
sampling), SPH number density and pressure, nearest-neighbour distances,
inverse-CDF sampling (``prob_sample``), the rounded voxel grid of the
losses (``grid_pos_bnds``), quaternion helpers and the equivariant
displacement field (port of dmcf_tpu/ops/sph.py).

Padded entries sit at far, spread-out sentinel positions so they never
enter any neighborhood; all functions take and return padded tensors plus
masks and counts.  Farthest-point sampling runs the hand-written CUDA
kernel on CUDA tensors (``kernels/fps.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.fps import farthest_point_sample
from .neighbors import fixed_radius_search
from .neighbors import to_int32_saturating as _to_int32_saturating

PAD_POS = 1e8  # sentinel coordinate for padded particles

_I32_MAX = 2**31 - 1


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
             hyst=0.1, center=None):
    """Occupied-voxel centers of a point set, padded to ``out_max``.

    Each point stamps the voxels around it (hysteresis duplication +/-hyst
    plus a (2+2*pad)^d offset neighborhood on active axes), duplicates are
    removed and voxel centers emitted.  ``voxel_size`` is a static
    3-vector; axes with voxel_size < 1e-5 are inactive.  A ``center`` [3]
    anchors the grid there instead of at the valid points' centroid (the
    slab decomposition passes the whole scene's centroid, so that every
    rank's grid lines up with the others').

    Returns (positions [out_max, 3], mask [out_max], count).
    """
    voxel_size = np.asarray(voxel_size, np.float32)
    active = voxel_size >= 1e-5
    vs = torch.as_tensor(np.maximum(voxel_size, np.float32(1e-5)),
                         device=pos.device)
    dtype = pos.dtype

    if center is not None:
        center = center.to(dtype)
        p = pos - center
        centralize = True      # the centers are emitted about it below
    elif centralize:
        denom = torch.clamp(mask.sum(), min=1)
        center = torch.where(mask[:, None], pos, 0.0).sum(dim=0) / denom
        p = pos - center
    else:
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


def prob_sample(weights, uniforms):
    """Inverse-CDF categorical sampling (the reference's ProbSample): for
    each uniform u in [0, 1), the first index whose normalised running sum
    of ``weights`` [N] is at least u (a left-side search, as
    ``jnp.searchsorted``), int32."""
    cdf = torch.cumsum(weights, dim=-1)
    cdf = cdf / cdf[..., -1:]
    return torch.searchsorted(cdf, uniforms.contiguous(),
                              side="left").to(torch.int32)


def grid_pos_bnds(pos, mask, voxel_size, out_max, centralize=False):
    """Occupied-voxel centers by plain rounding (no hysteresis or padding
    stamp), padded to ``out_max``; with ``centralize`` the cells are
    counted over the valid points' bounds, ``round(extent / voxel)`` cells
    an axis.  Returns (positions [out_max, 3], mask [out_max], count)."""
    voxel_size = np.asarray(voxel_size, np.float32)
    vs = torch.as_tensor(np.maximum(voxel_size, np.float32(1e-5)),
                         device=pos.device)
    dtype = pos.dtype
    m = mask.to(torch.bool)[:, None]
    if centralize:
        minpos = torch.where(m, pos, torch.inf).amin(dim=0)
        maxpos = torch.clamp(torch.where(m, pos, -torch.inf).amax(dim=0)
                             - minpos, min=1e-7)
        r = torch.round(maxpos / vs)
        cells = _to_int32_saturating(torch.round((pos - minpos) / maxpos
                                                 * r))
    else:
        cells = _to_int32_saturating(torch.round(pos / vs))

    out_cells, out_mask, count = _dedup_cells(cells, mask.to(torch.bool),
                                              out_max)

    vsd = torch.as_tensor(voxel_size, dtype=dtype, device=pos.device)
    if centralize:
        gp = out_cells.to(dtype) / torch.clamp(r, min=1e-7) * maxpos + minpos
    else:
        gp = out_cells.to(dtype) * vsd + vsd / 2.0
    return masked_positions(gp, out_mask), out_mask, count


def compute_pressure(dens, rest_dens=3.5, stiffness=20.0):
    """Tait equation of state, ``relu(stiffness * ((dens / rest_dens)^7 -
    1))``, the seventh power as JAX's ``integer_pow`` forms it
    (``(x * x^2) * (x^2)^2``) and the quotient a true division."""
    x = dens / torch.tensor(float(rest_dens), dtype=dens.dtype,
                            device=dens.device)
    x2 = x * x
    return torch.relu(stiffness * ((x * x2) * (x2 * x2) - 1.0))


def get_dilated_pos(pos, mask, strides, out_maxes, voxel_size=None,
                    centralize=False, pad=0, hyst=0.1, center=None):
    """Multi-scale position pyramid.

    Returns (positions, masks, counts, idx) lists, one entry per stride:
    stride 1 is the input itself; with ``voxel_size`` coarser scales are
    occupied voxel grids at ``voxel_size * stride`` padded to
    ``out_maxes[s]`` (idx None); without it each coarser scale is a
    farthest-point sample of the previous scale, ``max(count // stride,
    1)`` valid picks of ``out_maxes[s]`` (the absolute stride, as JAX
    divides), and idx[s] its rows in the previous scale.  ``center``
    anchors the voxel grids (``grid_pos``).
    """
    pcount = mask.sum(dtype=torch.int32)
    positions, masks, counts, idx = [], [], [], []
    for si, stride in enumerate(strides):
        if stride == 1:
            positions.append(pos)
            masks.append(mask)
            counts.append(pcount)
            idx.append(None)
        elif voxel_size is not None:
            vs = np.asarray(voxel_size, np.float32) * stride
            gp, gm, gc = grid_pos(pos, mask, vs, out_maxes[si],
                                  centralize=centralize, pad=pad, hyst=hyst,
                                  center=center)
            positions.append(gp)
            masks.append(gm)
            counts.append(gc)
            idx.append(None)
        else:
            if not positions:
                raise ValueError("farthest-point sampling needs scale 0 "
                                 "at stride 1 (it samples the previous "
                                 "scale)")
            prev_pos, prev_mask = positions[-1], masks[-1]
            cnt = torch.clamp(counts[-1] // stride, min=1)
            sel, sel_mask = farthest_point_sample(prev_pos, prev_mask,
                                                  out_maxes[si], cnt)
            positions.append(masked_positions(prev_pos[sel.long()],
                                              sel_mask))
            masks.append(sel_mask)
            counts.append(cnt)
            idx.append(sel)
    return positions, masks, counts, idx


def quat_mult(q, r):
    w = r[..., 0] * q[..., 0] - r[..., 1] * q[..., 1] \
        - r[..., 2] * q[..., 2] - r[..., 3] * q[..., 3]
    x = r[..., 0] * q[..., 1] + r[..., 1] * q[..., 0] \
        - r[..., 2] * q[..., 3] + r[..., 3] * q[..., 2]
    y = r[..., 0] * q[..., 2] + r[..., 1] * q[..., 3] \
        + r[..., 2] * q[..., 0] - r[..., 3] * q[..., 1]
    z = r[..., 0] * q[..., 3] - r[..., 1] * q[..., 2] \
        + r[..., 2] * q[..., 1] + r[..., 3] * q[..., 0]
    return torch.stack([w, x, y, z], dim=-1)


def quat_conj(q):
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def quat_rot(v, q):
    r = torch.cat([torch.zeros_like(v[..., :1]), v], dim=-1)
    return quat_mult(quat_mult(q, r), quat_conj(q))[..., 1:]


def quat_mean(q0, q1):
    return (q0 + q1) / torch.sqrt(2.0 + 2.0 * (q0 * q1).sum(dim=-1))[..., None]


def compute_transformed_dx(pos, mask, scale=None, rot=None, radius=0.005,
                           k=64):
    """Equivariant displacement field: the mean over the in-radius
    neighbours (self included, the first ``k`` by index) of ``x_j - x_i``,
    optionally turned by the averaged quaternion of ``rot`` and scaled by
    the neighbour's ``scale``.  ``scale`` and ``rot`` may hold fewer rows
    than ``pos`` (a fluid-only output): their gather clamps, as JAX's
    does."""
    nl = fixed_radius_search(pos, pos, radius, k, points_mask=mask,
                             queries_mask=mask)
    idx = nl.idx.long()
    if nl.disp is not None:
        dx = nl.disp
    else:
        dx = torch.where(nl.mask[..., None], pos[idx] - pos[:, None, :],
                         0.0)
    if rot is not None:
        dx = quat_rot(dx, quat_mean(rot[idx.clamp(max=rot.shape[0] - 1)],
                                    rot[:, None, :]))
    if scale is not None:
        dx = dx * torch.where(nl.mask[..., None],
                              scale[idx.clamp(max=scale.shape[0] - 1)], 0.0)
    denom = torch.clamp(nl.mask.sum(dim=1), min=1).to(pos.dtype)
    return dx.sum(dim=1) / denom[:, None]


def align_vector(v0, v1):
    """Rotation matrix aligning v0 to v1 (Rodrigues; reference
    models/pbf_model.py:12-28).  Degenerate (parallel) case returns +/-I."""
    v0n = v0 / (torch.linalg.norm(v0) + 1e-9)
    v1n = v1 / (torch.linalg.norm(v1) + 1e-9)
    v = torch.linalg.cross(v0n, v1n)
    c = torch.dot(v0n, v1n)
    s = torch.linalg.norm(v)
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    vx = torch.stack([
        torch.stack([zero, -v[2], v[1]]),
        torch.stack([v[2], zero, -v[0]]),
        torch.stack([-v[1], v[0], zero]),
    ])
    eye = torch.eye(3, dtype=v0.dtype, device=v0.device)
    r = eye + vx + vx @ vx / torch.where(s < 1e-6, 1.0, 1.0 + c)
    degenerate = eye * torch.where(c < 0, -1.0, 1.0)
    return torch.where(s < 1e-6, degenerate, r)
