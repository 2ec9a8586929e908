"""Earth mover's distance by annealed soft bipartite matching (port of
dmcf_tpu/ops/emd.py, the ApproxMatch algorithm).

Ten annealing levels with temperature ``-4^j`` (j = 7..-2, the last level
exactly 0), each soft-assigning remaining source mass to remaining target
capacity; mass multipliers with integer-division semantics; padded point
sets through the true counts ``n``/``m``, whose padded rows get no mass on
either side.  fp32 throughout, reductions in the JAX order.  Dense
[B, M, N] fields: plain PyTorch (ROADMAP queue 2 lists ``approx_match`` as
a hand-kernel candidate).
"""

from __future__ import annotations

import torch


def _levels(device):
    levels = -(4.0 ** torch.arange(7, -3, -1, dtype=torch.float32,
                                   device=device))
    levels[-1] = 0.0
    return levels


def _counts(c, b, full, device):
    if c is None:
        return torch.full((b,), full, dtype=torch.int32, device=device)
    return torch.as_tensor(c, dtype=torch.int32, device=device)


def approx_match(xyz1, xyz2, n=None, m=None):
    """Soft match matrix between two point sets.

    xyz1 [B, N, 3] target points, xyz2 [B, M, 3] query points, n/m
    optional [B] true counts.  Returns match [B, M, N], the mass of
    xyz1[i] given to xyz2[j].
    """
    b, N = xyz1.shape[:2]
    M = xyz2.shape[1]
    dev = xyz1.device
    n = _counts(n, b, N, dev)
    m = _counts(m, b, M, dev)
    # mass multipliers use integer-division semantics, as the CUDA op does
    # (an empty set has no mass to scale: its divisor is clamped to 1
    # because torch raises on an integer division by zero)
    multi_l = torch.where(n >= m, 1.0,
                          (m // n.clamp(min=1)).to(torch.float32))
    multi_r = torch.where(n >= m, (n // m.clamp(min=1)).to(torch.float32),
                          1.0)
    mask_l = (torch.arange(N, device=dev)[None, :] < n[:, None]).to(
        torch.float32)                                   # [B, N]
    mask_r = (torch.arange(M, device=dev)[None, :] < m[:, None]).to(
        torch.float32)                                   # [B, M]
    d = ((xyz2[:, :, None, :] - xyz1[:, None, :, :]) ** 2).sum(dim=-1)

    remain_l = multi_l[:, None] * mask_l
    remain_r = multi_r[:, None] * mask_r
    match = torch.zeros((b, M, N), dtype=torch.float32, device=dev)
    valid = mask_r[:, :, None] * mask_l[:, None, :]
    for level in _levels(dev):
        w = torch.exp(level * d) * valid
        # 1) each source spreads its remaining mass over the targets
        suml = 1e-9 + (w * remain_r[:, :, None]).sum(dim=1)      # [B, N]
        ratio_l = remain_l / suml
        # 2) targets absorb up to their remaining capacity
        sumr = remain_r * (w * ratio_l[:, None, :]).sum(dim=2)   # [B, M]
        consumption = torch.clamp(remain_r / (sumr + 1e-9), max=1.0)
        ratio_r = consumption * remain_r
        remain_r = torch.clamp(remain_r - sumr, min=0.0)
        # 3) committed transport this level
        t = w * ratio_l[:, None, :] * ratio_r[:, :, None]
        match = match + t
        remain_l = torch.clamp(remain_l - t.sum(dim=1), min=0.0)
    return match


def match_cost(xyz1, xyz2, match):
    """Total transported euclidean distance."""
    d = torch.sqrt(torch.clamp(
        ((xyz2[:, :, None, :] - xyz1[:, None, :, :]) ** 2).sum(dim=-1),
        min=0.0))
    return (d * match).sum(dim=(1, 2))


def approx_vel(pos_0, pos_1, n=None, m=None):
    """Soft-matched displacement field: for each point of ``pos_0`` the
    match-weighted offset to ``pos_1``.  Returns [B, N, 3]."""
    vel = pos_1[:, :, None, :] - pos_0[:, None, :, :]   # [B, M, N, 3]
    match = approx_match(pos_0, pos_1, n, m)            # [B, M, N]
    return (vel * match[..., None]).sum(dim=1)


def emd_loss(y_true, y_pred, n=None, m=None):
    """EMD approximation: match cost / max(n, m)."""
    b, N = y_true.shape[:2]
    M = y_pred.shape[1]
    dev = y_true.device
    n = _counts(n, b, N, dev)
    m = _counts(m, b, M, dev)
    match = approx_match(y_true, y_pred, n, m)
    return match_cost(y_true, y_pred, match) / torch.maximum(n, m).to(
        torch.float32)
