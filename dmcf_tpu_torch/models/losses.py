"""Training and validation losses (port of dmcf_tpu/models/losses.py:
``mse``, ``weighted_mse``, ``vel``, ``weighted_vel``, ``momentum``,
``density_loss`` and the ``get_loss`` factory).

Masked: padded particles contribute zero and means are taken over valid
particles only.
"""

from __future__ import annotations

from functools import partial

import torch

from ..ops.sph import compute_density
from ..ops.windows import get_window_func


def _masked_mean(x, mask):
    denom = torch.clamp(mask.sum().to(x.dtype), min=1.0)
    return torch.where(mask, x, 0.0).sum() / denom


def _pre_factor(pre_scale, pre_steps, like):
    return torch.exp(-pre_scale * torch.as_tensor(
        pre_steps, dtype=torch.float32, device=like.device))


def mse_loss(target, pred, mask, fac=1.0, gamma=0.5, pre_scale=0.0,
             pre_steps=0, **kw):
    pre_f = _pre_factor(pre_scale, pre_steps, pred)
    diff = (((target - pred) ** 2).sum(dim=-1) + 1e-9) ** gamma
    return fac * _masked_mean(pre_f * diff, mask)


def weighted_mse_loss(target, pred, mask, num_fluid_neighbors, fac=1.0,
                      gamma=0.5, neighbor_scale=1.0, pre_scale=0.0,
                      pre_steps=0, **kw):
    """Neighbor-count-importance MSE: free-surface particles (few fluid
    neighbors) get exponentially larger weight."""
    pre_f = _pre_factor(pre_scale, pre_steps, pred)
    importance = torch.exp(-neighbor_scale * num_fluid_neighbors)
    diff = (((target - pred) ** 2).sum(dim=-1) + 1e-9) ** gamma
    return fac * _masked_mean(pre_f * importance * diff, mask)


def vel_loss(target, pred, mask, input_pos, target_prev, fac=1.0, gamma=0.5,
             **kw):
    diff = ((((target - target_prev) - (pred - input_pos)) ** 2).sum(dim=-1)
            + 1e-9) ** gamma
    return fac * _masked_mean(diff, mask)


def weighted_vel_loss(target, pred, mask, input_pos, target_prev,
                      num_fluid_neighbors, fac=1.0, gamma=0.5,
                      neighbor_scale=1.0, **kw):
    importance = torch.exp(-neighbor_scale * num_fluid_neighbors)
    diff = ((((target - target_prev) - (pred - input_pos)) ** 2).sum(dim=-1)
            + 1e-9) ** gamma
    return fac * _masked_mean(importance * diff, mask)


def momentum_loss(pos_correction, mask, fac=1.0, **kw):
    return fac * _masked_mean(pos_correction.mean(dim=-1), mask)


def density_loss(gt, pred, gt_mask, pred_mask, gt_in=None, pred_in=None,
                 gt_in_mask=None, pred_in_mask=None, radius=0.005, eps=0.01,
                 win=None, use_max=False, fac=1.0, k=64, **kw):
    """Density error against ground truth; ``use_max=True`` gives the
    max-density metric, the relative error of the max fluid density
    against the ground truth's max density."""
    if pred_in is None:
        pred_in, pred_in_mask = pred, pred_mask
    if gt_in is None:
        gt_in, gt_in_mask = gt, gt_mask
    pred_dens = compute_density(pred, pred_in, radius, win,
                                out_mask=pred_mask, in_mask=pred_in_mask, k=k)
    gt_dens = compute_density(gt, gt_in, radius, win,
                              out_mask=gt_mask, in_mask=gt_in_mask, k=k)
    rest_dens = torch.where(gt_mask, gt_dens, -torch.inf).max()

    if use_max:
        pred_max = torch.where(pred_mask, pred_dens, -torch.inf).max()
        return fac * torch.abs(pred_max - rest_dens) / rest_dens

    err = torch.relu(pred_dens - rest_dens - eps)
    return fac * _masked_mean(err, pred_mask)


def get_loss(typ, fac=1.0, **kwargs):
    """Loss factory keyed by the config's ``typ``.  ``chamfer`` and
    ``hist`` (eval-only in the JAX package) are not ported."""
    if typ == "mse":
        return partial(mse_loss, fac=fac, **kwargs)
    if typ == "weighted_mse":
        return partial(weighted_mse_loss, fac=fac, **kwargs)
    if typ == "vel":
        return partial(vel_loss, fac=fac, **kwargs)
    if typ == "weighted_vel":
        return partial(weighted_vel_loss, fac=fac, **kwargs)
    if typ == "momentum":
        return partial(momentum_loss, fac=fac, **kwargs)
    if typ == "dense":
        win = get_window_func(kwargs.pop("win", None))
        return partial(density_loss, fac=fac, win=win, **kwargs)
    if typ == "emd":
        from ..ops.emd import emd_loss
        return partial(emd_loss, **kwargs)
    if typ in ("chamfer", "hist"):
        raise NotImplementedError(f"loss {typ!r} is not ported yet")
    raise NotImplementedError(f"unknown loss: {typ}")
