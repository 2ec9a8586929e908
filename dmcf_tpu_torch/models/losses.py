"""Validation losses (port of the parts of dmcf_tpu/models/losses.py that
the valid metric suite runs: ``_masked_mean`` and ``density_loss``).  The
training losses come with the training slice (ROADMAP queue 1 item 10).

Masked: padded particles contribute zero and means are taken over valid
particles only.
"""

from __future__ import annotations

import torch

from ..ops.sph import compute_density


def _masked_mean(x, mask):
    denom = torch.clamp(mask.sum().to(x.dtype), min=1.0)
    return torch.where(mask, x, 0.0).sum() / denom


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
