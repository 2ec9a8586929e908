"""Rollout loop: repeated model steps with the bench's exactness gate."""

from __future__ import annotations

import torch


@torch.no_grad()
def rollout(model, sample, steps):
    """Run ``steps`` model steps from ``sample``.

    Carries the running max of ``neighbor_overflow`` (max true finest-radius
    count) and ``pair_overflow`` (worst per-pair K-budget excess) and of the
    per-scale voxel counts on the device, as ``bench.py`` does, and reads
    them once at the end.  Returns (pos, vel, gate): ``gate["exact"]`` is
    the bench's gate (no conv dropped an in-radius neighbor over the whole
    rollout), ``gate["scales_fit"]`` says no pyramid scale outgrew its
    capacity.
    """
    s = dict(sample)
    pos, vel = s["pos"], s["vel"]
    dev = pos.device
    mx = torch.zeros((), dtype=torch.int32, device=dev)
    po = torch.full((), -(2**30), dtype=torch.int32, device=dev)
    counts = caps = None
    for _ in range(steps):
        s["pos"], s["vel"] = pos, vel
        pos, vel, aux = model(s)
        mx = torch.maximum(mx, aux["neighbor_overflow"])
        po = torch.maximum(po, aux["pair_overflow"])
        counts = (aux["scale_counts"] if counts is None
                  else torch.maximum(counts, aux["scale_counts"]))
        caps = aux["scale_caps"]
    gate = {"max_neighbors": int(mx), "pair_overflow": int(po),
            "neighbor_k": int(model.neighbor_k)}
    if counts is not None:
        gate["scale_counts"] = counts.tolist()
        gate["scale_caps"] = caps.tolist()
        gate["scales_fit"] = all(c <= k for c, k in zip(counts.tolist(),
                                                        caps.tolist()))
    gate["exact"] = (gate["pair_overflow"] <= 0
                     and gate["max_neighbors"] <= gate["neighbor_k"])
    return pos, vel, gate
