"""The benchmark scene (own copy of ``bench.build_scene``; the port
imports nothing of the JAX package) as a padded model sample."""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .data.dataflow import pad_rollout_state


def build_scene(n_fluid=2304, spacing=0.01, seed=0):
    """Dam-break-like block resting on a ramped floor, GNS WaterRamps scale:
    fluid at rest spacing, boundary = floor + two walls + a ramp.
    Returns (pos [n_fluid, 3], box [B, 3], box_normals [B, 3]) fp32."""
    rng = np.random.RandomState(seed)
    side = int(np.ceil(np.sqrt(n_fluid)))
    xs, ys = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    pos = np.stack([xs.reshape(-1), ys.reshape(-1),
                    np.zeros(side * side)], -1)[:n_fluid] * spacing
    pos[:, 0] -= 0.45
    pos[:, 1] -= 0.45
    pos = pos + rng.normal(scale=spacing * 0.01, size=pos.shape)
    pos[:, 2] = 0.0

    m = int(1.0 / spacing)
    line = np.arange(m) * spacing - 0.5
    floor = np.stack([line, np.full(m, -0.5), np.zeros(m)], -1)
    left = np.stack([np.full(m, -0.5), line, np.zeros(m)], -1)
    right = np.stack([np.full(m, 0.5), line, np.zeros(m)], -1)
    ramp_x = np.arange(m // 2) * spacing
    ramp = np.stack([ramp_x, -0.5 + ramp_x * 0.5, np.zeros(m // 2)], -1)
    box = np.concatenate([floor, left, right, ramp], 0).astype(np.float32)
    nrm = np.zeros_like(box)
    nrm[:m, 1] = 1.0
    nrm[m:2 * m, 0] = 1.0
    nrm[2 * m:3 * m, 0] = -1.0
    nrm[3 * m:, 1] = 1.0
    return pos.astype(np.float32), box, nrm


def bench_sample(pos, box, nrm, grav=-9.81, bucket=128, device="cuda"):
    """The bench's initial state as a model sample on ``device``: fluid at
    rest under gravity, padded with ``pad_rollout_state(bucket=128)``
    (``bench.py`` main)."""
    device = resolve_device(device)
    data = {
        "pos": pos[None], "vel": np.zeros_like(pos)[None],
        "grav": np.broadcast_to(np.array([0, grav, 0], np.float32),
                                pos.shape)[None].copy(),
        "box": box, "box_normals": nrm,
    }
    state = pad_rollout_state(data, bucket=bucket)
    return {
        "pos": torch.as_tensor(state["pos"][0], device=device),
        "vel": torch.as_tensor(state["vel"][0], device=device),
        "grav": torch.as_tensor(state["grav"][0], device=device),
        "box": torch.as_tensor(state["box"], device=device),
        "box_normals": torch.as_tensor(state["box_normals"], device=device),
        "fluid_mask": torch.as_tensor(state["fluid_mask"], device=device),
        "box_mask": torch.as_tensor(state["box_mask"], device=device),
    }
