"""The benchmark scene and rollout-state padding (own copies of
``bench.build_scene`` and ``dmcf_tpu/data/dataflow.py``'s
``pad_rollout_state`` / ``sentinel_rows`` / ``pad_particles``; the port
imports nothing of the JAX package)."""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .ops.sph import PAD_POS


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


def _round_up(n, m):
    return int(-(-n // m) * m)


def pad_particles(arr, n_max, fill=0.0):
    """[..., N, 3] -> [..., n_max, 3]."""
    pad = n_max - arr.shape[-2]
    if pad <= 0:
        return arr
    widths = [(0, 0)] * (arr.ndim - 2) + [(0, pad), (0, 0)]
    return np.pad(arr, widths, constant_values=fill)


def sentinel_rows(n, offset=0):
    out = np.zeros((n, 3), np.float32)
    out[:, 0] = PAD_POS + (np.arange(n) + offset) * 1e3
    return out


def pad_rollout_state(data, bucket=64):
    """Rollout sequence dict (``pos``/``vel``/``grav`` [T, N, 3], ``box`` /
    ``box_normals`` [B, 3]) -> fixed-shape padded numpy state."""
    n = data["pos"].shape[1]
    nb = max(data["box"].shape[0], 1)
    n_max = _round_up(n, bucket)
    b_max = _round_up(nb, bucket)
    pos = pad_particles(data["pos"].astype(np.float32), n_max)
    pos[:, n:, :] = sentinel_rows(n_max - n)[None]
    vel = pad_particles(data["vel"].astype(np.float32), n_max)
    box = pad_particles(data["box"].astype(np.float32), b_max)
    box[data["box"].shape[0]:, :] = sentinel_rows(
        b_max - data["box"].shape[0], offset=n_max)
    nrm = pad_particles(data["box_normals"].astype(np.float32), b_max)
    grav = None
    if data.get("grav") is not None:
        grav = pad_particles(data["grav"].astype(np.float32), n_max)
    return {
        "pos": pos, "vel": vel, "grav": grav, "box": box,
        "box_normals": nrm,
        "fluid_mask": np.arange(n_max) < n,
        "box_mask": np.arange(b_max) < data["box"].shape[0],
        "n_fluid": n,
    }


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
