"""Evaluation sequences and fixed-shape padding (the port's copy of the
parts of dmcf_tpu/data/dataflow.py that valid/test/rollout run:
``WindowSampler._augment``'s global transform, ``get_rollout``,
``pad_particles``, ``sentinel_rows``, ``pad_rollout_state``).

The training sampler, its random augmentations (rotate, jitter) and the
prefetching batcher come with the training slice (ROADMAP queue 1 item
10); the ``grav_eqvar`` alignment raises (queue 1 item 4).
"""

from __future__ import annotations

import numpy as np

from ..ops.sph import PAD_POS


def augment(s, translate=None, scale=None, grav_eqvar=None):
    """The global translate/scale of a sequence dict (``pos``/``vel``/
    ``grav`` [T, N, 3], ``box`` [B, 3]), as ``WindowSampler._augment``
    applies them with no random augmentation configured."""
    if grav_eqvar is not None:
        raise NotImplementedError(
            "the grav_eqvar transform is not ported yet (ROADMAP queue 1 "
            "item 4)")
    if translate is not None:
        s["pos"] = s["pos"] + translate
        s["box"] = s["box"] + translate
    if scale is not None:
        s["pos"] = s["pos"] * scale
        s["box"] = s["box"] * scale
        s["vel"] = s["vel"] * scale
        if s.get("grav") is not None:
            s["grav"] = s["grav"] * scale
    return s


def get_rollout(dataset, stride=1, time_start=0, time_end=None,
                random_start=1, cnt=None, translate=None, scale=None,
                grav_eqvar=None, seed=None, **kwargs):
    """Full evaluation sequences: per scene, frames [time_start(+rand),
    time_end) at ``stride``, merged into arrays of shape [T, N, 3].  The
    random start offset comes from ``np.random.RandomState(seed)``, drawn
    per scene in order, as in the JAX package."""
    rng = np.random.RandomState(seed)
    out = []
    for si in range(len(dataset)):
        if cnt is not None and len(out) >= cnt:
            break
        scene = dataset[si]
        off = rng.randint(random_start * stride) if random_start > 1 else 0
        sel = [f for f in scene
               if f["frame_id"] >= time_start * stride + off
               and f["frame_id"] % stride == 0
               and (time_end is None
                    or f["frame_id"] < time_end * stride + off)]
        if not sel:
            continue
        merged = {}
        for k in ("pos", "vel"):
            merged[k] = np.stack([np.asarray(f[k], np.float32)
                                  for f in sel], 0)
        g = sel[0].get("grav")
        if g is not None:
            g = np.stack([np.asarray(f["grav"], np.float32) for f in sel], 0)
            if g.ndim == 2:
                g = np.broadcast_to(g[:, None, :],
                                    merged["vel"].shape).copy()
        merged["grav"] = g
        merged["box"] = np.asarray(scene[0].get("box", np.empty((0, 3))),
                                   np.float32).reshape(-1, 3)
        merged["box_normals"] = np.asarray(
            scene[0].get("box_normals", np.empty((0, 3))),
            np.float32).reshape(-1, 3)
        merged["frame_id"] = np.array([f["frame_id"] for f in sel])
        out.append(augment(merged, translate=translate, scale=scale,
                           grav_eqvar=grav_eqvar))
    return out


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
