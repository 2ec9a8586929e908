"""Analytic scene generators (the port's numpy copies of
dmcf_tpu/data/generators.py ``_sample_sphere``, ``gen_momentum_data`` and
``gen_free_fall_data``; same arrays for the same arguments and seed).

The 1D SPH ``column`` generator solves each frame with a projection loop
that runs to ~10,000 iterations (JAX's ``_column_solve_jax``); its solver
is not ported yet (ROADMAP queue 1 item 9), so ``gen_column_data`` raises.
Column-shaped data handed to the pipeline runs all the same.
"""

from __future__ import annotations

import numpy as np


def _sample_sphere(r, res, sres, dim=2):
    rg = np.linspace(0.5, res - 0.5, int((res - 2) * sres))
    grid = np.stack(np.meshgrid(rg,
                                rg if dim > 1 else [0.0],
                                rg if dim > 2 else [0.0],
                                indexing="ij"), axis=-1)
    center = [res / 2, res / 2 if dim > 1 else 0.0,
              res / 2 if dim > 2 else 0.0]
    keep = np.linalg.norm(grid - center, axis=-1) < r
    return grid[keep].reshape(-1, 3)


def gen_column_data(**cfg):
    raise NotImplementedError(
        "the column generator's SPH solver is not ported yet (ROADMAP queue "
        "1 item 9); hand the pipeline a Dataset of column scenes instead")


def gen_momentum_data(data_cnt=1, timesteps=50, res=100, dim=2, radius=12,
                      dt=0.01, gravity=0.0, speed=30.0):
    """Momentum-validation scenes: two particle blobs on a collision course
    with one far boundary point.  Ground truth is ballistic free flight;
    the scored quantity is a learned model's momentum drift."""
    g = np.array([0.0, gravity * res, 0.0])
    data = []
    for d in range(data_cnt):
        blob = _sample_sphere(radius, res, 0.5, dim)
        offset = np.array([res * 0.25, 0.0, 0.0])
        pos = np.concatenate([blob - offset, blob + offset], 0)
        vel = np.concatenate([
            np.tile([speed, 0.0, 0.0], (len(blob), 1)),
            np.tile([-speed, 0.0, 0.0], (len(blob), 1))], 0)
        seq_p, seq_v = [pos], [vel]
        for t in range(timesteps):
            v1 = seq_v[t] + dt * g
            seq_p.append(seq_p[t] + dt * v1)
            seq_v.append(v1)
        frames = []
        for t in range(len(seq_p)):
            frames.append({
                "frame_id": t,
                "scene_id": "sim_%04d" % d,
                "grav": g / res,
                "pos": (seq_p[t] / res).astype(np.float32),
                "vel": (seq_v[t] / res).astype(np.float32),
                "box": np.ones((1, 3), np.float32) * 2.0,
                "box_normals": np.zeros((1, 3), np.float32),
            })
        data.append(frames)
    return data


def gen_free_fall_data(data_cnt=1, timesteps=100, res=100, dim=2, radius=20,
                       dt=0.01, gravity=-10.0, mode=0):
    """Analytic ballistic sphere drop.  mode 0: explicit Euler; mode 1:
    trapezoid position update."""
    gravity = gravity * res
    g = np.array([0.0, gravity, 0.0])
    data = []
    for d in range(data_cnt):
        pos = [_sample_sphere(radius, res, 0.5, dim)]
        vel = [np.zeros_like(pos[0])]
        for t in range(timesteps):
            v1 = vel[t] + dt * g
            if mode == 0:
                p1 = pos[t] + dt * v1
            else:
                p1 = pos[t] + dt * vel[t] + (vel[t] + v1) / 2
            pos.append(p1)
            vel.append(v1)
        frames = []
        for t in range(len(pos)):
            frames.append({
                "frame_id": t,
                "scene_id": "sim_%04d" % d,
                "grav": g / res,
                "pos": pos[t] / res,
                "vel": vel[t] / res,
                "box": np.ones((1, 3)) * 2.0,
                "box_normals": np.zeros((1, 3)),
            })
        data.append(frames)
    return data
