"""Scene generators (the port's copies of dmcf_tpu/data/generators.py:
``SPH1D``'s setup, ``_column_frames``, ``gen_column_data``,
``_sample_sphere``, ``gen_momentum_data`` and ``gen_free_fall_data``; same
scenes for the same arguments and seed).

``gen_column_data`` solves its 1D SPH columns with
``kernels/column_sph.column_solve``: on a CUDA device the hand-written
kernel (one launch for every scene and frame of a split), on the CPU the
plain PyTorch version, which is meant for test sizes (each frame's
pressure projection runs up to ``max_iter`` = 10,000 iterations, so a
full split takes tens of minutes on a CPU).  The solver matches JAX's
``_column_solve_jax`` operation by operation but sums pairs in its own
fixed order, so its values lie within rounding drift of JAX's
(``tests/test_torch_column.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.column_sph import column_solve


class SPH1D:
    """The 1D column solver's constants and initial state (the numpy setup
    of the JAX package's ``SPH1D``; the time integration is
    ``column_solve``)."""

    def __init__(self, radius=0.25, mass=1.0, dens=None, stiffness=10.0,
                 visc=1e-4, gravity=-10.0):
        self.h = 4 * radius
        self.mass = mass
        self.rest_dens = mass / (radius * 2.0) if dens is None else dens
        self.stiffness = stiffness
        self.visc = visc
        self.gravity = gravity
        self.setup(1)

    def setup(self, cnt, bcnt=2, rnd=0.0, offset=0.0):
        """Stack ``cnt`` fluid particles above ``bcnt`` boundary particles at
        spacing h/2.  Column 0 = position, 1 = velocity, 2 = mass."""
        self.bcnt = bcnt
        n = cnt + bcnt
        self.particles = np.zeros((n, 3), dtype="float32")
        self.particles[:, 0] = np.arange(n, dtype="float32") * self.h * 0.5
        if rnd > 0:
            self.particles[bcnt:, 0] += \
                np.random.normal(scale=rnd, size=cnt) * self.h
        if offset > 0:
            self.particles[bcnt:, 0] += offset
        self.particles[:, 2] = self.mass


def _column_frames(seq, idx, res, obs_size, grav, width=1, side_walls=False):
    """1D column sequence -> list of frame dicts in the dataset schema
    (reference datasets/column_gen.py:188-263)."""
    frames = []
    for t in range(len(seq)):
        fy = seq[t, :-obs_size, 0]
        vy = seq[t, :-obs_size, 1]
        by = seq[t, -obs_size:, 0]
        z = np.zeros_like(fy)
        zb = np.zeros_like(by)
        frame = {
            "frame_id": t,
            "scene_id": "sim_%04d" % idx,
            "grav": np.array([0.0, grav, 0.0]),
            "pos": np.stack([z, fy, z], axis=-1),
            "vel": np.stack([z, vy, z], axis=-1),
            "box": np.stack([zb, by, zb], axis=-1),
            "box_normals": np.stack([zb, zb + 1, zb], axis=-1),
        }

        if width > 1:
            xs = np.stack([np.linspace(-(width - 1) * 0.25,
                                       (width - 1) * 0.25, width),
                           np.zeros(width), np.zeros(width)], axis=-1)
            frame["pos"] = (frame["pos"][:, None, :] +
                            xs[None]).reshape(-1, 3)
            frame["box"] = (frame["box"][:, None, :] +
                            xs[None]).reshape(-1, 3)
            frame["vel"] = np.repeat(frame["vel"], width, axis=0)
            frame["box_normals"] = np.repeat(frame["box_normals"], width,
                                             axis=0)
            if side_walls:
                zz = np.zeros(50)
                yy = np.arange(50, dtype="float32") * 0.5
                walls_x = [-(width + 1) * 0.25, -(width + 1) * 0.25 - 0.5,
                           (width + 1) * 0.25, (width + 1) * 0.25 + 0.5]
                walls_n = [1, 1, -1, -1]
                frame["box"] = np.concatenate(
                    [frame["box"]] + [np.stack([zz + x, yy, zz], axis=-1)
                                      for x in walls_x], axis=0)
                frame["box_normals"] = np.concatenate(
                    [frame["box_normals"]] +
                    [np.stack([zz + n, zz, zz], axis=-1) for n in walls_n],
                    axis=0)

        for k in ("pos", "vel", "box", "grav"):
            frame[k] = frame[k] / res
        frames.append(frame)
    return frames


def column_problem(data_cnt, timesteps, res=100, min_pts=1, max_pts=28,
                   pts_cnt=None, obs_size=2, dt=0.01, rnd=0.0, radius=0.25,
                   mass=1.0, stiffness=20.0, visc=0.1, gravity=-10.0,
                   offset=0.0, max_iter=10000):
    """The solver's inputs for ``gen_column_data``'s arguments: (x0 [S, P],
    v0 [S, P], counts [S] int32, the keyword arguments of
    ``column_solve``).  Draws from ``np.random`` as the JAX package does
    (the particle counts, then each scene's jitter), so a seeded split
    gives the same scenes."""
    gravity = gravity * res
    solver = SPH1D(radius=radius, mass=mass, stiffness=stiffness, visc=visc,
                   gravity=gravity)
    if pts_cnt is None:
        if rnd > 0:
            pts_cnt = np.random.randint(min_pts, max_pts + 1, size=data_cnt)
        elif data_cnt <= max_pts - min_pts + 1:
            pts_cnt = np.sort(np.random.choice(
                np.arange(min_pts, max_pts + 1), size=data_cnt,
                replace=False))
        else:
            raise NotImplementedError(
                "data_cnt > distinct particle counts requires rnd > 0")
    counts = [int(pts_cnt[d]) + obs_size for d in range(data_cnt)]
    x0 = np.zeros((data_cnt, max(counts)), np.float32)
    v0 = np.zeros_like(x0)
    for d in range(data_cnt):
        # the same np.random draws, in the same order, as the JAX loop
        solver.setup(int(pts_cnt[d]), obs_size, rnd=rnd, offset=offset)
        x0[d, :counts[d]] = solver.particles[:, 0]
        v0[d, :counts[d]] = solver.particles[:, 1]
    kw = dict(bcnt=obs_size, timesteps=timesteps, mass=mass,
              gravity=gravity, rest_dens=solver.rest_dens,
              stiffness=stiffness, visc=visc, h=solver.h, dt=dt,
              max_iter=max_iter)
    return x0, v0, np.asarray(counts, np.int32), kw


def gen_column_data(data_cnt, timesteps, res=100, obs_size=2, width=1,
                    side_walls=False, device="cuda", **kwargs):
    """Generate ``data_cnt`` 1D column scenes of ``timesteps`` frames
    (reference datasets/column_gen.py:266-317; the other arguments are
    ``column_problem``'s).  Relies on the caller having seeded np.random
    (DatasetGroup does) for reproducible scene sets.

    Every scene is solved at once by ``column_solve`` on ``device``: a
    CUDA device launches the kernel (without a GPU it raises), the CPU
    runs the plain version.  ``max_iter`` caps each frame's projection
    (JAX's fixed 10,000; a smaller cap makes other data, for tests).
    """
    from .. import resolve_device

    device = resolve_device(device)
    x0, v0, counts, kw = column_problem(data_cnt, timesteps, res=res,
                                        obs_size=obs_size, **kwargs)
    xs, vs = column_solve(*(torch.as_tensor(a, device=device)
                            for a in (x0, v0, counts)), **kw)[:2]
    xs, vs = xs.cpu().numpy(), vs.cpu().numpy()

    data = []
    for d in range(data_cnt):
        n = int(counts[d])
        seq = np.empty((xs.shape[1], n, 2), dtype="float32")
        seq[:, :, 0] = xs[d, :, :n][:, ::-1]
        seq[:, :, 1] = vs[d, :, :n][:, ::-1]
        data.append(_column_frames(seq, d, res, obs_size, kw["gravity"],
                                   width, side_walls))
    return data


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


def gen_momentum_data(data_cnt=1, timesteps=50, res=100, dim=2, radius=12,
                      dt=0.01, gravity=0.0, speed=30.0, device=None):
    """Momentum-validation scenes: two particle blobs on a collision course
    with one far boundary point.  Ground truth is ballistic free flight;
    the scored quantity is a learned model's momentum drift.  Made with
    numpy on the host: ``device`` is taken and not used."""
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
                       dt=0.01, gravity=-10.0, mode=0, device=None):
    """Analytic ballistic sphere drop.  mode 0: explicit Euler; mode 1:
    trapezoid position update.  Made with numpy on the host: ``device`` is
    taken and not used."""
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
