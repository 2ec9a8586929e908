"""Write ``tests/data/torch_column_ref.npz``: the JAX package's column
solver (``dmcf_tpu.data.generators._column_solve_jax``, on the CPU) on the
first 3 scenes of ``configs/column/symnet.yml``'s valid split, at the
config's full size (100 frames, the solver's 10,000 projection
iterations a frame, the config's ``dt``, ``gravity`` and ``res``).

    python -m scripts.make_torch_column_ref

The scenes' particle counts come from the split's seed (43) drawn as
``gen_column_data`` draws them.  The file holds ``pts_cnt`` [3], the
solver's raw outputs ``xs`` and ``vs`` [3, 100, P] (particle order as the
solver holds them, boundary first; zero past a scene's particles) and the
scalars they were made with.

Those scenes hold 9-12 particles; the splits run up to 42.  So the file
also holds the largest scene, 40 fluid particles (every split draws its
scenes without jitter, so a count fixes the scene): ``xs40``, ``vs40`` the
JAX solver's output, and ``xs40_perm``, ``vs40_perm`` the same solver on
the same scene with its fluid particles above the lowest one stored in a
seeded random order (``PERM_SEED``), put back in order.  The two differ
only in the order in which XLA sums each particle's pairs; how far they
drift apart over the 100 frames is the rounding drift that any other sum
order, the port's included, is to be held to (``scripts/column_drift.py``
measures more such pairs).

``chip_smoke.py`` holds the port's CUDA column kernel against this file
with numpy alone; ``tests/test_torch_column.py`` checks that scene 0 is
what the JAX package makes today.  Imports JAX: this script is no part of
the port.
"""

from __future__ import annotations

import os
from functools import partial

import numpy as np
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "column", "symnet.yml")
OUT = os.path.join(ROOT, "tests", "data", "torch_column_ref.npz")
SCENES = 3
OBS_SIZE = 2  # gen_column_data's default boundary particles
LARGEST = 40  # the splits' largest fluid count (max_pts, the test split)
PERM_SEED = 0


def split_config():
    """The valid split's generator arguments as DatasetGroup merges them."""
    with open(CONFIG) as f:
        ds = yaml.safe_load(f)["dataset"]
    cfg = {k: v for k, v in ds.items()
           if k not in ("name", "type", "train", "valid", "test")}
    return {**ds["valid"], **cfg}


def fluid_permutation(n, seed=PERM_SEED):
    """A particle order for a scene of ``n`` fluid particles that keeps the
    boundary and the lowest fluid particle in place (the solver copies the
    pressure of particle ``OBS_SIZE`` to the boundary) and shuffles the
    rest."""
    perm = np.arange(n + OBS_SIZE)
    perm[OBS_SIZE + 1:] = OBS_SIZE + 1 + \
        np.random.RandomState(seed).permutation(n - 1)
    return perm


def solve_scene(n, cfg, jax_device=None, perm=None, dtype=np.float32):
    """One scene of ``n`` fluid particles, as ``gen_column_data`` solves it:
    (xs, vs) [timesteps, n + OBS_SIZE].  With ``perm`` the solver holds the
    particles in that order (the output is put back in order); ``dtype``
    float64 needs JAX's x64 mode."""
    import jax

    from dmcf_tpu.data import generators

    gravity = cfg["gravity"] * cfg["res"]
    solver = generators.SPH1D(radius=0.25, mass=1.0, stiffness=20.0,
                              visc=0.1, gravity=gravity)
    solver.setup(n, OBS_SIZE)
    order = np.arange(n + OBS_SIZE) if perm is None else perm
    fn = jax.jit(partial(
        generators._column_solve_jax, bcnt=OBS_SIZE, gravity=gravity,
        rest_dens=solver.rest_dens, stiffness=20.0, visc=0.1, h=solver.h,
        timesteps=cfg["timesteps"], dt=cfg["dt"]))
    with jax.default_device(jax_device or jax.devices("cpu")[0]):
        xs, vs = fn(solver.particles[order, 0].astype(dtype),
                    solver.particles[order, 1].astype(dtype), dtype(1.0))
    back = np.argsort(order)
    return np.asarray(xs)[:, back], np.asarray(vs)[:, back]


def pts_cnt(cfg):
    """The split's first ``SCENES`` particle counts under its seed."""
    np.random.seed(cfg["seed"])
    cnt = np.sort(np.random.choice(
        np.arange(cfg["min_pts"], cfg["max_pts"] + 1),
        size=cfg["data_cnt"], replace=False))
    return cnt[:SCENES]


def main():
    cfg = split_config()
    cnt = pts_cnt(cfg)
    p = int(cnt.max()) + OBS_SIZE
    xs = np.zeros((SCENES, cfg["timesteps"], p), np.float32)
    vs = np.zeros_like(xs)
    for s, n in enumerate(cnt):
        x, v = solve_scene(int(n), cfg)
        xs[s, :, :x.shape[1]] = x
        vs[s, :, :v.shape[1]] = v
    xs40, vs40 = solve_scene(LARGEST, cfg)
    xs40_perm, vs40_perm = solve_scene(LARGEST, cfg,
                                       perm=fluid_permutation(LARGEST))
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(
        OUT, pts_cnt=cnt.astype(np.int32), xs=xs, vs=vs,
        xs40=xs40, vs40=vs40, xs40_perm=xs40_perm, vs40_perm=vs40_perm,
        obs_size=OBS_SIZE, timesteps=cfg["timesteps"], dt=cfg["dt"],
        gravity=cfg["gravity"], res=cfg["res"], max_iter=10000,
        seed=cfg["seed"], perm_seed=PERM_SEED)
    print(f"wrote {OUT}: pts_cnt {cnt.tolist()}, xs {xs.shape}, the "
          f"{LARGEST}-particle scene {xs40.shape}; it drifts from its "
          f"permuted run by {np.abs(xs40 - xs40_perm).max():.3e} in "
          f"position, {np.abs(vs40 - vs40_perm).max():.3e} in velocity")


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    main()
