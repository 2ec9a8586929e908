"""How far the column solver drifts from itself when only rounding
changes: the witness for the port's distance from JAX's column data.

    python -m scripts.column_drift [--n 40] [--port]

Solves one scene of ``--n`` fluid particles (no jitter, so the count fixes
the scene) at ``configs/column/symnet.yml``'s full size (100 frames, the
solver's 10,000 projection iterations a frame) on the CPU, four ways:

  jax       the JAX package's solver (``_column_solve_jax``), fp32, as
            ``gen_column_data`` runs it
  jax_perm  the same with the fluid particles above the lowest one in a
            seeded random order, so that XLA sums each particle's pairs in
            another order (``make_torch_column_ref.fluid_permutation``)
  jax_f64   the same solver in float64 (JAX's x64 mode)
  port      with ``--port``: the port's plain solver
            (``dmcf_tpu_torch.kernels.column_sph.column_solve_reference``,
            bit for bit the CUDA kernel; about ten minutes on a CPU)

and prints, for each pair of them, the largest difference in position and
in velocity over the frames and at a few frames along the way.  The
solver's units: h = 1, positions up to 21, velocities up to 20.  Imports
JAX: this script is no part of the port.
"""

from __future__ import annotations

import argparse
import itertools
import time

import numpy as np

from scripts import make_torch_column_ref as ref

FRAMES = (1, 5, 10, 20, 50, 99)


def port_scene(n, cfg):
    """The port's plain solver on the same scene: (xs, vs) fp32."""
    import torch

    from dmcf_tpu_torch.data.generators import column_problem
    from dmcf_tpu_torch.kernels.column_sph import column_solve_reference

    x0, v0, counts, kw = column_problem(
        1, cfg["timesteps"], res=cfg["res"], pts_cnt=[n], dt=cfg["dt"],
        gravity=cfg["gravity"], obs_size=ref.OBS_SIZE)
    xs, vs = column_solve_reference(
        torch.from_numpy(x0), torch.from_numpy(v0),
        torch.from_numpy(counts), **kw)[:2]
    return xs[0].numpy(), vs[0].numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=ref.LARGEST)
    ap.add_argument("--port", action="store_true")
    args = ap.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    cfg = ref.split_config()
    runs = {}
    t0 = time.time()
    runs["jax"] = ref.solve_scene(args.n, cfg)
    runs["jax_perm"] = ref.solve_scene(
        args.n, cfg, perm=ref.fluid_permutation(args.n))
    if args.port:
        import torch

        torch.set_num_threads(2)
        runs["port"] = port_scene(args.n, cfg)
    # x64 last: it changes how JAX types the fp32 runs' constants
    jax.config.update("jax_enable_x64", True)
    runs["jax_f64"] = ref.solve_scene(args.n, cfg, dtype=np.float64)
    print(f"{args.n} fluid particles, {cfg['timesteps']} frames "
          f"({time.time() - t0:.1f} s); largest |x| "
          f"{np.abs(runs['jax'][0]).max():.3f}, |v| "
          f"{np.abs(runs['jax'][1]).max():.3f}")
    for a, b in itertools.combinations(runs, 2):
        dx = np.abs(runs[a][0] - runs[b][0]).max(axis=1)
        dv = np.abs(runs[a][1] - runs[b][1]).max(axis=1)
        print(f"{a} vs {b}: positions {dx.max():.3e}, velocities "
              f"{dv.max():.3e}; by frame " + ", ".join(
                  f"{t}: {dx[t]:.2e}/{dv[t]:.2e}" for t in FRAMES))


if __name__ == "__main__":
    main()
