"""Device time of the farthest-point-sampling kernel (``csrc/fps.cu``)
under each candidate schedule, from which ``kernels/fps.py``'s schedule
constants are chosen.

    python scripts/torch_fps_sweep.py [--out FILE]

Run from a tree's root on a machine with a CUDA device and nvcc.  Times,
by CUDA-graph replay (``profile_step.graph_ms``), one launch of the
kernel on random point sets at:

- the main path's shapes: path A's two scales (N 2688 with 1,344 picks,
  N 1344 with 672) and path B's (N 128, 128 picks), under every
  schedule that holds the set (one warp where a warp holds it; blocks of
  2-32 warps);
- sizes across the one-warp and block regimes: N 128-8192 with 256
  picks, one warp against blocks of every width;
- a batch: path B's shape in 16 sets and in 4,224 (132 SMs x 32 blocks);
- the latency floor of each schedule above: a set of one row a thread
  (32 rows for one warp, 32 x warps for a block), the same picks.

Every candidate's picks are held bitwise against the plain version on the
same inputs (a mismatch exits non-zero).  The time is independent of the
points: the pick loop has no data-dependent branch.  Prints the card's
name and power limit, one table (shape, schedule, device ms, us a pick,
its multiple of the schedule's floor) and, with ``--out``, the rows as
JSON.  Imports only the port.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dmcf_tpu_torch.kernels.fps import (  # noqa: E402
    ITEMS, Schedule, _launch, farthest_point_sample_reference, fit_items,
    schedule, threads_cap)
from dmcf_tpu_torch.profile_step import graph_ms  # noqa: E402

# (label, N, valid rows, picks): the smoke's FPS launches
PATH_SHAPES = [("path A scale 1", 2688, 2654, 1344),
               ("path A scale 2", 1344, 1327, 672),
               ("path B", 128, 42, 128)]
SIZES = [128, 192, 256, 384, 512, 768, 1024, 2048, 4096, 8192]
SIZE_PICKS = 256


def point_sets(b, n, valid, seed, device):
    """``b`` sets of ``n`` random points in the unit square (2D, as path
    A), the first ``valid`` rows of each valid."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0.0, 1.0, (b, n, 3)).astype(np.float32)
    pos[..., 2] = 0.0
    mask = np.arange(n)[None, :].repeat(b, 0) < valid
    return (torch.from_numpy(pos).to(device),
            torch.from_numpy(mask).to(device))


def candidates(n):
    """Every schedule that holds a set of ``n`` rows: one warp (if a warp
    holds it), and blocks of 2-32 warps at the fewest rows a thread."""
    out = []
    if n <= 32 * ITEMS[-1]:
        out.append(Schedule("warp", 1, fit_items(math.ceil(n / 32))))
    warps = 2
    while warps <= 32:
        rows = math.ceil(n / (32 * warps))
        if rows <= ITEMS[-1]:
            items = fit_items(rows)
            if 32 * warps <= threads_cap(items):
                out.append(Schedule("block", warps, items))
        warps *= 2
    return out


def latency_floor(sched):
    """The set on which ``sched``'s time is its pick chain alone: (rows,
    schedule), one row a thread under the same regime and warps (32 rows
    for one warp, 32 x warps for a block)."""
    return 32 * sched.warps, sched._replace(items=1)


def timed(pos, mask, picks, count, sched, ref=None):
    """Device ms of one launch under ``sched``, its picks held against
    ``ref`` (the plain version's) when given."""
    def run():
        return _launch(pos, mask, picks, count, sched)
    if ref is not None:
        idx, sel = run()
        torch.cuda.synchronize()
        if not (torch.equal(idx, ref[0]) and torch.equal(sel, ref[1])):
            raise SystemExit(f"torch_fps_sweep: {sched} differs from the "
                             f"plain version (N {pos.shape[-2]}, {picks} "
                             f"picks)")
    return graph_ms(run)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the rows as JSON to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_fps_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    floors = {}

    def floor_ms(sched, picks):
        rows, fs = latency_floor(sched)
        key = (fs, picks)
        if key not in floors:
            pos, mask = point_sets(1, rows, rows, 1, dev)
            count = torch.tensor([picks], dtype=torch.int32, device=dev)
            floors[key] = timed(pos, mask, picks, count, fs)
        return floors[key]

    rows = []

    def add(label, n, batch, picks, sched, ms):
        fl = floor_ms(sched, picks)
        rows.append(dict(shape=label, n=n, batch=batch, picks=picks,
                         schedule=sched._asdict(),
                         chosen=sched == schedule(n), device_ms=ms,
                         us_a_pick=1e3 * ms / picks, floor_ms=fl,
                         floor_multiple=ms / fl))

    shapes = PATH_SHAPES + [(f"N {n}", n, n, SIZE_PICKS) for n in SIZES]
    for label, n, valid, picks in shapes:
        pos, mask = point_sets(1, n, valid, 0, dev)
        count = torch.tensor([picks // 2], dtype=torch.int32, device=dev)
        ref = farthest_point_sample_reference(pos, mask, picks, count)
        for sched in candidates(n):
            add(label, n, 1, picks, sched,
                timed(pos, mask, picks, count, sched, ref))
    for batch in (16, 4224):
        n = picks = 128
        pos, mask = point_sets(batch, n, 42, 2, dev)
        count = torch.full((batch,), 21, dtype=torch.int32, device=dev)
        ref = farthest_point_sample_reference(pos, mask, picks, count)
        add(f"path B, B {batch}", n, batch, picks, schedule(n),
            timed(pos, mask, picks, count, schedule(n), ref))

    print(smi)
    print(f"{'shape':<26} {'schedule':<34} {'device ms':>10} "
          f"{'us a pick':>9} {'floor ms':>9} {'x floor':>7}")
    for r in rows:
        s = r["schedule"]
        name = (f"{s['regime']} w{s['warps']} i{s['items']}"
                + (" (chosen)" if r["chosen"] else ""))
        print(f"{r['shape']:<26} {name:<34} {r['device_ms']:>10.5f} "
              f"{r['us_a_pick']:>9.4f} {r['floor_ms']:>9.5f} "
              f"{r['floor_multiple']:>7.2f}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(device=smi, rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
