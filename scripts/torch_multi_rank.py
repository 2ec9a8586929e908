"""``chip_smoke.py``'s phase 25 alone, or with ``--sharded`` its phase 26:
the port's multi-rank paths (``dmcf_tpu_torch/parallel``) on the card.

    python scripts/torch_multi_rank.py [--sharded] [--out FILE]

Run from a tree's root on a machine with a CUDA device and nvcc.  Builds
the kernels (one nvcc a source, all started together), turns TF32 off as
the smoke does, and runs ``chip_smoke.multi_rank_phase``: (a) an NCCL
world of one rank, spawned (the momentum data-parallel train step bit for
bit the one-process step, a one-slab halo step), (b) two gloo ranks on
the one card (Liquid3d's halo rollout on 13,200 fluid at "highest"
against one process, a timed halo rollout of the config as shipped, the
data-parallel train step with one item a rank).  ``--sharded`` runs
``chip_smoke.sharded_phase`` instead: the particle-sharded step
(``parallel/spatial.make_sharded_step``) at world size 1 over NCCL, bit
for bit the one-process step, and on two gloo ranks sharing the card
(WaterRamps' launches against their plain versions, a timed rollout,
path B and Liquid3d against one process).  Every failed check exits
non-zero.
Prints the card's name and power limit and, with ``--out``, writes the
phase's launches and figures as JSON.  Imports only the port.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="write the figures here as JSON")
    parser.add_argument("--sharded", action="store_true",
                        help="run phase 26 (the particle-sharded step) "
                        "instead of phase 25")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_multi_rank: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from dmcf_tpu_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    with ThreadPoolExecutor() as pool:
        list(pool.map(build.build, build.sources()))
    print(f"built {len(build.sources())} sources in {time.time() - t0:.1f} s")
    max_err = {False: 0.0, True: 0.0}
    run = (chip_smoke.sharded_phase if args.sharded
           else chip_smoke.multi_rank_phase)
    out = run(ROOT, torch.device("cuda"), max_err, smi)
    out.pop("nccl", None)
    out["max_abs_err"] = {"fp32": max_err[False], "bf16": max_err[True]}
    out["card"] = smi
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    print(smi)
    print(json.dumps({"paths": out["paths"],
                      "ms_per_step": out["ms_per_step"],
                      "seconds": out["seconds"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
