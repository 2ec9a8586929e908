"""One-step bf16 rounding flips of the K-list data-gradient kernel's bf16
variant, on one card.

    python scripts/torch_bwd_flips.py [--seeds 10]

Run from a tree's root (it imports that tree's ``dmcf_tpu_torch`` and the
input helpers of its ``tests/test_torch_kernels.py``).  For the cases of
the card tests where a bf16 tap gradient can land one bf16 step from the
plain backward's (the edge-point inputs, the WaterRamps trunk shape, the
trunk with most indices past the end), over ``--seeds`` random dout, it
prints one JSON line a case: the worst relative errors of da and dt
against ``cconv_klist_bwd_reference`` and how many seeds pass the card
tests' 2e-3; where the tree's data launch keeps dT in a workspace
(``_bwd_data_launch``), also what ``kernels.cconv_klist.bf16_data_flips``
gives: the one-step flips of the kernel's dT against the plain dT =
bf16(dout bf16(W)^T) on the tap rows the slots touch, da and dt against
the plain backward fed the kernel's dT, and the elements of da and dt
beyond 2e-3 of the plain backward (``beyond``), of them those whose slot
touches no flipped tap row (``unexplained``).
Needs a CUDA device and nvcc; imports only the port and its tests.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_bwd_flips needs a CUDA device")
    sys.path[:0] = [os.getcwd(), os.path.join(os.getcwd(), "tests")]
    from dmcf_tpu_torch.kernels import cconv_klist as ck
    from test_torch_kernels import cloud_inputs, klist_inputs

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    ks = (1, 8, 8)
    cases = {"edges": klist_inputs(200, 40, 32, 32, ks, "poly6", False, 7,
                                   dev, "edges")[0],
             "trunk": cloud_inputs(2688, 2688, 40, 32, 32, ks, 2, False, 17,
                                   dev)[0]}
    clamped = list(cases["trunk"])
    clamped[3] = clamped[3][:40].contiguous()
    cases["clamped"] = clamped
    keeps_dT = hasattr(ck, "_bwd_data_launch")
    for name, (idx, a, t, feats, w) in cases.items():
        q, cin = idx.shape[0], feats.shape[1]
        f16, w16 = feats.bfloat16(), w.bfloat16()
        row = {"case": name, "seeds": args.seeds, "pass": 0, "da": 0.0,
               "dt": 0.0}
        if keeps_dT:
            row.update(dT_flips=0, dT_elements=0, da_forced=0.0,
                       dt_forced=0.0, pass_forced=0, beyond=0,
                       unexplained=0)
        for seed in range(args.seeds):
            g = torch.Generator(device=dev).manual_seed(seed)
            dout = torch.randn((q, w.shape[1]), generator=g, device=dev)
            full = (dout, idx, a, t, f16, w16, ks, None)
            _, _, _, da_ref, dt_ref = ck.cconv_klist_bwd_reference(
                *full, precision="default")
            if keeps_dT:
                dfeats, _, da, dt, _, _ = ck._bwd_data_launch(*full)
                res = ck.bf16_data_flips(*full[:7], (dfeats, da, dt), 2e-3)
                row["dT_flips"] += res["dT_flips"]
                row["dT_elements"] += res["dT_elements"]
                for k in ("da", "dt"):
                    row[f"{k}_forced"] = max(row[f"{k}_forced"],
                                             res["forced"][k])
                row["pass_forced"] += int(max(res["forced"]["da"],
                                              res["forced"]["dt"]) <= 2e-3)
                for k in ("beyond", "unexplained"):
                    row[k] += sum(res[k].values())
            else:
                _, _, da, dt = ck.cconv_klist_bwd_data(*full,
                                                       precision="default")
            err = [float((x - y).abs().max() / y.abs().max())
                   for x, y in ((da, da_ref), (dt, dt_ref))]
            row["da"] = max(row["da"], err[0])
            row["dt"] = max(row["dt"], err[1])
            row["pass"] += int(max(err) <= 2e-3)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
