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

    python scripts/torch_bwd_flips.py --k 40 96 256 352 512 1024 1856 \
        [--seeds 3] [--widths 8x32 24x8]

sweeps K instead, at Liquid3d's conv widths (Cin x Cout, 4x4x4 taps) on
3D clouds whose sources are a quarter of the queries (as Liquid3d's
coarse-scale pairs: each feats row is read by ~3 K slots, capped at 4224
queries), and holds the bf16 dfeats against dfeats summed in fp64 from
the same bf16-rounded taps and dT: the kernel's (fed its own dT) and the
plain version's (``bwd_data_from_dT`` fed the kernel's dT, then rounded
to bf16), each as the largest distance from the fp64 sum in bf16 steps
(``steps``) and the elements that are not the fp64 sum rounded to bf16
(``misrounded``); also the one-step flips of the kernel against the
plain backward itself (its own dT), the count the card checks cap, and
the dT flips.  One JSON line a K and width.
Needs a CUDA device and nvcc; imports only the port and its tests.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch


def sweep_inputs(k, cin, cout, seed, dev, fill=0.8, max_q=4224):
    """K-list inputs from a search of Q queries over N = max(1056, 2.5 K)
    sources in a 3D cell (Q = min(4 N, max_q)), the radius sized to ~fill
    K neighbours a query; Liquid3d's 4x4x4 taps and window."""
    from dmcf_tpu_torch.ops import cconv, neighbors, windows
    g = torch.Generator().manual_seed(seed)
    n = max(1056, int(2.5 * k))
    q = min(4 * n, max_q)
    side = 0.1
    src = torch.rand((n, 3), generator=g) * side
    qry = torch.rand((q, 3), generator=g) * side
    radius = side * (3 * fill * k / n / (4 * np.pi)) ** (1 / 3)
    ks = (4, 4, 4)
    nl = neighbors.search(src, qry, radius, k)
    idx, a, t = cconv.klist_geometry(
        nl, 2 * radius, ks, window_fn=windows.get_window_func("poly6"))
    feats = torch.randn((n, cin), generator=g)
    w = torch.randn((64 * cin, cout), generator=g) / np.sqrt(64 * cin)
    return [x.to(dev) for x in (idx, a, t, feats, w)], ks


def bf16_steps(x, ref):
    """(the largest |x - ref| in bf16 steps at ref, the elements where x
    is not ref rounded to bf16) over the elements where ref != 0."""
    nz = ref != 0
    _, e = torch.frexp(ref[nz])
    ulp = torch.ldexp(torch.ones_like(ref[nz]), e - 8)
    dist = (x.double()[nz] - ref[nz]).abs() / ulp
    miss = x.to(torch.bfloat16) != ref.to(torch.bfloat16)
    return float(dist.max()) if dist.numel() else 0.0, int(miss.sum())


def dfeats_fp64(dT, idx, a, t, n, ks, interpolation="linear"):
    """dfeats = sum over the slots reading a row of A_slot dT[q] in fp64,
    A the bf16-rounded taps (the variant's), dT [Q, S, Cin]."""
    from dmcf_tpu_torch.kernels.cconv_klist import _tap_tensor, round_bf16
    A = round_bf16(_tap_tensor(t, a, ks, interpolation)).double()
    G = torch.einsum("qks,qsc->qkc", A, dT.double())
    rows = idx.clamp(0, n - 1).long().reshape(-1)
    return torch.zeros((n, dT.shape[2]), dtype=torch.float64,
                       device=dT.device).index_add_(
        0, rows, G.reshape(-1, dT.shape[2]))


def k_sweep(ks_list, widths, seeds, dev):
    """One JSON line a K and width: the kernel's and the plain version's
    bf16 dfeats against fp64 (see the module docstring)."""
    from dmcf_tpu_torch.kernels import cconv_klist as ck
    for k in ks_list:
        for cin, cout in widths:
            row = {"k": k, "cin": cin, "cout": cout, "seeds": seeds,
                   "elements": 0, "mean_row_len": 0.0, "max_row_len": 0,
                   "kernel_steps": 0.0, "kernel_misrounded": 0,
                   "plain_steps": 0.0, "plain_misrounded": 0,
                   "flips_vs_plain": 0, "worst_flip_rate": 0.0,
                   "dT_flips": 0}
            for seed in range(seeds):
                (idx, a, t, feats, w), ks = sweep_inputs(k, cin, cout,
                                                         seed, dev)
                q, n = idx.shape[0], feats.shape[0]
                rows = idx.clamp(0, n - 1)[a != 0].long()
                lens = torch.bincount(rows, minlength=n)
                row["mean_row_len"] = max(row["mean_row_len"],
                                          float(lens.float().mean()))
                row["max_row_len"] = max(row["max_row_len"],
                                         int(lens.max()))
                f16, w16 = feats.bfloat16(), w.bfloat16()
                g = torch.Generator(device=dev).manual_seed(seed)
                dout = torch.randn((q, cout), generator=g, device=dev)
                full = (dout, idx, a, t, f16, w16, ks, None)
                work = torch.empty(ck.data_workspace_bytes(
                    q, k, n, cin, cout, *ks, 1), dtype=torch.uint8,
                    device=dev)
                got = ck._bwd_data_launch(*full, work=work)[0].bfloat16()
                s_total = 64
                dT = work[:2 * q * s_total * cin].view(
                    torch.bfloat16).float().reshape(q, s_total, cin)
                hz = ck._tap_tensor(t, torch.ones_like(a), ks) != 0
                touched = hz.any(dim=1)[..., None]
                dT = torch.where(touched, dT, 0.0)
                plain_dT = ck.round_bf16(
                    dout @ ck.round_bf16(w.float()).T).reshape(dT.shape)
                plain_dT = torch.where(touched, plain_dT, 0.0)
                row["dT_flips"] += ck.rounding_flips(dT, plain_dT)[1]
                exact = dfeats_fp64(dT, idx, a, t, n, ks)
                plain = ck.bwd_data_from_dT(dT, idx, a, t, feats, ks)[0]
                ref = ck.cconv_klist_bwd_reference(
                    *full, precision="default")[0]
                for name, x in (("kernel", got), ("plain", plain.bfloat16())):
                    steps, miss = bf16_steps(x, exact)
                    row[f"{name}_steps"] = max(row[f"{name}_steps"], steps)
                    row[f"{name}_misrounded"] += miss
                flips = ck.rounding_flips(got, ref)[1]
                row["flips_vs_plain"] += flips
                row["elements"] += n * cin
                row["worst_flip_rate"] = max(row["worst_flip_rate"],
                                             flips / (n * cin))
                del exact, plain, ref, work
                torch.cuda.empty_cache()
            print(json.dumps(row), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=None,
                    help="dout seeds a case (default 10; 3 with --k)")
    ap.add_argument("--k", type=int, nargs="+",
                    help="sweep these K against fp64 instead")
    ap.add_argument("--widths", nargs="+", default=["8x32", "24x8"],
                    help="Cin x Cout of the --k sweep")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_bwd_flips needs a CUDA device")
    sys.path[:0] = [os.getcwd(), os.path.join(os.getcwd(), "tests")]
    from dmcf_tpu_torch.kernels import cconv_klist as ck

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if args.k:
        widths = [tuple(int(v) for v in wd.split("x")) for wd in args.widths]
        k_sweep(args.k, widths, args.seeds or 3, dev)
        return
    args.seeds = args.seeds or 10
    from test_torch_kernels import cloud_inputs, klist_inputs
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
