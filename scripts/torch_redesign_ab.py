"""Device time of the K-list filter-gradient kernel and of the column
solver, for comparing two trees of the port on one card.

    python -m scripts.torch_redesign_ab [--label NAME] [--splits train,...]

Imports ``dmcf_tpu_torch`` and ``chip_smoke`` from the tree it is run in,
so run it from each tree's root in turn on one card (parent, change,
change, parent).  Prints the card's name and power limit and one JSON
line: the filter kernel's device time a call (CUDA-graph replay,
``profile_step.graph_ms``) in both variants at the WaterRamps trunk shape
(``chip_smoke.waterramps_shapes`` on the bench scene) and at shapes of the
momentum model's K 48, 96 and 256 pairs (a search over N points in a
square, as ``tests/test_torch_kernels.py`` builds them), and the seconds
and microseconds a projection iteration of ``configs/column/symnet.yml``'s
splits made by the column kernel.  Needs a CUDA device and nvcc; imports
only the port.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# (name, Q, N, K, Cin, Cout): the momentum model's same-scale K 48 pairs
# and its downsampling pairs
LONG_SHAPES = [("K48", 320, 320, 48, 32, 32),
               ("K48_small", 80, 80, 48, 4, 8),
               ("K96", 160, 320, 96, 24, 8), ("K256", 80, 320, 256, 24, 4),
               ("K256_16", 80, 320, 256, 16, 8)]


def long_list_inputs(q, n, k, cin, cout, seed, device):
    """N points in a square, Q queries among them, the radius sized to
    ~0.8 K points, kernel [1, 8, 8], poly6 window."""
    from dmcf_tpu_torch.ops import cconv, neighbors, windows

    g = torch.Generator().manual_seed(seed)
    side = 0.1
    pts = torch.rand((n, 3), generator=g) * side
    pts[:, 2] = 0.0
    radius = side * (0.8 * k / (n * np.pi)) ** 0.5
    nl = neighbors.search(pts, pts[:q], radius, k)
    idx, a, t = cconv.klist_geometry(nl, 2 * radius, (1, 8, 8),
                                     window_fn=windows.get_window_func(
                                         "poly6"))
    feats = torch.randn((n, cin), generator=g)
    w = torch.randn((64 * cin, cout), generator=g) * 0.1
    return [x.to(device) for x in (idx, a, t, feats, w)], (1, 8, 8)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--splits", default="train")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_redesign_ab needs a CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    import yaml
    from dmcf_tpu_torch.data.generators import column_problem
    from dmcf_tpu_torch.kernels.cconv_klist import cconv_klist_bwd_filter
    from dmcf_tpu_torch.kernels.column_sph import column_solve
    from dmcf_tpu_torch.profile_step import graph_ms
    from dmcf_tpu_torch.scene import bench_sample, build_scene

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    with open(os.path.join("configs", "WaterRamps.yml")) as f:
        cfg = yaml.safe_load(f)["model"]
    sample = bench_sample(*build_scene(), device=dev)
    i_, a_, t_, f_, w_, ks_, _ = chip_smoke.waterramps_shapes(
        cfg, sample, dev)["trunk"]
    shapes = {"trunk": ([i_, a_, t_, f_, w_], ks_)}
    for name, q, n, k, cin, cout in LONG_SHAPES:
        shapes[name] = long_list_inputs(q, n, k, cin, cout, k + cin, dev)
    out = {"label": args.label, "filter_device_ms": {}, "column": {}}
    for name, (xs, ks) in shapes.items():
        idx, a, t, feats, w = xs
        g = torch.Generator(device=dev).manual_seed(0)
        dout = torch.randn((idx.shape[0], w.shape[1]), generator=g,
                           device=dev)
        for prec, tag in (("highest", "fp32"), ("default", "bf16")):
            fw = (feats, w) if prec == "highest" else (feats.bfloat16(),
                                                       w.bfloat16())
            full = (dout, idx, a, t, *fw, ks, None)
            out["filter_device_ms"][f"{name}_{tag}"] = graph_ms(
                lambda: cconv_klist_bwd_filter(*full, precision=prec))
    ds = chip_smoke.column_config(os.getcwd())["dataset"]
    for split in args.splits.split(","):
        c = chip_smoke.column_split(ds, split)
        np.random.seed(c.pop("seed"))
        x0, v0, counts, kw = column_problem(**c)
        x0, v0, counts = (torch.as_tensor(x, device=dev)
                          for x in (x0, v0, counts))
        torch.cuda.synchronize()
        t0 = time.time()
        _, _, it, _ = column_solve(x0, v0, counts, **kw)
        torch.cuda.synchronize()
        sec = time.time() - t0
        longest = int(it.cpu().numpy().max(axis=0).sum())
        out["column"][split] = dict(seconds=sec,
                                    us_per_iteration=1e6 * sec / longest)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
