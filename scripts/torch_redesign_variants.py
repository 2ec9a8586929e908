"""Layouts and parts of the column solver and the K-list filter-gradient
kernel, timed on one card.

    python -m scripts.torch_redesign_variants [--splits train]

A diagnostic of ``dmcf_tpu_torch/csrc/column_sph.cu`` and of the filter
kernel in ``csrc/cconv_klist_bwd.cu``, outside the package.  Builds each
source as it is and with a constant changed or a part cut out (by text
substitution, into ``dmcf_tpu_torch/_build/variants/<variant>/``; a
substitution whose text is not in the source stops the run) and times:

  column  each lane layout (``kRowLanes``: lanes a particle row) on the
          splits of ``configs/column/symnet.yml``: seconds, microseconds
          an iteration of the longest scene, and whether its outputs are
          bitwise those of the source as it is; without the projection's
          pair counts (``no_count``: its ``pairs`` wrong), and with every
          division a division (``no_pow2``: no product by the exact
          inverse of a power-of-two divisor)
  filter  at the WaterRamps trunk shape and the momentum model's K 256
          shape, both variants, device time a call (CUDA-graph replay):
          the kernel as it is, with other group and accumulator counts
          (``kFBlocks``, ``kFP``), without the second launch (``no_sum``:
          wrong dW, its time only), without the product (``no_product``)
          and without the T build (``no_T``), and with the header's
          ``mma.sync`` not volatile (``mma_asm``)

Needs a CUDA device and nvcc; imports only the port.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

COLUMN = {f"lanes{n}": [("constexpr int kRowLanes = 16;",
                         f"constexpr int kRowLanes = {n};")]
          for n in (16, 32, 8)}
COLUMN["no_count"] = [("density<kLanes>(x[r], xj, g, n, c, valid[r], cnt[2],",
                       "density<kLanes>(x[r], xj, g, n, c, false, cnt[2],")]
COLUMN["no_pow2"] = [("pow2_inv(mass), pow2_inv(rest)", "0.f, 0.f")]
FILTER = {
    "as_is": [],
    "blocks66": [("constexpr int kFBlocks = 132;",
                  "constexpr int kFBlocks = 66;")],
    "blocks264": [("constexpr int kFBlocks = 132;",
                   "constexpr int kFBlocks = 264;")],
    "acc8": [("constexpr int kFP = 16;", "constexpr int kFP = 8;")],
    "no_sum": [("  cconv_klist_bwd_filter_sum_kernel<<<blocks, 128, 0, st>>>"
                "(work, dw, p.G,\n", "  if (0) cconv_klist_bwd_filter_sum_"
                "kernel<<<blocks, 128, 0, st>>>(work, dw, p.G,\n")],
    "no_product": [("    if (!on) {\n", "    if (true) {\n")],
    "mma_asm": [("  asm volatile(\n      \"mma.sync.aligned.m16n8k8",
                 "  asm(\n      \"mma.sync.aligned.m16n8k8")],
    "no_T": [("    klist::build_T<kTaps, kBF16>(p, T, p.LD, taps, tmask, q0, "
              "s0, nr, clo,\n                                 cw);", "")],
}


def build_variant(src_name, name, subs):
    """Builds ``csrc/<src_name>`` with each (old, new) substitution made
    in the source or in a header beside it (the variant's copy of the
    header is found first)."""
    from dmcf_tpu_torch.kernels import build

    files = [src_name] + sorted(h.name for h in build.CSRC.glob("*.cuh"))
    texts = {f: (build.CSRC / f).read_text() for f in files}
    for old, new in subs:
        where = [f for f in files if old in texts[f]]
        if not where:
            raise RuntimeError(f"{name}: {old!r} not in {files}")
        texts[where[0]] = texts[where[0]].replace(old, new)
    out = build.BUILD_DIR / "variants" / name
    out.mkdir(parents=True, exist_ok=True)
    for f, text in texts.items():
        (out / f).write_text(text)
    so = out / f"{name}.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                           str(out / src_name)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    return ctypes.CDLL(str(so))


def column_variants(root, splits, dev):
    import chip_smoke
    from dmcf_tpu_torch.data.generators import column_problem
    from dmcf_tpu_torch.kernels.column_sph import constants

    ds = chip_smoke.column_config(root)["dataset"]
    libs = {}
    for name, subs in COLUMN.items():
        fn = build_variant("column_sph.cu", name, subs).column_sph_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
            + [ctypes.c_float] * 10 + [ctypes.c_void_p]
        libs[name] = fn
    out = {}
    for split in splits:
        c = chip_smoke.column_split(ds, split)
        np.random.seed(c.pop("seed"))
        x0, v0, counts, kw = column_problem(**c)
        x0, v0, counts = (torch.as_tensor(x, device=dev)
                          for x in (x0, v0, counts))
        n_s, p = x0.shape
        k = constants(kw.get("mass", 1.0), kw["gravity"],
                      kw["rest_dens"], kw.get("stiffness", 20.0),
                      kw.get("visc", 0.1), kw.get("h", 1.0), kw["dt"],
                      kw.get("eps", 0.01))
        first = None
        for name, fn in libs.items():
            res = [torch.empty((n_s, kw["timesteps"], p), device=dev),
                   torch.empty((n_s, kw["timesteps"], p), device=dev),
                   torch.empty((n_s, kw["timesteps"]), dtype=torch.int32,
                               device=dev),
                   torch.empty((n_s, kw["timesteps"], 4), dtype=torch.int32,
                               device=dev)]
            torch.cuda.synchronize()
            t0 = time.time()
            err = fn(x0.data_ptr(), v0.data_ptr(), counts.data_ptr(),
                     *(r.data_ptr() for r in res), n_s, p, kw["timesteps"],
                     kw["bcnt"], kw.get("max_iter", 10000),
                     *(float(k[key]) for key in (
                         "mass", "gravity", "rest", "stiff", "visc", "cw",
                         "soft", "dt", "dt2", "eps")),
                     torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            sec = time.time() - t0
            if err:
                raise RuntimeError(f"column {name}: CUDA error {err}")
            first = first or res
            same = all(torch.equal(a, b) for a, b in zip(res, first))
            longest = int(res[2].cpu().numpy().max(axis=0).sum())
            out[f"{split}_{name}"] = dict(
                seconds=sec, us_per_iteration=1e6 * sec / longest,
                bitwise_as_first=same)
            print(f"column {split} {name}: {sec:.3f} s, "
                  f"{1e6 * sec / longest:.3f} us an iteration, bitwise "
                  f"equal to {next(iter(libs))}: {same}", flush=True)
    return out


def filter_variants(root, dev):
    import chip_smoke
    import yaml
    from dmcf_tpu_torch.profile_step import graph_ms
    from dmcf_tpu_torch.scene import bench_sample, build_scene
    from scripts.torch_redesign_ab import long_list_inputs

    with open(os.path.join(root, "configs", "WaterRamps.yml")) as f:
        cfg = yaml.safe_load(f)["model"]
    sample = bench_sample(*build_scene(), device=dev)
    i_, a_, t_, f_, w_, ks_, _ = chip_smoke.waterramps_shapes(
        cfg, sample, dev)["trunk"]
    shapes = {"trunk": ([i_, a_, t_, f_, w_], ks_),
              "K256": long_list_inputs(80, 320, 256, 24, 4, 280, dev)}
    libs = {}
    for name, subs in FILTER.items():
        lib = build_variant("cconv_klist_bwd.cu", name, subs)
        fn = lib.cconv_klist_bwd_filter_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        ws = lib.cconv_klist_bwd_filter_workspace
        ws.restype = ctypes.c_longlong
        ws.argtypes = [ctypes.c_int] * 8
        libs[name] = (fn, ws)
    out = {}
    for shape, (xs, ks) in shapes.items():
        idx, a, t, feats, w = xs
        q, k = idx.shape
        n, cin = feats.shape
        cout = w.shape[1]
        dout = torch.randn((q, cout), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(0))
        for half in (0, 1):
            fe = feats.bfloat16() if half else feats
            dw = torch.empty(w.shape, device=dev)
            row = {}
            for name, (fn, ws) in libs.items():
                nwork = int(ws(q, k, n, cin, cout, *ks))
                work = torch.empty(max(nwork, 1), device=dev)

                def call(fn=fn, work=work):
                    err = fn(idx.data_ptr(), a.data_ptr(), t.data_ptr(),
                             fe.data_ptr(), None, dout.data_ptr(),
                             dw.data_ptr(), work.data_ptr(), q, k, n, cin,
                             cout, *ks, half,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"filter {name}: error {err}")
                row[name] = graph_ms(call)
            out[f"{shape}_{'bf16' if half else 'fp32'}"] = row
            print(f"filter {shape} {'bf16' if half else 'fp32'}: " + ", ".join(
                f"{k_} {v:.4f}" for k_, v in row.items()), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--splits", default="train")
    ap.add_argument("--skip", default="", help="column,filter")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_redesign_variants needs a CUDA device")
    root = os.getcwd()
    sys.path.insert(0, root)
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    out = {}
    if "filter" not in args.skip:
        out["filter"] = filter_variants(root, dev)
    if "column" not in args.skip:
        out["column"] = column_variants(root, args.splits.split(","), dev)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
