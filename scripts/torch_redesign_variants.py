"""Layouts and parts of the column solver and the K-list filter- and
data-gradient kernels, timed on one card.

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
  data    at the WaterRamps trunk shape and the momentum model's K 48
          (also with 80 sources: long runs a feats row), and K 256 shapes,
          both variants, device time of the whole launch (the transposed
          list included): as it is, with other block and in-flight
          counts (``kDBlocks``, ``kDKB``), one channel a load in the slot
          walk (``scalar``), the short runs sorted by the long runs'
          bitonic network (``bitonic``: same outputs), and without the dT
          product (``no_product``), the sort of a row's slots
          (``no_sort``: the run summed unsorted), the slot walk's dA, da
          and dt (``no_walk``: the slots still filed into the list, so the
          source side reads only ids the launch wrote) or the dfeats sum
          (``no_dfeats``); each part cut gives wrong outputs, its time
          only, and takes no address from memory the launch did not
          write; and the transposed list made by PyTorch ops instead (the
          plain ``transposed_slots``) whole and by part: the key (clamp,
          mask), the stable sort of int32 keys and of int16 ones, the
          offsets (``searchsorted``)

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
    "no_T": [("    klist::build_T<kMode, kTaps, kBF16>(p, T, p.LD, taps, "
              "tmask, q0, s0,\n                                        nr, "
              "clo, cw);", "")],
}

DATA = {"as_is": []}
for const, base, alts in (("kDBlocks", 264, (132, 528)),):
    for v in alts:
        DATA[f"{const}{v}"] = [(f"constexpr int {const} = {base};",
                                f"constexpr int {const} = {v};")]
DATA["no_product"] = [("    if (!on) continue;  // uniform across the warp",
                       "    if (true) continue;")]
DATA["scalar"] = [("  p.vec4 = (Cin & 3) == 0 &&", "  p.vec4 = 0 &&")]
_FR = "    const size_t fr = static_cast<size_t>(row) * p.Cin;"
DATA["no_walk"] = [(_FR, "    if (true) return;\n" + _FR)]
DATA["no_dfeats"] = [("  if (r >= p.N) return;", "  if (true) return;")]
DATA["kDKB1"] = [("constexpr int kDKB = 4;", "constexpr int kDKB = 1;")]
DATA["no_sort"] = [("    rank_sort(sb, sorted, len);",
                     "    for (int i = lane; i < len; i += 32) "
                     "sorted[i] = sb[i];")]
DATA["bitonic"] = [("    rank_sort(sb, sorted, len);",
                    "    warp_sort(sb, len);\n"
                    "    for (int i = lane; i < len; i += 32) "
                    "sorted[i] = sb[i];")]


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
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 \
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
                             cout, *ks, half, 0,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"filter {name}: error {err}")
                row[name] = graph_ms(call)
            out[f"{shape}_{'bf16' if half else 'fp32'}"] = row
            print(f"filter {shape} {'bf16' if half else 'fp32'}: " + ", ".join(
                f"{k_} {v:.4f}" for k_, v in row.items()), flush=True)
    return out


def pair_inputs(q, n, k, cin, cout, seed, device):
    """A downsampling pair of the momentum model: Q queries and N sources,
    apart, in a square, the radius sized to ~0.8 K sources a query,
    kernel [1, 8, 8], poly6 window (so each source row has ~Q K / N
    slots)."""
    from dmcf_tpu_torch.ops import cconv, neighbors, windows

    g = torch.Generator().manual_seed(seed)
    side = 0.1
    src = torch.rand((n, 3), generator=g) * side
    qry = torch.rand((q, 3), generator=g) * side
    src[:, 2] = qry[:, 2] = 0.0
    radius = side * (0.8 * k / (n * np.pi)) ** 0.5
    nl = neighbors.search(src, qry, radius, k)
    idx, a, t = cconv.klist_geometry(nl, 2 * radius, (1, 8, 8),
                                     window_fn=windows.get_window_func(
                                         "poly6"))
    feats = torch.randn((n, cin), generator=g)
    w = torch.randn((64 * cin, cout), generator=g) * 0.1
    return [x.to(device) for x in (idx, a, t, feats, w)], (1, 8, 8)


def data_variants(root, dev):
    import chip_smoke
    import yaml
    from dmcf_tpu_torch.kernels.cconv_klist import data_workspace_bytes
    from dmcf_tpu_torch.profile_step import graph_ms
    from dmcf_tpu_torch.scene import bench_sample, build_scene
    from scripts.torch_redesign_ab import long_list_inputs

    with open(os.path.join(root, "configs", "WaterRamps.yml")) as f:
        cfg = yaml.safe_load(f)["model"]
    sample = bench_sample(*build_scene(), device=dev)
    i_, a_, t_, f_, w_, ks_, _ = chip_smoke.waterramps_shapes(
        cfg, sample, dev)["trunk"]
    shapes = {"trunk": ([i_, a_, t_, f_, w_], ks_),
              "K48": long_list_inputs(320, 320, 48, 32, 32, 80, dev),
              "K48_N80": pair_inputs(320, 80, 48, 4, 32, 81, dev),
              "K256": long_list_inputs(80, 320, 256, 24, 4, 280, dev)}
    libs = {}
    for name, subs in DATA.items():
        fn = build_variant("cconv_klist_bwd.cu", f"data_{name}",
                           subs).cconv_klist_bwd_data_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p]
        libs[name] = fn
    out = {}
    for shape, (xs, ks) in shapes.items():
        idx, a, t, feats, w = xs
        q, k = idx.shape
        n, cin = feats.shape
        cout = w.shape[1]
        dout = torch.randn((q, cout), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(0))
        outs = [torch.empty(q * k, dtype=torch.int32, device=dev),
                torch.empty(n + 1, dtype=torch.int32, device=dev),
                torch.empty((n, cin), device=dev), torch.empty_like(a),
                torch.empty_like(t)]
        for half in (0, 1):
            fe, we = (feats.bfloat16(), w.bfloat16()) if half else (feats, w)
            work = torch.empty(data_workspace_bytes(q, k, n, cin, cout, *ks,
                                                    half),
                               dtype=torch.uint8, device=dev)
            row = {}
            for name, fn in libs.items():
                def call(fn=fn):
                    err = fn(idx.data_ptr(), a.data_ptr(), t.data_ptr(),
                             fe.data_ptr(), None, we.data_ptr(),
                             dout.data_ptr(), outs[0].data_ptr(),
                             outs[1].data_ptr(), work.data_ptr(),
                             outs[2].data_ptr(), None, outs[3].data_ptr(),
                             outs[4].data_ptr(), q, k, n, cin, cout, *ks,
                             half, 0,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"data {name}: error {err}")
                row[name] = graph_ms(call)
            out[f"{shape}_{'bf16' if half else 'fp32'}"] = row
            print(f"data {shape} {'bf16' if half else 'fp32'}: " + ", ".join(
                f"{k_} {v:.4f}" for k_, v in row.items()), flush=True)
    return out


def prep_variants(root, dev):
    import chip_smoke
    import yaml
    from dmcf_tpu_torch.kernels.cconv_klist import transposed_slots
    from dmcf_tpu_torch.profile_step import graph_ms
    from dmcf_tpu_torch.scene import bench_sample, build_scene
    from scripts.torch_redesign_ab import long_list_inputs

    with open(os.path.join(root, "configs", "WaterRamps.yml")) as f:
        cfg = yaml.safe_load(f)["model"]
    sample = bench_sample(*build_scene(), device=dev)
    i_, a_, *_ = chip_smoke.waterramps_shapes(cfg, sample, dev)["trunk"]
    shapes = {"trunk": (i_, a_, i_.shape[0]),
              "K256": long_list_inputs(80, 320, 256, 24, 4, 280, dev)[0][:2]
              + [320]}
    out = {}
    for shape, (idx, a, n) in shapes.items():
        key = idx.clamp(0, n - 1).masked_fill_(a == 0, n).reshape(-1)
        rows = torch.sort(key, stable=True)[0]
        ar = torch.arange(n + 1, dtype=rows.dtype, device=dev)
        k16 = key.to(torch.int16)
        row = {"whole": graph_ms(lambda: transposed_slots(idx, a, n)),
               "key": graph_ms(lambda: idx.clamp(0, n - 1).masked_fill_(
                   a == 0, n)),
               "sort_int32": graph_ms(lambda: torch.sort(key, stable=True)),
               "sort_int16": graph_ms(lambda: torch.sort(k16, stable=True)),
               "offsets": graph_ms(lambda: torch.searchsorted(
                   rows, ar, out_int32=True))}
        out[shape] = row
        print(f"prep {shape} ({key.numel()} slots): " + ", ".join(
            f"{k_} {v:.4f}" for k_, v in row.items()), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--splits", default="train")
    ap.add_argument("--skip", default="", help="column,filter,data,prep")
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
    if "data" not in args.skip:
        out["data"] = data_variants(root, dev)
    if "prep" not in args.skip:
        out["prep"] = prep_variants(root, dev)
    if "filter" not in args.skip:
        out["filter"] = filter_variants(root, dev)
    if "column" not in args.skip:
        out["column"] = column_variants(root, args.splits.split(","), dev)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
