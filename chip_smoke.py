#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port (``dmcf_tpu_torch``) only: builds its CUDA kernels from
the sources in this checkout, holds each kernel against its plain PyTorch
twin on the card, runs the WaterRamps SymNet (``configs/WaterRamps.yml``,
full width, random weights from a seeded ``torch.Generator``) on the bench
scene for one step and a 600-step rollout, checks the bench's exactness
gate and the kernels' launch counts, holds the kernel against its twin
again at every launch of the first step (and times each: the conv
inventory), checks a small-scene
agreement with the plain path on the CPU, profiles where a step's time
goes, and prints one ``kernels`` JSON line, the card's name and power
limit, and a last ``{"ok": true, ...}`` line.  A kernel's ``ms`` is the
mean of calls issued back to back (CUDA events around the loop), its
``device_ms`` the device time of one call by CUDA-graph replay; where the
kernel is shorter than the wrapper's host cost the first reads the host.
Every phase that fails
ends the script with a non-zero exit; without a CUDA device it exits
non-zero before doing anything.
"""

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HORIZON = 600
HBM_BYTES_PER_S = 3.35e12    # H100 SXM published peak
FP32_FLOP_PER_S = 67e12      # H100 SXM fp32 without tensor cores
TF32_FLOP_PER_S = 495e12     # H100 SXM TF32 tensor cores, dense
TOL = 2e-5                   # kernel vs plain twin, absolute (fp32 sums)


def phase(name):
    print(f"== {name}", flush=True)


def check(cond, what):
    """A failed check ends the run with a non-zero exit."""
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, iters=50, warmup=5):
    """Mean time of ``fn`` over ``iters`` calls issued back to back from
    Python (CUDA events): the host's call rate where the kernel is shorter
    than the call."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(idx, a, t, feats, w, ksize, qfeats):
    """Least time the card could take for one K-list conv: its inputs read
    once and its output written once over the HBM rate, or the operations
    this call's data needs over the rate of the unit the kernel does them
    on, whichever is larger.  The operations count only what is non-zero in
    this call: each non-zero tap times Cin accumulates (fp32, 67 TFLOP/s),
    and the filter product over the rows of T that some tap touched (a
    query with ~10 neighbours touches ~40 of its 64 taps; a padded query
    none): on the tensor cores with the 3xTF32 split (three TF32 products
    each, 495 / 3 = 165 TFLOP/s) for a non-symmetric conv, in fp32 for the
    symmetric one, whose self term adds the taps' sum times f_q on those
    rows.  Returns (ms, "bytes" or "operations", bytes, operations)."""
    from dmcf_tpu_torch.kernels.cconv_klist import _tap_tensor
    cin, cout = feats.shape[1], w.shape[1]
    nz = _tap_tensor(t, a, ksize) != 0          # [Q, K, S]
    nnz = int(nz.sum())
    rows = int(nz.any(dim=1).sum())             # non-zero rows T[q, s, :]
    ins = [x for x in (idx, a, t, feats, w, qfeats) if x is not None]
    nbytes = sum(x.numel() * x.element_size() for x in ins) \
        + idx.shape[0] * cout * 4
    accumulate = 2 * nnz * cin
    product = 2 * rows * cin * cout
    if qfeats is not None:
        accumulate += nnz + 2 * rows * cin
        ops_ms = (accumulate + product) / FP32_FLOP_PER_S * 1e3
    else:
        ops_ms = (accumulate / FP32_FLOP_PER_S
                  + product / (TF32_FLOP_PER_S / 3)) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops = accumulate + product
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes", nbytes, ops
    return ops_ms, "operations", nbytes, ops


def main(argv):
    steps = int(argv[argv.index("--steps") + 1]) if "--steps" in argv \
        else HORIZON
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA device", file=sys.stderr)
        return 2

    from dmcf_tpu_torch.kernels import build
    from dmcf_tpu_torch.kernels.cconv_klist import (cconv_klist,
                                                    cconv_klist_reference)
    from dmcf_tpu_torch.models import build_model
    from dmcf_tpu_torch.models.pbf import drop_coincident
    from dmcf_tpu_torch.ops import cconv, neighbors, windows
    from dmcf_tpu_torch.ops.sph import masked_positions
    from dmcf_tpu_torch.profile_step import (graph_ms, print_report, profile,
                                             record_launches)
    from dmcf_tpu_torch.rollout import rollout
    from dmcf_tpu_torch.scene import bench_sample, build_scene
    import yaml

    root = os.path.dirname(os.path.abspath(__file__))
    dev = torch.device("cuda")

    phase("1 device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 off")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")

    phase("2 kernel build")
    for name in build.sources():
        t0 = time.time()
        log = build.build(name)
        print(f"{name}: {'compiled' if log else 'already built'} in "
              f"{time.time() - t0:.1f} s")
        for line in log.splitlines():
            if "entry function" in line:  # the variant: <false> trunk,
                print(f"  {line.split(chr(39))[1]}")  # <true> symmetric
            if "registers" in line or "spill" in line:
                print(f"  {line.strip()}")
    lib = build.load_library("cconv_klist")
    for cin, cout, sym in ((32, 32, 0), (4, 8, 0), (32, 2, 1)):
        print(f"  dynamic shared memory, S 64 Cin {cin} Cout {cout} sym "
              f"{sym}: {lib.cconv_klist_smem_bytes(cin, cout, 1, 8, 8, sym)}"
              f" B a block")

    phase("3 kernel vs plain twin")
    with open(os.path.join(root, "configs", "WaterRamps.yml")) as f:
        cfg = yaml.safe_load(f)["model"]
    pos, box, nrm = build_scene()
    sample = bench_sample(pos, box, nrm, device=dev)
    # the main path's geometry: the bench scene's scale-0 all->all list
    all_pos = torch.cat([masked_positions(sample["pos"],
                                          sample["fluid_mask"]),
                         masked_positions(sample["box"],
                                          sample["box_mask"])])
    all_mask = torch.cat([sample["fluid_mask"], sample["box_mask"]])
    r0 = float(cfg["particle_radii"][0])
    k = int(cfg["neighbor_k"])
    nl = neighbors.search(all_pos, all_pos, r0, k, points_mask=all_mask,
                          queries_mask=all_mask)
    g = torch.Generator().manual_seed(1)
    q = all_pos.shape[0]
    ksize = tuple(cfg["kernel_size"])
    s_total = int(np.prod(ksize))
    shapes = {}
    # (a) widest trunk conv: Cin 32 -> Cout 32, poly6
    idx, a, t = cconv.klist_geometry(nl, 2 * r0, ksize,
                                     window_fn=windows.get_window_func(
                                         cfg["window"]))
    feats = torch.randn((q, 32), generator=g).to(dev)
    w = (torch.randn((s_total * 32, 32), generator=g) * 0.05).to(dev)
    shapes["trunk"] = (idx, a, t, feats, w, ksize, None)
    # (b) ASCC: symmetric, coincident dropped, peak, fp32, Cin 32 -> Cout 2
    nl_sym = drop_coincident(nl)
    ksize_s = tuple(cfg["sym_kernel_size"])
    idx_s, a_s, t_s = cconv.klist_geometry(
        nl_sym, 2 * r0, ksize_s,
        window_fn=windows.get_window_func(cfg["window_sym"]))
    half_shape = list(ksize_s) + [32, 2]
    half_shape[int(cfg["sym_axis"])] //= 2
    half = torch.randn(half_shape, generator=g).to(dev) * 0.05
    w_s = cconv.build_symmetric_kernel(half, int(cfg["sym_axis"]))
    f_s = torch.where(all_mask[:, None], torch.rand((q, 32), generator=g)
                      .to(dev), 0.0)
    shapes["ascc"] = (idx_s, a_s, t_s, f_s, w_s.reshape(-1, 2).contiguous(),
                      ksize_s, f_s)
    max_err = 0.0
    for name, (i_, a_, t_, f_, w_, ks_, qf_) in shapes.items():
        got = cconv_klist(i_, a_, t_, f_, w_, ks_, qfeats=qf_)
        again = cconv_klist(i_, a_, t_, f_, w_, ks_, qfeats=qf_)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"{name}: two launches bitwise equal")
        ref = cconv_klist_reference(i_, a_, t_, f_, w_, ks_, qfeats=qf_)
        err = float((got - ref).abs().max())
        ratio = float((got.sum(0).abs() / got.abs().sum()).max())
        print(f"{name}: Q {q} K {k} Cin {f_.shape[1]} Cout {w_.shape[1]} "
              f"max_abs_err {err:.3e} (tol {TOL}) momentum_ratio "
              f"{ratio:.3e}")
        check(bool(torch.isfinite(got).all()), f"{name}: finite output")
        check(err <= TOL, f"{name}: kernel vs twin {err} <= {TOL}")
        if name == "ascc":
            check(ratio < 1e-5, f"ASCC momentum ratio {ratio} < 1e-5")
        max_err = max(max_err, err)
    i_, a_, t_, f_, w_, _, _ = shapes["trunk"]
    kernel_ms = cuda_ms(lambda: cconv_klist(i_, a_, t_, f_, w_, ksize))
    device_ms = graph_ms(lambda: cconv_klist(i_, a_, t_, f_, w_, ksize))
    plain_ms = cuda_ms(lambda: cconv_klist_reference(i_, a_, t_, f_, w_,
                                                     ksize))
    bound_ms, bound_by, nbytes, ops = bound(i_, a_, t_, f_, w_, ksize, None)
    print(f"trunk shape: kernel {kernel_ms:.4f} ms (device time "
          f"{device_ms:.4f}), plain twin {plain_ms:.4f} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by}: {nbytes} B, {ops} FLOP), share "
          f"of bound {bound_ms / kernel_ms:.3f} (of device time "
          f"{bound_ms / device_ms:.3f})")

    phase("4 one WaterRamps SymNet step")
    model = build_model(cfg, device=dev,
                        generator=torch.Generator().manual_seed(0))
    cconv_klist.launches = 0   # main path starts here
    t0 = time.time()
    # keeps each kernel launch of this step (its conv's module name, inputs
    # and output) for phase 6
    (p1, v1, aux), launch_log = record_launches(model, sample)
    torch.cuda.synchronize()
    fm = sample["fluid_mask"]
    check(p1.shape == sample["pos"].shape, "step output shape")
    check(bool(torch.isfinite(p1[fm]).all() and torch.isfinite(v1[fm]).all()),
          "finite step output")
    step_launches = cconv_klist.launches
    print(f"first step {1e3 * (time.time() - t0):.1f} ms, kernel launches "
          f"{step_launches}, neighbor_overflow "
          f"{int(aux['neighbor_overflow'])}, pair_overflow "
          f"{int(aux['pair_overflow'])}, scale_counts "
          f"{aux['scale_counts'].tolist()} caps "
          f"{aux['scale_caps'].tolist()}")
    check(step_launches == 19 == len(launch_log),
          f"{step_launches} kernel launches per step")

    phase(f"5 rollout ({steps} steps)")
    torch.cuda.synchronize()
    t0 = time.time()
    pos, vel, gate = rollout(model, sample, steps)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = cconv_klist.launches   # main path ends here
    finite = bool(torch.isfinite(pos[fm]).all())
    print(f"steps {steps}, {1e3 * dt / steps:.3f} ms/step "
          f"({steps / dt:.2f} steps/s), finite {finite}, gate {gate}")
    check(finite, "finite rollout")
    check(gate["exact"], f"exactness gate {gate}")
    expected = 19 * (1 + steps)
    check(launches == expected, f"{launches} launches == {expected}")

    phase("6 kernel vs plain twin at each launch of the first step")
    step_ms = step_device_ms = step_plain_ms = step_bound_ms = 0.0
    with torch.no_grad():
        for name, args, kw, out in launch_log:
            ref = cconv_klist_reference(*args, **kw)
            err = float((out - ref).abs().max())
            check(bool(torch.isfinite(out).all()), f"{name}: finite output")
            check(err <= TOL, f"{name}: kernel vs twin {err} <= {TOL}")
            max_err = max(max_err, err)
            ms = cuda_ms(lambda: cconv_klist(*args, **kw), iters=20)
            d_ms = graph_ms(lambda: cconv_klist(*args, **kw))
            p_ms = cuda_ms(lambda: cconv_klist_reference(*args, **kw),
                           iters=20)
            b_ms, b_by, _, _ = bound(*args, kw["qfeats"])
            step_ms += ms
            step_device_ms += d_ms
            step_plain_ms += p_ms
            step_bound_ms += b_ms
            idx_, _, _, f_, w_, ks_ = args
            print(f"{name:11s} Q {idx_.shape[0]:4d} K {idx_.shape[1]} "
                  f"N {f_.shape[0]:4d} Cin {f_.shape[1]:2d} "
                  f"Cout {w_.shape[1]:2d} S {int(np.prod(ks_))} "
                  f"sym {kw['qfeats'] is not None:d}: kernel {ms:.4f} ms "
                  f"(device time {d_ms:.4f}), plain twin {p_ms:.4f} ms, "
                  f"bound {b_ms:.5f} ms ({b_by}), max_abs_err {err:.3e}")
    print(f"per step ({len(launch_log)} launches): kernel {step_ms:.4f} ms "
          f"(device time {step_device_ms:.4f}), plain twin "
          f"{step_plain_ms:.4f} ms, bound {step_bound_ms:.5f} ms, share of "
          f"bound {step_bound_ms / step_ms:.3f} (of device time "
          f"{step_bound_ms / step_device_ms:.3f})")

    phase("7 small scene: card vs plain path on the CPU")
    small = build_scene(256)
    s_gpu = bench_sample(*small, device=dev)
    s_cpu = bench_sample(*small, device="cpu")
    cpu_model = copy.deepcopy(model).to("cpu")
    with torch.no_grad():
        pg, vg, ag = model(s_gpu)
        pc, vc, ac = cpu_model(s_cpu)
    pcg = ag["pos_correction"].cpu()
    pcc = ac["pos_correction"]
    scale = float(pcc.abs().max())
    diff = float((pcg - pcc).abs().max())
    print(f"pos_correction max {scale:.3e}, card vs CPU max diff "
          f"{diff:.3e}; positions max diff "
          f"{float((pg.cpu() - pc).abs().max()):.3e}")
    check(scale > 0 and diff <= 1e-4 * scale,
          f"card vs CPU pos_correction {diff} <= 1e-4 * {scale}")
    check(torch.allclose(pg.cpu(), pc, atol=1e-6, rtol=0),
          "card vs CPU positions within 1e-6")

    phase("8 where a step's time goes")
    print_report(profile(steps=10), top=12)

    kernels = [{
        "name": "cconv_klist",
        "route": "cuda",
        "source": "dmcf_tpu_torch/csrc/cconv_klist.cu",
        "replaces": "dmcf_tpu/experimental/pallas_cconv.py:136 "
                    "(pallas_continuous_conv)",
        "launches": launches,
        "launches_per_step": step_launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "device_ms": device_ms,
        "step_ms": step_ms,
        "step_device_ms": step_device_ms,
        "step_plain_ms": step_plain_ms,
        "step_bound_ms": step_bound_ms,
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
