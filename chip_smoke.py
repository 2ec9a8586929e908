#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port (``dmcf_tpu_torch``) only: builds its CUDA kernels from
the sources in this checkout, holds each kernel variant (fp32 and bf16)
against its plain PyTorch twin on the card (the farthest-point kernel,
``csrc/fps.cu``, under every schedule ``kernels.fps.schedule`` chooses and
every rows-a-thread count it is built for, bit for bit: phase 3b), runs the WaterRamps SymNet
(``configs/WaterRamps.yml`` at its own precision, a bf16 trunk: full
width, random weights from a seeded ``torch.Generator``) on the bench
scene for one step and the bench's timed 600-step rollout
(``dmcf_tpu_torch.bench.timed_rollout``), checks the bench's exactness
gate, the ASCC output's momentum ratio and each variant's launch counts,
holds each kernel against its twin again at every launch of the first
step of the bf16-trunk model and of the fp32 one (and times each: the
conv inventory), checks a small-scene agreement with the plain path on the
CPU (one-step bf16 flips of T counted apart), profiles where a step's time
goes, runs the valid pipeline of
``configs/other/momentum.yml`` (phase 9: ``Simulator.run_valid`` with the
full metric suite, each variant's launches on that path counted exactly,
card against CPU, momentum drift), holds the backward kernels of both
variants against the plain backward at every launch shape of a momentum
train step and at the WaterRamps trunk shape, each kernel's two
launches bitwise equal at each (phase 10), trains the
momentum config on the card through ``run_pipeline --split train`` with
every kernel variant's launches counted exactly and its first two steps
held against the CPU path (phase 11), runs one WaterRamps train step at
batch 16, window 3 (phase 12), runs the fp32 path (precision "highest": a
100-step rollout and momentum train steps, phase 13), holds the column
solver kernel (``csrc/column_sph.cu``) against its plain version and the
JAX package's fixture and generates the column splits at full size (phase
14), trains and validates the column configs through ``run_pipeline``
with data from that kernel (phase 15), runs ``configs/Liquid3d.yml`` at
full width (K-list launches up to K 1856 in chunks, the 6x6x6 ASCC conv,
a 50-step rollout, a batch-8 train step; phase 16), ``configs/WBC-SPH.yml``
upright and turned by 30 degrees (``grav_eqvar``, phase 17) and the
CConv and PointNet baselines (phase 18), runs the root bench's canyon
protocol on a generated scene of the canyon's size (``bench.bench_canyon``
with the cell search, the contact crop, every K-list launch of its first
step held against its plain version, the searches against each other and
the CPU, and lazy dense pairs against eager ones; phase 19) and
``run_sample``'s inflow regime (phase 20), runs the model options on two
paths (phase 21: WaterRamps' SymNet with the farthest-point pyramid, on
the hand-written ``csrc/fps.cu``, density and pressure features,
``dens_norm`` and the pre-advection branch; phase 22:
``column/hrnet.yml`` with the farthest-point pyramid, the equivariant
output, circular kernels, an extra per-scale conv and transposed
searches: each FPS launch of the first steps bitwise against its plain
version, each inverted list against a search, a 100-step rollout under
the gate, card vs CPU, a train step), loads a checkpoint in the
reference's TensorFlow format without TensorFlow into Liquid3d's SymNet,
reads a dataset file through the native scene loader (no Python
``zstandard``), runs ``run_sample`` on it with those weights and checks
the TensorBoard events file phase 11 wrote (phase 23), runs the K-list
kernels' other interpolation modes (phase 24: WaterRamps' SymNet with
``interpolation: nearest_neighbor`` at full width, every launch of its
first step against its plain version with both backward kernels at each
shape, a 100-step rollout under the gate with the ASCC ratio and the
exact-tie pairs that break it, card vs CPU and train steps; Liquid3d with
``linear_border``, 20 steps; every mode's kernels past the span's ends and
on ties; ``SparseConv``, ``SparseConvTranspose`` and ``PointSampling``
card vs CPU), runs the multi-rank paths of ``dmcf_tpu_torch/parallel``
over ``torch.distributed``, one spawned process a rank (phase 25: (a) an
NCCL world of one rank, the momentum train step data-parallel with its
parameters bit for bit the one-process step's and a one-slab halo step
against the plain step; (b) two gloo ranks sharing the card, their halo
exchange through pinned host buffers: ``configs/Liquid3d.yml`` at full
width on 13,200 fluid in its full open box, no crop, the halo code's
parked rows kept out of the cell tables of the grid and cell searches,
the halo rollout at "highest" against one process with the voxel-count
witness, a timed halo rollout of the config as shipped (bf16 trunk, the
cell search, its K budgets and pyramid caps) with its overflows beside
one process's, every K-list launch of each rank's first steps against
its plain version, and the data-parallel train step with one item a rank
against one process; no scale-out is measured on one card), runs the
particle-sharded step of ``parallel/spatial.py`` (phase 26: (a) an NCCL
world of one rank, WaterRamps' SymNet bit for bit the one-process step;
(b) two gloo ranks on the card, each searching and convolving its own
query rows: every K-list launch of each rank's first step against its
plain version, a 20-step rollout under the gate, a step at "highest"
against one process; (c) path B with the farthest-point pyramid and
``configs/Liquid3d.yml`` as shipped, a step each against one process),
and prints
one ``kernels`` JSON line (each kernel variant, its launches on each path),
the card's name and power limit, and a last ``{"ok": true, ...}`` line.  A
kernel's ``ms`` is the mean of calls issued back to back (CUDA events
around the loop), its ``device_ms`` the device time of one call by
CUDA-graph replay; where the kernel is shorter than the wrapper's host
cost the first reads the host.  Every phase that fails ends the script
with a non-zero exit; without a CUDA device it exits non-zero before doing
anything.
"""

import copy
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HORIZON = 600
FP32_STEPS = 100             # the fp32 (precision "highest") rollout
HBM_BYTES_PER_S = 3.35e12    # H100 SXM published peak
FP32_FLOP_PER_S = 67e12      # H100 SXM fp32 without tensor cores
TF32_FLOP_PER_S = 495e12     # H100 SXM TF32 tensor cores, dense
BF16_FLOP_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
TOL = 2e-5                   # kernel vs plain twin, absolute (fp32 sums)
BF16_TOL = 1e-4              # bf16 forward vs its twin, relative to max
#   |out|: sums taken in another order before T's bf16 rounding can move an
#   element of T by one bf16 step
BF16_BWD_TOL = 2e-3          # bf16 backward kernels vs the plain backward,
#   relative to each gradient's max; dfeats and dW (rounded to bf16 last)
#   apart from elements exactly one bf16 step apart: sums taken in other
#   orders meet a rounding midpoint for ~1e-4 of the elements, so at most
#   max(4, 1e-3 of them)
BF16_GRAD_TOL = 2e-2         # bf16 train-step gradients, card vs CPU
VALID_FRAMES = 5             # frames of phase 9's card-vs-CPU comparison
BWD_TOL = 1e-5               # backward kernels vs plain backward, relative
#   to each gradient's max abs (sums over slots and queries in another order,
#   float atomics)
GRAD_TOL = 1e-4              # train-step gradients, card vs CPU, relative to
#   each tensor's max abs (fp32 through a 3-step window of 18 convs)
TRAIN_ITERS = 10             # phase 11's run_train iterations
# momentum drift |sum v_T - sum v_0| / sum |v_0| of a momentum rollout: the
# velocity is a position difference over dt, so each step rounds each
# particle's velocity by up to ~ulp(|x| ~ 0.25) / dt = 1.2e-5; once the
# corrections make those roundings independent, 202 particles over 39
# steps walk to ~2e-5 of sum |v_0| ~ 54 whatever the ASCC sums to (the
# CPU gives 2.2e-5 with the data scaled by 0.9).  Five times that:
DRIFT_BOUND = 1e-4


_START = time.time()


def phase(name):
    print(f"== {name} (at {time.time() - _START:.1f} s)", flush=True)


def part(name):
    """A phase's part, with the time since the start."""
    print(f" {name} (at {time.time() - _START:.1f} s)", flush=True)


def bf16(kw):
    """Whether a logged K-list call (its kwargs) ran the bf16 variant."""
    from dmcf_tpu_torch.kernels.cconv_klist import is_bf16
    return is_bf16(kw.get("precision", "highest"))


def kernel_args(args, kw):
    """A logged call's contract inputs as its kernel takes them: feats and
    w converted to bf16 for the bf16 variant (the conversion the wrapper
    does a conv is then not timed with the kernel)."""
    if not bf16(kw):
        return args
    idx, a, t, feats, w, ks = args
    return idx, a, t, feats.bfloat16(), w.bfloat16(), ks


def fwd_check(name, out, ref, kw):
    """One forward launch against its plain twin: fp32 within TOL
    absolute, bf16 within BF16_TOL of max |ref|.  Returns the error."""
    err = float((out - ref).abs().max())
    tol = BF16_TOL * float(ref.abs().max()) if bf16(kw) else TOL
    check(bool(torch.isfinite(out).all()), f"{name}: finite output")
    check(err <= tol, f"{name}: kernel vs twin {err} <= {tol}")
    return err


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


def bound(idx, a, t, feats, w, ksize, qfeats, precision="highest",
          interpolation="linear"):
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
    rows; the bf16 variant reads feats and w as bf16 (2 bytes) and does the
    product on the bf16 tensor cores (989 TFLOP/s).  Returns (ms, "bytes"
    or "operations", bytes, operations)."""
    from dmcf_tpu_torch.kernels.cconv_klist import _tap_tensor, is_bf16
    half = is_bf16(precision)
    cin, cout = feats.shape[1], w.shape[1]
    nz = _tap_tensor(t, a, ksize, interpolation) != 0          # [Q, K, S]
    nnz = int(nz.sum())
    rows = int(nz.any(dim=1).sum())             # non-zero rows T[q, s, :]
    ins = [x for x in (idx, a, t, qfeats) if x is not None]
    nbytes = sum(x.numel() * x.element_size() for x in ins) \
        + (feats.numel() + w.numel()) * (2 if half else 4) \
        + idx.shape[0] * cout * 4
    accumulate = 2 * nnz * cin
    product = 2 * rows * cin * cout
    if qfeats is not None:
        accumulate += nnz + 2 * rows * cin
        ops_ms = (accumulate + product) / FP32_FLOP_PER_S * 1e3
    else:
        ops_ms = (accumulate / FP32_FLOP_PER_S + product / (
            BF16_FLOP_PER_S if half else TF32_FLOP_PER_S / 3)) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops = accumulate + product
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes", nbytes, ops
    return ops_ms, "operations", nbytes, ops


BWD_NAMES = ("dfeats", "dqfeats", "dw", "da", "dt")


def bwd_bound(which, dout, idx, a, t, feats, w, ksize, qfeats,
              precision="highest", interpolation="linear"):
    """Least time the card could take for one backward kernel, as
    ``bound`` for the forward: bytes over the HBM rate, or operations over
    the rate of the unit the kernel does them on.  data: reads idx, a, t,
    feats, w, qfeats, dout, writes dfeats, dqfeats, da, dt; computes dT on
    the (query, tap row) pairs some slot's hats touch (2 Cin Cout each),
    the dA dot product on every touched tap (2 Cin: da needs it for a
    padded slot too) and the dg update only on the taps of slots with a !=
    0 (2 Cin: a padded slot's dg is 0 and is not summed).  filter:
    reads the same but w, writes dW; rebuilds T over the non-zero taps (2
    Cin each) and multiplies it by dout over the touched rows (2 Cin Cout
    each).  Both kernels do their product (dT, T^T dout) on the tensor
    cores: the fp32 variant (and the symmetric form) as three TF32
    products (3xTF32, 495 / 3 = 165 TFLOP/s), the bf16 variant as two (W
    or T exact in TF32 against dout split big + small, 495 / 2); the rest
    at the fp32 rate (67 TFLOP/s).  The bf16 variants read feats and w as
    bf16 and write dfeats and dW in fp32.  Returns (ms, by)."""
    from dmcf_tpu_torch.kernels.cconv_klist import _tap_tensor, is_bf16
    cin, cout = feats.shape[1], w.shape[1]
    half = 2 if is_bf16(precision) else 4
    mma_rate = TF32_FLOP_PER_S / (2 if half == 2 else 3)

    def nbytes(xs):
        return sum(x.numel() * x.element_size() for x in xs if x is not None)

    if which == "data":
        hz = _tap_tensor(t, torch.ones_like(a), ksize, interpolation) != 0
        product = 2 * int(hz.any(dim=1).sum()) * cin * cout
        rest = 2 * int(hz.sum()) * cin + 2 * int(
            (_tap_tensor(t, a, ksize, interpolation) != 0).sum()) * cin
        moved = nbytes((idx, a, t, qfeats, dout)) \
            + (feats.numel() + w.numel()) * half \
            + feats.numel() * 4 + nbytes((qfeats, a, t))
    else:
        nz = _tap_tensor(t, a, ksize, interpolation) != 0
        rest = 2 * int(nz.sum()) * cin
        product = 2 * int(nz.any(dim=1).sum()) * cin * cout
        moved = nbytes((idx, a, t, qfeats, dout)) + feats.numel() * half \
            + nbytes((w,))
    ops_ms = (product / mma_rate + rest / FP32_FLOP_PER_S) * 1e3
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def bwd_check(args, qfeats, seed, precision="highest",
              interpolation="linear"):
    """Both backward kernels (the ``precision``'s variant) at one launch
    shape (the forward's inputs ``args``) against the plain backward, on a
    random dout: per gradient the max abs error over that gradient's max
    abs (0 where both are 0), and the max abs error; the bf16 variant's
    dfeats and dW apart from one-step rounding flips, whose count is
    checked and printed.  The bf16 variant's da and dt are held as phase 7
    holds T (``bf16_data_flips``): the data kernel's dT, summed on the
    tensor cores, may lie one bf16 step from the plain dT; those flips are
    counted (at most max(4, 1e-3 of dT's elements), the other elements
    within 1e-4 of dT's max), da and dt are held within the tolerance
    against the plain backward fed the kernel's dT, and an element beyond
    it against the plain backward itself only in a slot that touches a
    tap row of its query where dT flipped.  Each kernel is
    launched twice and the two results must be bitwise equal (both are
    deterministic): dW, and dfeats, dqfeats, da and dt."""
    from dmcf_tpu_torch.kernels.cconv_klist import (
        bf16_data_flips, cconv_klist_bwd_data, cconv_klist_bwd_filter,
        cconv_klist_bwd_reference, is_bf16, rounding_flips)
    idx, a, t, feats, w, ksize = args
    half = is_bf16(precision)
    if half:
        feats, w = feats.bfloat16(), w.bfloat16()
    g = torch.Generator(device=feats.device).manual_seed(seed)
    dout = torch.randn((idx.shape[0], w.shape[1]), generator=g,
                       device=feats.device)
    full = (dout, idx, a, t, feats, w, ksize, qfeats)
    kw = dict(precision=precision, interpolation=interpolation)
    dfeats, dqfeats, da, dt = cconv_klist_bwd_data(*full, **kw)
    got = (dfeats, dqfeats, cconv_klist_bwd_filter(*full, **kw), da, dt)
    again = cconv_klist_bwd_filter(*full, **kw)
    data_again = cconv_klist_bwd_data(*full, **kw)
    torch.cuda.synchronize()
    check(torch.equal(got[2], again), "dw: two filter launches bitwise "
          "equal")
    for name, x, y in zip(("dfeats", "dqfeats", "da", "dt"),
                          (dfeats, dqfeats, da, dt), data_again):
        check((x is None and y is None) or torch.equal(x, y),
              f"{name}: two data launches bitwise equal")
    tol = BF16_BWD_TOL if half else BWD_TOL
    rel, abs_err, flips = {}, {}, {}
    for name, x, want in zip(BWD_NAMES, got, cconv_klist_bwd_reference(
            *full, **kw)):
        if want is None:
            continue
        check(bool(torch.isfinite(x.float()).all()), f"{name}: finite")
        scale = float(want.abs().max())
        if half and name in ("dfeats", "dw"):
            err, flips[name] = rounding_flips(x, want)
            check(flips[name] <= max(4, 1e-3 * want.numel()),
                  f"{name}: {flips[name]} one-step rounding flips")
        else:
            err = float((x - want).abs().max())
        rel[name] = err / scale if scale > 0 else err
        abs_err[name] = err
        if not (half and name in ("da", "dt")):  # those: below
            check(err <= tol * scale,
                  f"{name}: kernel vs plain backward {err} > {tol} x {scale}")
    if half:  # da and dt as phase 7 holds T: dT's one-step flips counted
        res = bf16_data_flips(*full[:7], (dfeats, da, dt), tol,
                              interpolation)
        check(res["dT_flips"] <= max(4, 1e-3 * res["dT_elements"])
              and res["dT_err"] <= 1e-4 * res["dT_scale"],
              f"dT: {res['dT_flips']} one-step flips, other elements "
              f"{res['dT_err']}")
        err, n_flip = res["forced"]["dfeats"]
        check(n_flip <= max(4, 1e-3 * dfeats.numel())
              and err <= tol * res["dfeats_scale"],
              f"dfeats vs the plain backward fed the kernel's dT: {err}, "
              f"{n_flip} flips")
        for name in ("da", "dt"):
            check(res["forced"][name] <= tol,
                  f"{name} vs the plain backward fed the kernel's dT: "
                  f"{res['forced'][name]} > {tol}")
            check(res["unexplained"][name] == 0,
                  f"{name}: {res['unexplained'][name]} elements beyond "
                  f"{tol} in slots that touch no flipped tap row of dT")
        flips["dT"] = res["dT_flips"]
        print(f"    dT: {res['dT_flips']} one-step flips of "
              f"{res['dT_elements']}; fed the kernel's dT, the plain "
              f"backward's da {res['forced']['da']:.2e}, dt "
              f"{res['forced']['dt']:.2e} of the max; beyond {tol} of the "
              f"plain backward itself: da {res['beyond']['da']}, dt "
              f"{res['beyond']['dt']} elements")
    if flips:
        sizes = {k: got[BWD_NAMES.index(k)].numel() for k in flips
                 if k != "dT"}
        if half:
            sizes["dT"] = res["dT_elements"]
        print("    one-step bf16 rounding flips: " + ", ".join(
            f"{k} {v} of {sizes[k]}" for k, v in flips.items()))
    return rel, abs_err, full


def bwd_times(full, precision="highest", interpolation="linear"):
    """(data ms, data device ms, filter ms, filter device ms, plain ms,
    data bound (ms, by), filter bound (ms, by)) at one launch shape."""
    from dmcf_tpu_torch.kernels.cconv_klist import (
        cconv_klist_bwd_data, cconv_klist_bwd_filter,
        cconv_klist_bwd_reference)
    from dmcf_tpu_torch.profile_step import graph_ms
    kw = dict(precision=precision, interpolation=interpolation)
    return (cuda_ms(lambda: cconv_klist_bwd_data(*full, **kw), iters=20),
            graph_ms(lambda: cconv_klist_bwd_data(*full, **kw)),
            cuda_ms(lambda: cconv_klist_bwd_filter(*full, **kw), iters=20),
            graph_ms(lambda: cconv_klist_bwd_filter(*full, **kw)),
            cuda_ms(lambda: cconv_klist_bwd_reference(*full, **kw),
                    iters=10),
            bwd_bound("data", *full, **kw), bwd_bound("filter", *full, **kw))


def close(got, want, rtol, atol, what):
    """|got - want| <= rtol |want| + atol, printed and checked."""
    err = abs(float(got) - float(want))
    print(f"  {what}: card {float(got):.9e} CPU {float(want):.9e} diff "
          f"{err:.3e} (tol {rtol} rel + {atol})")
    check(err <= rtol * abs(float(want)) + atol,
          f"{what}: card vs CPU {err}")


def card_T(args, kw):
    """The bf16 kernel's T [Q, S*Cin] (bf16 values in fp32) at one logged
    launch: the kernel run with W the identity, 32 columns a launch (the
    trunk's Cout; an fp32 sum of T times 1 and zeros is exact)."""
    from dmcf_tpu_torch.kernels.cconv_klist import cconv_klist
    idx, a, t, feats, w, ks = args
    n = w.shape[0]
    eye = torch.eye(n, device=w.device)
    return torch.cat([cconv_klist(idx, a, t, feats,
                                  eye[:, j:j + 32].contiguous(), ks,
                                  precision=kw["precision"],
                                  interpolation=kw["interpolation"])
                      for j in range(0, n, 32)], dim=1)


def plain_T(args, kw):
    """The plain version's T [Q, S*Cin] on the CPU for the same inputs."""
    from dmcf_tpu_torch.kernels.cconv_klist import cconv_klist_reference
    idx, a, t, feats, w, ks = (x.cpu() if torch.is_tensor(x) else x
                               for x in args)
    return cconv_klist_reference(idx, a, t, feats, torch.eye(w.shape[0]),
                                 ks, precision=kw["precision"],
                                 interpolation=kw["interpolation"])


def forced_step(cpu_model, sample, forced):
    """One step of ``cpu_model`` on the CPU in which the i-th K-list call
    takes ``forced[i]`` as its T where that is not None (the plain
    version's product with bf16(W)); the other calls run the plain
    version."""
    from dmcf_tpu_torch.kernels.cconv_klist import (cconv_klist,
                                                    cconv_klist_reference,
                                                    round_bf16)
    from dmcf_tpu_torch.ops import cconv as ops_cconv
    calls = iter(forced)

    def call(idx, a, t, feats, w, ks, qfeats=None, precision="highest",
             interpolation="linear"):
        T = next(calls)
        if T is None:
            return cconv_klist_reference(idx, a, t, feats, w, ks,
                                         qfeats=qfeats, precision=precision,
                                         interpolation=interpolation)
        check(T.shape == (idx.shape[0], w.shape[0]), "forced T's shape")
        return T @ round_bf16(w)

    ops_cconv.cconv_klist = call
    try:
        with torch.no_grad():
            return cpu_model(sample)
    finally:
        ops_cconv.cconv_klist = cconv_klist


def small_scene_phase(model, dev):
    """Phase 7: the bf16-trunk step on a 256-fluid scene, card against the
    plain path on the CPU.  Sums taken in another order before T's bf16
    rounding can put an element of T one bf16 step apart (~2e-4 of the
    correction's max downstream), so: at each bf16 launch the card's T
    (``card_T``) against the CPU plain version's on the same inputs, one-step
    flips counted apart (``rounding_flips``; every other element equal to
    1e-4 of T's max, at most max(4, 1e-3 of the elements) flips); the CPU
    step with the card's T forced in (``forced_step``) within 1e-4 of the
    correction's max of the card's, every element; the free CPU step's
    elements beyond that only where flips were counted; positions within
    1e-6 of the free CPU step."""
    from dmcf_tpu_torch.kernels.cconv_klist import rounding_flips
    from dmcf_tpu_torch.profile_step import record_launches
    from dmcf_tpu_torch.scene import bench_sample, build_scene

    small = build_scene(256)
    s_gpu = bench_sample(*small, device=dev)
    s_cpu = bench_sample(*small, device="cpu")
    cpu_model = copy.deepcopy(model).to("cpu")
    (pg, _, ag), log = record_launches(model, s_gpu)
    with torch.no_grad():
        pc, _, ac = cpu_model(s_cpu)
        forced, flips = [], 0
        for name, args, kw, _ in log:
            if not bf16(kw):
                forced.append(None)
                continue
            got, want = card_T(args, kw).cpu(), plain_T(args, kw)
            err, n_flip = rounding_flips(got, want)
            tol = 1e-4 * float(want.abs().max())
            print(f"  {name:12s} T {tuple(want.shape)}: one-step flips "
                  f"{n_flip}, other elements max diff {err:.3e} (tol "
                  f"{tol:.3e})")
            check(err <= tol, f"{name}: card T vs CPU T {err} <= {tol}")
            check(n_flip <= max(4, 1e-3 * want.numel()),
                  f"{name}: {n_flip} one-step flips of T")
            flips += n_flip
            forced.append(got)
    pf, _, af = forced_step(cpu_model, s_cpu, forced)
    pcg = ag["pos_correction"].cpu()
    scale = float(ac["pos_correction"].abs().max())
    tol = 1e-4 * scale
    diff_free = (pcg - ac["pos_correction"]).abs()
    diff_forced = float((pcg - af["pos_correction"]).abs().max())
    beyond = int((diff_free > tol).sum())
    print(f"pos_correction max {scale:.3e}; card vs CPU with the card's T "
          f"max diff {diff_forced:.3e} (tol {tol:.3e}); card vs free CPU "
          f"max diff {float(diff_free.max()):.3e}, {beyond} elements beyond "
          f"the tolerance, explained by {flips} one-step flips of T; "
          f"positions max diff {float((pg.cpu() - pc).abs().max()):.3e} "
          f"(tol 1e-6)")
    check(scale > 0 and diff_forced <= tol,
          f"card vs forced CPU pos_correction {diff_forced} <= {tol}")
    check(beyond == 0 or flips > 0,
          f"{beyond} elements beyond {tol} with no flip of T to explain "
          "them")
    check(torch.allclose(pg.cpu(), pc, atol=1e-6, rtol=0),
          "card vs CPU positions within 1e-6")
    check(torch.allclose(pg.cpu(), pf, atol=1e-6, rtol=0),
          "card vs forced CPU positions within 1e-6")


def valid_phase(root, dev):
    """Phase 9: ``Simulator.run_valid`` of the momentum config on the card
    (full width, seed-0 weights, its 2 valid scenes of 40 frames; the
    config's precision, a bf16 trunk), with every metric finite and each
    K-list kernel variant's launches counted exactly (every launch of a
    step, K 48, 96 and 256, held against its twin first); then the card
    against the same pipeline on the CPU over the first VALID_FRAMES frames
    of scene 0, and the momentum drift of the card's rollout.

    The config's finest radius (0.02) is below the generator's particle
    spacing (0.020625), so its ASCC layer sees no neighbour and the
    position correction is exactly 0 (ROADMAP §3): the comparison and the
    drift are therefore also run with the data scaled by 0.9
    (``data_generator.scale``), where the correction is not 0."""
    import copy
    import tempfile

    import yaml
    from dmcf_tpu_torch.data import (DatasetGroup, get_rollout,
                                     pad_rollout_state)
    from dmcf_tpu_torch.kernels.cconv_klist import (cconv_klist,
                                                    cconv_klist_reference)
    from dmcf_tpu_torch.models import build_model
    from dmcf_tpu_torch.models.layers import ContinuousConv
    from dmcf_tpu_torch.models.losses import density_loss
    from dmcf_tpu_torch.ops.emd import emd_loss
    from dmcf_tpu_torch.ops.windows import get_window_func
    from dmcf_tpu_torch.pipelines import Simulator
    from dmcf_tpu_torch.pipelines.metrics import compare_dist
    from dmcf_tpu_torch.profile_step import graph_ms, record_launches

    with open(os.path.join(root, "configs", "other", "momentum.yml")) as f:
        cfg = yaml.safe_load(f)
    model = build_model(cfg["model"], device=dev,
                        generator=torch.Generator().manual_seed(0))
    cpu_model = copy.deepcopy(model).to("cpu")
    # the config's splits under their seeds, in memory (no cache file)
    group = DatasetGroup(split="valid", cache_dir=None, **cfg["dataset"])
    dg = cfg["pipeline"]["data_generator"]
    tmp = tempfile.TemporaryDirectory()

    def simulator(m, device, scale):
        return Simulator(m, dataset=group, name="Simulator", device=device,
                         split="valid", valid_full_metrics=True,
                         main_log_dir=os.path.join(tmp.name, "logs"),
                         output_dir=os.path.join(tmp.name, "out"),
                         train_sum_dir=os.path.join(tmp.name, "sum"),
                         data_generator=dict(dg, scale=scale))

    def sequences(scale):
        split = {k: v for k, v in dg.items()
                 if k not in ("train", "valid", "test")}
        return get_rollout(group.valid, **dict(split, scale=scale),
                           **dg["valid"])

    # each ContinuousConv runs once a step: the 2 scale-0 convs, every
    # (output scale, input scale) pair of every trunk layer, the ASCC stack
    n_sym = len(model.sym_convs)       # fp32 (ASCC) launches a step
    per_step = sum(isinstance(m, ContinuousConv) for m in model.modules())
    half = model.precision != "highest"
    per_variant = ([n_sym, per_step - n_sym] if half else [per_step, 0])
    seqs = sequences(dg["scale"])
    state = pad_rollout_state(seqs[0])
    pipe = simulator(model, dev, dg["scale"])
    (_, _, aux), log = record_launches(model, pipe._device_state(state, 0))
    torch.cuda.synchronize()
    max_err = {False: 0.0, True: 0.0}
    step_device_ms = step_bound_ms = 0.0
    with torch.no_grad():
        for name, args, kw, out in log:
            err = fwd_check(name, out, cconv_klist_reference(*args, **kw),
                            kw)
            kargs = kernel_args(args, kw)
            d_ms = graph_ms(lambda: cconv_klist(*kargs, **kw))
            b_ms, b_by, _, _ = bound(*args, kw["qfeats"], kw["precision"],
                                     kw["interpolation"])
            step_device_ms += d_ms
            step_bound_ms += b_ms
            idx_, _, _, f_, w_, _ = args
            print(f"  {name:9s} Q {idx_.shape[0]:3d} K {idx_.shape[1]:3d} "
                  f"N {f_.shape[0]:3d} Cin {f_.shape[1]:2d} Cout "
                  f"{w_.shape[1]:2d} {'bf16' if bf16(kw) else 'fp32'}: "
                  f"device time {d_ms:.4f} ms, bound {b_ms:.5f} ms "
                  f"({b_by}), max_abs_err {err:.3e}")
            max_err[bf16(kw)] = max(max_err[bf16(kw)], err)
    print(f"  per step ({len(log)} launches): device time "
          f"{step_device_ms:.4f} ms, bound {step_bound_ms:.5f} ms")
    ks = {args[0].shape[1] for _, args, _, _ in log}
    kinds = [sum(not bf16(kw) for _, _, kw, _ in log),
             sum(bf16(kw) for _, _, kw, _ in log)]
    check(len(log) == per_step and {48, 96, 256} <= ks
          and kinds == per_variant,
          f"{len(log)} launches a step (want {per_step}), K {sorted(ks)}, "
          f"fp32/bf16 {kinds} (want {per_variant})")
    print(f"  one step: {per_step} launches (fp32 {kinds[0]}, bf16 "
          f"{kinds[1]}), K {sorted(ks)}, max "
          f"|pos_correction| {float(aux['pos_correction'].abs().max()):.3e}"
          f", neighbor_overflow {int(aux['neighbor_overflow'])}, "
          f"pair_overflow {int(aux['pair_overflow'])}")

    zero_counts()                  # the valid path starts here
    torch.cuda.synchronize()
    t0 = time.time()
    loss = pipe.run_valid(epoch=0)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = counts()[:2]        # the valid path ends here
    steps = sum(2 * (s["pos"].shape[0] - 1) for s in seqs)
    keys = {"mse_val", "chamfer_val", "chamfer_val_2", "dens_val",
            "max_dens_val", "emd", "vel_diff_val", "vel_diff_val_2",
            "mse_single_val", "loss"}
    rollout_s = sum(s["pos"].shape[0] - 1 for s in seqs) \
        / pipe.last_steps_per_sec
    print(f"  run_valid {seconds:.3f} s, {len(seqs)} scenes x "
          f"{seqs[0]['pos'].shape[0]} frames, {seqs[0]['pos'].shape[1]} "
          f"fluid; {steps} model steps, {launches} kernel launches; free "
          f"rollouts {rollout_s:.3f} s "
          f"({1e3 / pipe.last_steps_per_sec:.3f} ms/step), metrics and "
          f"single steps {seconds - rollout_s:.3f} s")
    print("  " + " ".join(f"{k} {v:.6e}" for k, v in loss.items()))
    check(set(loss) == keys, f"valid keys {sorted(loss)}")
    check(all(np.isfinite(v) for v in loss.values()), "finite valid metrics")
    check(launches == [x * steps for x in per_variant],
          f"fp32/bf16 launches {launches} == {per_variant} x {steps}")

    win = get_window_func("poly6")
    r0 = float(cfg["model"]["particle_radii"][0])
    k = int(cfg["model"]["neighbor_k"])
    for scale in (dg["scale"], [0.9, 0.9, 0.0]):
        print(f"  data scale {scale}: card vs the plain path on the CPU, "
              f"scene 0, {VALID_FRAMES} frames")
        card, cpu = simulator(model, dev, scale), simulator(cpu_model, "cpu",
                                                           scale)
        seq = sequences(scale)[0]
        short = dict(seq, pos=seq["pos"][:VALID_FRAMES],
                     vel=seq["vel"][:VALID_FRAMES],
                     grav=seq["grav"][:VALID_FRAMES])
        (pg, vg), = card.run_rollout([short], VALID_FRAMES)
        (pc, vc), = cpu.run_rollout([short], VALID_FRAMES)
        diff = float(np.abs(pg - pc).max())
        print(f"  rollout positions max diff {diff:.3e} (tol 1e-5)")
        check(diff <= 1e-5, f"card vs CPU rollout positions {diff}")
        mg = card._seq_device_metrics(short, pg, True)
        mc = cpu._seq_device_metrics(short, pc, True)
        gt, gv = short["pos"].astype(np.float32), short["vel"]
        ones = torch.ones(gt.shape[1], dtype=torch.bool)
        for t in range(1, VALID_FRAMES):
            close(mg["mse_single_val"][t - 1], mc["mse_single_val"][t - 1],
                  1e-4, 1e-7, f"t {t} mse_single_val")
            close(compare_dist(gv[t], vg[t]), compare_dist(gv[t], vc[t]),
                  1e-4, 1e-6, f"t {t} vel_diff_val")
            close(compare_dist(vg[t], gv[t]), compare_dist(vc[t], gv[t]),
                  1e-4, 1e-6, f"t {t} vel_diff_val_2")
            got, want = [], []
            for p, d, out in ((pg, dev, got), (pc, "cpu", want)):
                g_ = torch.as_tensor(gt[t], device=d)
                p_ = torch.as_tensor(p[t], device=d)
                m_ = ones.to(d)
                out.append(emd_loss(g_[None], p_[None])[0])
                out.append(density_loss(g_, p_, m_, m_, radius=r0, win=win,
                                        k=k))
                out.append(density_loss(g_, p_, m_, m_, radius=r0, win=win,
                                        k=k, use_max=True))
            for name, a, b in zip(("emd", "density", "max_density"), got,
                                  want):
                close(a, b, 1e-4, 1e-7, f"t {t} {name} (unclipped)")
        with torch.no_grad():
            _, _, aux = model(card._device_state(pad_rollout_state(seq), 0))
        corr = aux["pos_correction"]
        total = float(corr.abs().sum())
        ratio = float(corr.sum(0).norm()) / total if total else 0.0
        print(f"  one step's correction: sum |c| {total:.3e}, |sum c| / "
              f"sum |c| {ratio:.3e} (ASCC, < 1e-5)")
        check(ratio < 1e-5, f"ASCC correction ratio {ratio}")
        (_, vs), = card.run_rollout([seq], seq["pos"].shape[0])
        drift = float(np.linalg.norm(vs[-1].sum(0) - vs[0].sum(0))
                      / np.linalg.norm(vs[0], axis=1).sum())
        print(f"  momentum drift over {vs.shape[0] - 1} steps: "
              f"|sum v_T - sum v_0| / sum |v_0| = {drift:.3e} (bound "
              f"{DRIFT_BOUND})")
        check(drift <= DRIFT_BOUND, f"momentum drift {drift}")
    tmp.cleanup()
    return {"launches": launches, "launches_per_step": per_variant,
            "max_abs_err": max_err, "step_device_ms": step_device_ms,
            "step_bound_ms": step_bound_ms}


def momentum_cfg(root):
    import yaml
    with open(os.path.join(root, "configs", "other", "momentum.yml")) as f:
        return yaml.safe_load(f)


def bwd_phase(root, dev, wr_shapes):
    """Phase 10: both backward kernels against the plain backward at every
    launch shape of the first momentum train step (its first batch item,
    data scaled by 0.9; K 48, 96 and 256, the ASCC conv symmetric), each
    non-symmetric shape in both variants (the step's own, bf16, and fp32),
    and at the WaterRamps trunk (both variants) and ASCC shapes, each timed
    beside its bound and the plain backward.  Returns the numbers for the
    kernels line, per variant ("highest", "default")."""
    from dmcf_tpu_torch.data import DatasetGroup, get_dataloader
    from dmcf_tpu_torch.models import build_model
    from dmcf_tpu_torch.profile_step import record_launches

    cfg = momentum_cfg(root)
    model = build_model(cfg["model"], device=dev,
                        generator=torch.Generator().manual_seed(42))
    group = DatasetGroup(split="train", cache_dir=None, **cfg["dataset"])
    dg = dict(cfg["pipeline"]["data_generator"], scale=[0.9, 0.9, 0.0])
    train = dict(dg.pop("train"), seed=0)
    dg.pop("valid"), dg.pop("test")
    loader = get_dataloader(group.train, batch_size=2, window=3, **dg,
                            **train)
    batch = next(loader)
    loader.close()
    sample = {k: torch.as_tensor(batch[k][0][0] if k in ("pos", "vel")
                                 else batch[k][0], device=dev)
              for k in ("pos", "vel", "box", "box_normals", "fluid_mask",
                        "box_mask")}
    _, log = record_launches(model, sample)
    precisions = ("highest", "default")
    worst = {p: {} for p in precisions}
    worst_abs = {p: {} for p in precisions}
    totals = {p: dict(data_ms=0.0, data_device_ms=0.0, filter_ms=0.0,
                      filter_device_ms=0.0, plain_ms=0.0, data_bound_ms=0.0,
                      filter_bound_ms=0.0) for p in precisions}
    bitwise = dict.fromkeys(precisions, 0)  # shapes whose two launches
    #                                         of each kernel were bitwise
    #                                         equal

    def one(args, qfeats, seed, prec, what):
        from dmcf_tpu_torch.kernels.cconv_klist import data_workspace_bytes
        rel, err, full = bwd_check(args, qfeats, seed, prec)
        bitwise[prec] += 1
        idx_, _, _, f_, w_, ks_ = args
        work = data_workspace_bytes(*idx_.shape, *f_.shape, w_.shape[1],
                                    *ks_, prec == "default")
        tm = bwd_times(full, prec)
        for k, v in err.items():
            worst_abs[prec][k] = max(worst_abs[prec].get(k, 0.0), v)
        for k, v in rel.items():
            worst[prec][k] = max(worst[prec].get(k, 0.0), v)
        print(f"  {what} {'bf16' if prec == 'default' else 'fp32'}: data "
              f"{tm[0]:.4f} ms (device {tm[1]:.4f}, bound {tm[5][0]:.5f} "
              f"{tm[5][1]}), filter {tm[2]:.4f} ms (device {tm[3]:.4f}, "
              f"bound {tm[6][0]:.5f} {tm[6][1]}), plain {tm[4]:.4f} ms; "
              f"data workspace {work} B; rel err " + " ".join(
                  f"{k} {v:.2e}" for k, v in rel.items()))
        return tm

    for i, (name, args, kw, _) in enumerate(log):
        idx_, _, _, f_, w_, _ = args
        what = (f"{name:9s} Q {idx_.shape[0]:3d} K {idx_.shape[1]:3d} N "
                f"{f_.shape[0]:3d} Cin {f_.shape[1]:2d} Cout {w_.shape[1]:2d}")
        for prec in (("highest", "default") if bf16(kw) else ("highest",)):
            tm = one(args, kw["qfeats"], i, prec, what)
            t = totals[prec]
            for key, v in zip(("data_ms", "data_device_ms", "filter_ms",
                               "filter_device_ms", "plain_ms"), tm[:5]):
                t[key] += v
            t["data_bound_ms"] += tm[5][0]
            t["filter_bound_ms"] += tm[6][0]
    ks = {args[0].shape[1] for _, args, _, _ in log}
    check({48, 96, 256} <= ks and any(kw["qfeats"] is not None
                                      for _, _, kw, _ in log)
          and any(bf16(kw) for _, _, kw, _ in log),
          f"momentum launch shapes K {sorted(ks)}")
    for prec in precisions:
        print(f"  per momentum step ({len(log)} shapes), "
              f"{'bf16' if prec == 'default' else 'fp32'}: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in totals[prec].items()))
    out = {"momentum_step": totals}
    i_, a_, t_, f_, w_, ks_, _ = wr_shapes["trunk"]
    for prec in precisions:
        out[("trunk", prec)] = one((i_, a_, t_, f_, w_, ks_), None, 100,
                                   prec, "WaterRamps trunk (Q "
                                   f"{i_.shape[0]} K {i_.shape[1]} Cin "
                                   f"{f_.shape[1]} Cout {w_.shape[1]})")
    i_, a_, t_, f_, w_, ks_, qf_ = wr_shapes["ascc"]
    out[("ascc", "highest")] = one((i_, a_, t_, f_, w_, ks_), qf_, 101,
                                   "highest", "WaterRamps ASCC")
    for prec in precisions:
        tol = BF16_BWD_TOL if prec == "default" else BWD_TOL
        print(f"  worst rel err over all shapes, "
              f"{'bf16' if prec == 'default' else 'fp32'} (tol {tol:g}): "
              + " ".join(f"{k} {v:.2e}" for k, v in worst[prec].items()))
    print("  filter and data kernels, two launches bitwise equal at every "
          "shape (dW; dfeats, dqfeats, da, dt): " + ", ".join(
              f"{'bf16' if p == 'default' else 'fp32'} {n}"
              for p, n in bitwise.items()))
    out["worst"], out["worst_abs"] = worst, worst_abs
    out["bitwise_shapes"] = bitwise
    return out


def counts(mode=None):
    """Launches of each kernel variant: [forward fp32, forward bf16, data
    fp32, data bf16, filter fp32, filter bf16], over every interpolation
    mode or of one ``mode``."""
    from dmcf_tpu_torch.kernels.cconv_klist import (
        cconv_klist, cconv_klist_bwd_data, cconv_klist_bwd_filter)
    fns = (cconv_klist, cconv_klist_bwd_data, cconv_klist_bwd_filter)
    if mode is not None:
        return [n for f in fns for n in f.mode_launches[mode]]
    return [n for f in fns for n in (f.launches, f.launches_bf16)]


def zero_counts():
    """Every kernel's launch counts to 0 (``counts`` and
    ``fps_launches`` read them)."""
    from dmcf_tpu_torch.kernels.cconv_klist import zero_launches
    from dmcf_tpu_torch.kernels.fps import farthest_point_sample
    zero_launches()
    farthest_point_sample.launches = 0


def expected_train_launches(items, window, convs, bf16_convs,
                            step0_free=2):
    """Launches of one train step over ``items`` items, as ``counts``
    orders them, of a model with ``convs`` K-list convs of which
    ``bf16_convs`` (the scale-0 and trunk convs at the default precision)
    run the bf16 variants: each variant's forward kernel twice a conv a
    step (the forward and its recompute under the per-step checkpoint), its
    filter kernel once a conv a step, its data kernel the same but for the
    ``step0_free`` scale-0 convs of step 0 (two, three with the
    pre-advection conv), whose inputs (the detached starting state) take
    no gradient."""
    n = {False: convs - bf16_convs, True: bf16_convs}
    scale0 = {False: step0_free - min(step0_free, bf16_convs),
              True: min(step0_free, bf16_convs)}
    out = [0] * 6
    for half in (False, True):
        out[int(half)] = 2 * items * window * n[half]
        out[2 + int(half)] = items * (window * n[half] - scale0[half])
        out[4 + int(half)] = items * window * n[half]
    return out


def train_phase(root, dev):
    """Phase 11: ``run_pipeline --split train`` of the momentum config on
    the card (its precision: a bf16 trunk; data scaled by 0.9, TRAIN_ITERS
    iterations of batch 2, window 3, then its per-epoch ``run_valid``) with
    every kernel variant's launches counted exactly and the losses finite;
    then the first two train steps of a seeded loader on the card and on
    the CPU from the same weights (the CPU model takes the card's weights
    before each step): loss vectors and every parameter's gradient
    compared (bf16: within BF16_GRAD_TOL, the card and the CPU rounding
    sums taken in other orders), every trunk and ASCC conv weight's
    gradient non-zero; then the card's s per train step.  The run's
    summary directory (``summary_dir``) is kept for phase 23; ``tmp``
    holds it until then."""
    from dmcf_tpu_torch import run_pipeline
    from dmcf_tpu_torch.data import DatasetGroup, get_dataloader, get_rollout
    from dmcf_tpu_torch.models import build_model
    from dmcf_tpu_torch.models.layers import ContinuousConv
    from dmcf_tpu_torch.models.losses import get_loss
    from dmcf_tpu_torch.pipelines.simulator import (make_optimizer,
                                                    make_train_step)
    from dmcf_tpu_torch.profile_step import print_report, trace

    cfg = momentum_cfg(root)
    pcfg = cfg["pipeline"]
    group = DatasetGroup(split="train", cache_dir=None, **cfg["dataset"])
    scale = [0.9, 0.9, 0.0]
    dg = dict(pcfg["data_generator"], scale=scale)
    split = {k: v for k, v in dg.items() if k not in ("train", "valid",
                                                      "test")}
    valid_steps = sum(2 * (s["pos"].shape[0] - 1) for s in get_rollout(
        group.valid, **split, **dg["valid"]))
    model = build_model(cfg["model"], device=dev,
                        generator=torch.Generator().manual_seed(42))
    convs = [n for n, m in model.named_modules()
             if isinstance(m, ContinuousConv)]
    per_step = len(convs)
    n_bf16 = sum(model.get_submodule(n).precision != "highest"
                 for n in convs)
    grad_tol = BF16_GRAD_TOL if n_bf16 else GRAD_TOL
    batch_size, window = int(pcfg["batch_size"]), int(pcfg["windows"][0])
    tmp = tempfile.TemporaryDirectory()
    args = ["--cfg_file", os.path.join(root, "configs", "other",
                                       "momentum.yml"),
            "--split", "train", "--device", "cuda",
            "--dataset.cache_dir", "none", "--pipeline.max_epoch", "0",
            "--pipeline.iter", str(TRAIN_ITERS),
            "--pipeline.data_generator.scale", "[0.9,0.9,0.0]",
            "--pipeline.run_test_every_epoch", "false",
            "--pipeline.log_every", "1",
            "--main_log_dir", os.path.join(tmp.name, "logs"),
            "--output_dir", os.path.join(tmp.name, "out"),
            "--pipeline.train_sum_dir", os.path.join(tmp.name, "sum")]
    zero_counts()               # the training path starts here
    torch.cuda.synchronize()
    t0 = time.time()
    logged = run_pipeline.main(args)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = counts()         # the training path ends here
    step = expected_train_launches(batch_size, window, per_step, n_bf16)
    want = [TRAIN_ITERS * x for x in step]
    want[0] += (per_step - n_bf16) * valid_steps   # run_valid's forwards
    want[1] += n_bf16 * valid_steps
    losses = [e["loss"] for e in logged]
    print(f"  run_pipeline --split train: {TRAIN_ITERS} iterations + "
          f"run_valid ({valid_steps} model steps) in {seconds:.3f} s; "
          f"launches (fp32, bf16) cconv_klist {launches[0:2]}, bwd_data "
          f"{launches[2:4]}, bwd_filter {launches[4:6]} (want {want}: a "
          f"step {step}, {per_step} convs of which {n_bf16} bf16, batch "
          f"{batch_size}, window {window})")
    print("  losses " + " ".join(f"{v:.6e}" for v in losses))
    check(len(losses) == TRAIN_ITERS and all(np.isfinite(losses)),
          "finite train losses")
    check(launches == want, f"train launches {launches} == {want}")

    # the first two steps, card vs CPU
    loader = get_dataloader(group.train, batch_size=batch_size,
                            window=window, **split,
                            **dict(dg["train"], seed=0))
    batches = [next(loader) for _ in range(5)]
    loader.close()
    cpu_model = copy.deepcopy(model).to("cpu")
    loss = {k: get_loss(**v) for k, v in cfg["model"]["loss"].items()}
    opt_cfg = pcfg["optimizer"]
    card_step = make_train_step(model, loss, *make_optimizer(model, opt_cfg),
                                window=window)
    cpu_step = make_train_step(cpu_model, loss,
                               *make_optimizer(cpu_model, opt_cfg),
                               window=window)
    time_w = np.ones(window, np.float32)
    grad_err = 0.0
    for i, b in enumerate(batches[:2]):
        cpu_model.load_state_dict(model.state_dict())
        lg, _, _ = card_step({k: torch.as_tensor(v, device=dev)
                              for k, v in b.items() if v is not None},
                             time_w)
        lc, _, _ = cpu_step({k: torch.as_tensor(v) for k, v in b.items()
                             if v is not None}, time_w)
        close(lg.sum(), lc.sum(), 1e-4, 0.0, f"step {i} loss")
        zero = []
        for (name, pg), (_, pc) in zip(model.named_parameters(),
                                       cpu_model.named_parameters()):
            scale = float(pc.grad.abs().max())
            err = float((pg.grad.cpu() - pc.grad).abs().max())
            grad_err = max(grad_err, err / scale if scale else err)
            check(err <= grad_tol * scale,
                  f"step {i} {name}: grad card vs CPU {err} > {grad_tol} x "
                  f"{scale}")
            if name.endswith(".kernel") and name[:-7] in convs \
                    and float(pg.grad.abs().max()) == 0:
                zero.append(name)
        print(f"  step {i}: gradients card vs CPU within {grad_err:.2e} of "
              f"each tensor's max (tol {grad_tol}); conv weights with a "
              f"zero gradient: {zero}")
        # the one boundary point is far from the fluid: obs_conv sees only
        # itself and its output reaches no fluid particle
        check(zero == ["obs_conv.kernel"], f"zero-gradient convs {zero}")
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    for b in batches[2:]:
        card_step({k: torch.as_tensor(v, device=dev) for k, v in b.items()
                   if v is not None}, time_w)
    torch.cuda.synchronize()
    step_s = (time.time() - t0) / len(batches[2:])
    got = counts()
    check(got == [len(batches[2:]) * x for x in step],
          f"{got} launches in {len(batches[2:])} steps, a step {step}")
    print(f"  card train step (batch {batch_size}, window {window}): "
          f"{step_s:.4f} s over {len(batches[2:])} steps")
    print("  where a train step's time goes:")
    print_report(trace(lambda: card_step(
        {k: torch.as_tensor(v, device=dev) for k, v in batches[2].items()
         if v is not None}, time_w), reps=1, top=10), top=10)
    (run,) = os.listdir(os.path.join(tmp.name, "sum"))
    return {"launches": launches, "launches_per_step": step,
            "step_s": step_s, "grad_rel_err": grad_err, "seconds": seconds,
            "summary_dir": os.path.join(tmp.name, "sum", run), "tmp": tmp}


def fp32_train_phase(root, dev, steps=3):
    """Phase 13's training half: momentum train steps (batch 2, window 3,
    data scaled by 0.9) of the model at precision "highest", seconds a step
    over ``steps`` after a warm-up step, the launches (all fp32) counted
    exactly."""
    from dmcf_tpu_torch.data import DatasetGroup, get_dataloader
    from dmcf_tpu_torch.models import build_model
    from dmcf_tpu_torch.models.layers import ContinuousConv
    from dmcf_tpu_torch.models.losses import get_loss
    from dmcf_tpu_torch.pipelines.simulator import (make_optimizer,
                                                    make_train_step)

    cfg = momentum_cfg(root)
    pcfg = cfg["pipeline"]
    model = build_model(dict(cfg["model"], precision="highest"), device=dev,
                        generator=torch.Generator().manual_seed(42))
    convs = sum(isinstance(m, ContinuousConv) for m in model.modules())
    group = DatasetGroup(split="train", cache_dir=None, **cfg["dataset"])
    dg = dict(pcfg["data_generator"], scale=[0.9, 0.9, 0.0])
    split = {k: v for k, v in dg.items() if k not in ("train", "valid",
                                                      "test")}
    batch_size, window = int(pcfg["batch_size"]), int(pcfg["windows"][0])
    loader = get_dataloader(group.train, batch_size=batch_size,
                            window=window, **split,
                            **dict(dg["train"], seed=0))
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in
                next(loader).items() if v is not None}
               for _ in range(steps + 1)]
    loader.close()
    loss = {k: get_loss(**v) for k, v in cfg["model"]["loss"].items()}
    step = make_train_step(model, loss, *make_optimizer(
        model, pcfg["optimizer"]), window=window)
    time_w = np.ones(window, np.float32)
    step(batches[0], time_w)
    zero_counts()                # the fp32 training path starts here
    torch.cuda.synchronize()
    t0 = time.time()
    for b in batches[1:]:
        step(b, time_w)
    torch.cuda.synchronize()
    step_s = (time.time() - t0) / steps
    got = counts()               # and ends here
    want = [steps * x for x in expected_train_launches(batch_size, window,
                                                       convs, 0)]
    print(f"  fp32 momentum train step (batch {batch_size}, window "
          f"{window}): {step_s:.4f} s over {steps} steps; launches {got} "
          f"(want {want})")
    check(got == want, f"fp32 train launches {got} == {want}")
    return step_s


def waterramps_shapes(cfg, sample, dev):
    """Phase 3's contract inputs on the bench scene's scale-0 all->all
    list: (a) the widest trunk conv, Cin 32 -> Cout 32, poly6; (b) the
    ASCC conv: symmetric, coincident points dropped, peak, Cin 32 -> 2."""
    from dmcf_tpu_torch.models.pbf import drop_coincident
    from dmcf_tpu_torch.ops import cconv, neighbors, windows
    from dmcf_tpu_torch.ops.sph import masked_positions

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
    idx, a, t = cconv.klist_geometry(nl, 2 * r0, ksize,
                                     window_fn=windows.get_window_func(
                                         cfg["window"]))
    feats = torch.randn((q, 32), generator=g).to(dev)
    w = (torch.randn((s_total * 32, 32), generator=g) * 0.05).to(dev)
    shapes["trunk"] = (idx, a, t, feats, w, ksize, None)
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
    return shapes


# the column kernel against the JAX package's solver at full size
# (tests/data/torch_column_ref.npz: 3 scenes of 9-12 particles, 100 frames
# of up to 10,000 projection iterations): the port sums each particle's
# pairs in another order than XLA, and the iterations carry the rounding
# on.  Measured on the CPU for a 12-particle scene over the same 100
# frames (python -m scripts.column_drift --n 10 --port): positions 6.7e-6,
# velocities 2.7e-3 (solver units, |v| <= 4.3; JAX against itself in
# another pair order 6.7e-6 and 2.8e-3); about 7 and 18 times that:
COLUMN_X_TOL = 5e-5
COLUMN_V_TOL = 5e-2
# the fixture's 42-particle scene, where the drift grows furthest: JAX
# drifts from itself under another pair order (the fixture's permuted run)
# by 1.3e-2 in position and 5.9 in velocity (|v| <= 20) over 100 frames,
# by 3.8e-6 and 1.4e-2 over the first 10 (scripts/column_drift.py; the
# port's plain version lies 4.5e-3 and 4.3 from JAX, 3.8e-6 and 1.1e-2).
# Held: the first COLUMN_EARLY frames within the tolerances above, all
# frames within twice JAX's own drift.
COLUMN_EARLY = 11
COLUMN40_X_TOL = 2.6e-2
COLUMN40_V_TOL = 12.0
COLUMN_SPLITS = ("train", "valid", "test")
COLUMN_ITERS = 10            # phase 15's run_train iterations
LIQUID_BLOCK = (22, 6, 22)   # phase 16's fluid block (particles an axis)
LIQUID_STEPS = 50
WBC_STEPS = 20
BASELINE_STEPS = 20
CANYON_STEPS = 3             # phase 19's timed canyon rollout (and warm-up)
CANYON_TRACK = 6             # phase 19's steps with each step's pair excess
CANYON_CROP = 8192           # the canyon protocol's contact crop
INFLOW_STEPS = 40            # phase 20's run_sample regime: 40 steps, an
INFLOW_EVERY = 10            # inflow event every 10 (4 events of 1,280)
INFLOW_CROP = 65536
INFLOW_HEIGHT = 0.8          # the emitter block 0.8 above the floor
PLAIN_CHUNK_ELEMS = 1 << 28  # the plain version's [Q, K, S] taps a chunk
#                              (1 GiB fp32)


def column_config(root, name="symnet.yml"):
    import yaml

    with open(os.path.join(root, "configs", "column", name)) as f:
        return yaml.safe_load(f)


def column_split(ds, split=None):
    """A column split's generator arguments as DatasetGroup merges them
    (with no split, the arguments the splits share)."""
    base = {k: v for k, v in ds.items()
            if k not in ("name", "type", "train", "valid", "test")}
    return {**ds[split], **base} if split else base


def column_ops(counts, iters, pairs, bcnt):
    """Floating-point operations the column solver's data needs, counted
    from ``csrc/column_sph.cu``'s arithmetic but only where the data needs
    it (the kernel itself does more: both spline arms of every pair, in or
    out of the support).  ``pairs`` [S, T, 4] are the kernel's counts of
    pairs in the spline's inner and outer arm, in the frame's viscosity
    step and over its projection iterations.  Every pair of a density sum
    costs its distance (1); a pair in the support adds only the arm it
    takes: density 8 (inner) or 7 (outer), viscosity 14 or 13, pressure
    gradient 10 or 9 (the same iteration's distances, not counted twice);
    a pair beyond the support adds nothing to any sum.  A frame adds 2 n +
    6 f per particle terms, an iteration 12 n + 7 f (n the scene's
    particles, f its fluid ones).  Additions and multiplications count one
    each and comparisons none, against the fp32 FMA rate: a lower bound."""
    n = np.asarray(counts, np.float64)[:, None]
    f = n - bcnt
    it = np.asarray(iters, np.float64)
    pr = np.asarray(pairs, np.float64)
    per_frame = n ** 2 + 22 * pr[..., 0] + 20 * pr[..., 1] + 2 * n + 6 * f
    per_iters = (it * (n ** 2 + 12 * n + 7 * f) + 18 * pr[..., 2]
                 + 16 * pr[..., 3])
    return float((per_frame + per_iters).sum())


def column_bound(counts, iters, pairs, bcnt, p):
    """(bound ms, by): the larger of the operations (``column_ops``) at
    the fp32 rate and the bytes (x0, v0, counts in; xs, vs, iters, pairs
    out) at HBM's rate."""
    ops = column_ops(counts, iters, pairs, bcnt)
    s, frames = np.shape(iters)
    nbytes = s * p * 8 + s * 4 + s * frames * (p * 8 + 4 + 16)
    t_ops, t_bytes = ops / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def support_share(counts, iters, pairs):
    """The share of all pairs of the density sums that lie in the
    spline's support (q <= 1)."""
    n2 = np.asarray(counts, np.float64)[:, None] ** 2
    pr = np.asarray(pairs, np.float64)
    return float(pr.sum() / (n2 * (1 + np.asarray(iters))).sum())


def column_phase(root, dev):
    """Phase 14: the column kernel (``csrc/column_sph.cu``) against its
    plain version on the card (4 scenes of 1-40 fluid particles, 5 frames,
    the full 10,000-iteration cap), against the JAX package's solver at
    full size (the fixture), two launches bitwise equal, then each split of
    ``configs/column/symnet.yml`` generated at its full size: time,
    projection iterations, bound."""
    from dmcf_tpu_torch.data.generators import column_problem
    from dmcf_tpu_torch.kernels.column_sph import (column_solve,
                                                   column_solve_reference)

    ds = column_config(root)["dataset"]
    base = column_split(ds)
    out = {}

    def on_card(problem):
        x0, v0, counts, kw = problem
        return [torch.as_tensor(a, device=dev) for a in (x0, v0, counts)], kw

    args, kw = on_card(column_problem(4, 5, pts_cnt=[1, 10, 25, 40],
                                      **base))
    got = column_solve(*args, **kw)
    torch.cuda.synchronize()
    t0 = time.time()
    ref = column_solve_reference(*args, **kw)
    torch.cuda.synchronize()
    out["plain_ms"] = 1e3 * (time.time() - t0)
    out["ms"] = cuda_ms(lambda: column_solve(*args, **kw), iters=3,
                        warmup=1)
    err = max(float((g - r).abs().max()) for g, r in zip(got[:2], ref[:2]))
    same = all(torch.equal(g, r) for g, r in zip(got, ref))
    iters, pairs = got[2].cpu().numpy(), got[3].cpu().numpy()
    out["bound_ms"], out["bound_by"] = column_bound(
        args[2].tolist(), iters, pairs, kw["bcnt"], args[0].shape[1])
    out["max_abs_err"] = err
    print(f"  4 scenes x 5 frames, iterations a frame {iters.tolist()}: "
          f"kernel {out['ms']:.3f} ms, plain version {out['plain_ms']:.1f} "
          f"ms, bound {out['bound_ms']:.6f} ms ({out['bound_by']}; the "
          f"solver is latency-bound), kernel vs plain max |diff| {err:.3e},"
          f" bitwise equal {same}")
    check(same and err == 0.0, "column kernel bitwise equal to its plain "
          "version (the same operations and pair-sum tree)")

    fx = np.load(os.path.join(root, "tests", "data",
                              "torch_column_ref.npz"))
    args, kw = on_card(column_problem(
        len(fx["pts_cnt"]), int(fx["timesteps"]), pts_cnt=fx["pts_cnt"],
        res=int(fx["res"]), gravity=float(fx["gravity"]),
        dt=float(fx["dt"]), max_iter=int(fx["max_iter"])))
    got = column_solve(*args, **kw)
    again = column_solve(*args, **kw)
    torch.cuda.synchronize()
    check(all(torch.equal(g, a) for g, a in zip(got, again)),
          "two column launches bitwise equal")
    t_, n_ = got[0].shape[1:]
    dx = float(np.abs(got[0].cpu().numpy() - fx["xs"][:, :t_, :n_]).max())
    dv = float(np.abs(got[1].cpu().numpy() - fx["vs"][:, :t_, :n_]).max())
    print(f"  against the JAX fixture ({len(fx['pts_cnt'])} scenes, "
          f"{int(fx['timesteps'])} frames, {int(got[2].sum())} "
          f"iterations): positions {dx:.3e} (tol {COLUMN_X_TOL:g}), "
          f"velocities {dv:.3e} (tol {COLUMN_V_TOL:g}); two launches "
          f"bitwise equal")
    check(dx <= COLUMN_X_TOL and dv <= COLUMN_V_TOL,
          f"column kernel vs JAX fixture {dx}, {dv}")
    out["fixture_err"] = [dx, dv]

    n40 = fx["xs40"].shape[1] - int(fx["obs_size"])
    args, kw = on_card(column_problem(
        1, int(fx["timesteps"]), pts_cnt=[n40], res=int(fx["res"]),
        gravity=float(fx["gravity"]), dt=float(fx["dt"]),
        max_iter=int(fx["max_iter"])))
    got = column_solve(*args, **kw)
    dx = np.abs(got[0][0].cpu().numpy() - fx["xs40"]).max(axis=1)
    dv = np.abs(got[1][0].cpu().numpy() - fx["vs40"]).max(axis=1)
    wx = np.abs(fx["xs40_perm"] - fx["xs40"]).max(axis=1)
    wv = np.abs(fx["vs40_perm"] - fx["vs40"]).max(axis=1)
    e = COLUMN_EARLY
    print(f"  the {n40 + int(fx['obs_size'])}-particle scene against JAX: "
          f"positions {dx.max():.3e}, velocities {dv.max():.3e} (first {e}"
          f" frames {dx[:e].max():.3e}, {dv[:e].max():.3e}); JAX against "
          f"itself in another pair order {wx.max():.3e}, {wv.max():.3e} "
          f"(first {e} frames {wx[:e].max():.3e}, {wv[:e].max():.3e})")
    check(dx[:e].max() <= COLUMN_X_TOL and dv[:e].max() <= COLUMN_V_TOL,
          f"column kernel vs JAX, 42 particles, first {e} frames "
          f"{dx[:e].max()}, {dv[:e].max()}")
    check(dx.max() <= COLUMN40_X_TOL and dv.max() <= COLUMN40_V_TOL,
          f"column kernel vs JAX, 42 particles {dx.max()}, {dv.max()}")
    out["fixture40_err"] = [float(dx.max()), float(dv.max())]

    out["splits"] = {}
    for split in COLUMN_SPLITS:
        cfg = column_split(ds, split)
        np.random.seed(cfg.pop("seed"))
        args, kw = on_card(column_problem(**cfg))
        torch.cuda.synchronize()
        t0 = time.time()
        xs, vs, it, pairs = column_solve(*args, **kw)
        torch.cuda.synchronize()
        sec = time.time() - t0
        it, pairs = it.cpu().numpy(), pairs.cpu().numpy()
        b_ms, b_by = column_bound(args[2].tolist(), it, pairs, kw["bcnt"],
                                  args[0].shape[1])
        share = support_share(args[2].tolist(), it, pairs)
        check(bool(torch.isfinite(xs).all() and torch.isfinite(vs).all()),
              f"finite {split} split")
        us_it = float(1e6 * sec / it.max(axis=0).sum())
        out["splits"][split] = dict(seconds=sec, iterations=int(it.sum()),
                                    bound_ms=b_ms, support_share=share,
                                    us_per_iteration=us_it)
        print(f"  symnet.yml {split}: {args[0].shape[0]} scenes x "
              f"{kw['timesteps']} frames in {sec:.3f} s, {int(it.sum())} "
              f"projection iterations ({it.mean():.1f} a frame, "
              f"{100 * (it == kw['max_iter']).mean():.1f} % of frames at "
              f"max_iter), {us_it:.3f} us an "
              f"iteration of the longest scene; {100 * share:.2f} % of "
              f"the pairs in the spline's support; bound {b_ms:.6f} ms "
              f"({b_by})")
    return out


def column_configs_phase(root, dev):
    """Phase 15: ``run_pipeline`` on the column configs on the card, data
    from the column kernel (``--dataset.cache_dir none``): symnet.yml
    trains COLUMN_ITERS iterations and then validates; hrnet.yml and
    symnet_wide.yml train one step each.  Every loss logged; whether the
    loss falls is reported, not checked.  Returns the launches of each
    kernel on this path."""
    from dmcf_tpu_torch import run_pipeline
    from dmcf_tpu_torch.kernels.column_sph import column_solve

    tmp = tempfile.TemporaryDirectory()
    out = {}

    def run(name, split, *extra):
        args = ["--cfg_file", os.path.join(root, "configs", "column", name),
                "--split", split, "--device", dev.type,
                "--dataset.cache_dir", "none",
                "--main_log_dir", os.path.join(tmp.name, "logs"),
                "--output_dir", os.path.join(tmp.name, "out"),
                "--pipeline.train_sum_dir", os.path.join(tmp.name, "sum"),
                *extra]
        torch.cuda.synchronize()
        t0 = time.time()
        res = run_pipeline.main(args)
        torch.cuda.synchronize()
        return res, time.time() - t0

    train_args = ("--pipeline.max_epoch", "0", "--pipeline.log_every", "1",
                  "--pipeline.run_valid_every_epoch", "false",
                  "--pipeline.run_test_every_epoch", "false")
    column_solve.launches = 0
    zero_counts()                # the column path starts here
    # DatasetGroup makes all three splits; a split the run does not read
    # is cut to 2 frames (the kernel still makes it)
    logged, sec = run("symnet.yml", "train", "--pipeline.iter",
                      str(COLUMN_ITERS), "--dataset.test.timesteps", "2",
                      *train_args)
    losses = [e["loss"] for e in logged]
    print(f"  symnet.yml train: {len(losses)} iterations in {sec:.3f} s "
          f"(the kernel makes the splits first)")
    print("  losses " + " ".join(f"{v:.6e}" for v in losses))
    print(f"  loss of the last 5 iterations / the first 5: "
          f"{np.mean(losses[-5:]) / np.mean(losses[:5]):.4f}")
    check(len(losses) == COLUMN_ITERS and all(np.isfinite(losses)),
          "finite column train losses")
    valid, sec = run("symnet.yml", "valid", "--dataset.train.timesteps",
                     "2", "--dataset.test.timesteps", "2")
    print(f"  symnet.yml valid in {sec:.3f} s: " + ", ".join(
        f"{k} {v:.4e}" for k, v in valid.items()
        if isinstance(v, float)))
    check(all(np.isfinite(v) for v in valid.values()
              if isinstance(v, float)), "finite column valid metrics")
    out["launches"] = counts()
    out["column_launches"] = column_solve.launches   # and ends here
    print(f"  launches on this path: column_sph {out['column_launches']}, "
          f"K-list (fp32, bf16) fwd {out['launches'][0:2]} bwd_data "
          f"{out['launches'][2:4]} bwd_filter {out['launches'][4:6]}")
    check(out["column_launches"] == 2 * len(COLUMN_SPLITS),
          f"column kernel launches {out['column_launches']}")
    check(all(out["launches"]), f"every K-list variant launched on the "
          f"column path {out['launches']}")
    for name in ("hrnet.yml", "symnet_wide.yml"):
        logged, sec = run(name, "train", "--pipeline.iter", "1",
                          "--dataset.valid.timesteps", "2",
                          "--dataset.test.timesteps", "2", *train_args)
        print(f"  {name}: one train step, loss {logged[0]['loss']:.6e} "
              f"({sec:.3f} s with its data)")
        check(len(logged) == 1 and np.isfinite(logged[0]["loss"]),
              f"{name} train step")
    tmp.cleanup()
    out["losses"] = losses
    return out


def liquid_scene(shape=LIQUID_BLOCK, spacing=0.05, seed=0):
    """A block of fluid at the DeepLagrangianFluids spacing (0.05, particle
    radius 0.025), ``shape`` particles an axis with a 1 % jitter, resting
    in an open box of boundary particles at the same spacing (a floor one
    spacing below the block, four walls one spacing outside it, as high as
    the block).  Returns (pos, box, box_normals) fp32."""
    rng = np.random.RandomState(seed)
    nx, ny, nz = shape
    axes = [np.arange(n) * spacing for n in shape]
    pos = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    pos = pos + rng.normal(scale=spacing * 0.01, size=pos.shape)
    bx = np.arange(-1, nx + 1) * spacing
    bz = np.arange(-1, nz + 1) * spacing
    by = np.arange(0, ny + 1) * spacing
    fx, fz = np.meshgrid(bx, bz, indexing="ij")
    parts = [np.stack([fx.ravel(), np.full(fx.size, -spacing), fz.ravel()],
                      -1)]
    nrms = [np.tile([0.0, 1.0, 0.0], (fx.size, 1))]
    yy, zz = np.meshgrid(by, bz, indexing="ij")
    for x, n in ((bx[0], 1.0), (bx[-1], -1.0)):
        parts.append(np.stack([np.full(yy.size, x), yy.ravel(), zz.ravel()],
                              -1))
        nrms.append(np.tile([n, 0.0, 0.0], (yy.size, 1)))
    xx, yy = np.meshgrid(bx[1:-1], by, indexing="ij")
    for z, n in ((bz[0], 1.0), (bz[-1], -1.0)):
        parts.append(np.stack([xx.ravel(), yy.ravel(), np.full(xx.size, z)],
                              -1))
        nrms.append(np.tile([0.0, 0.0, n], (xx.size, 1)))
    return (pos.astype(np.float32), np.concatenate(parts).astype(np.float32),
            np.concatenate(nrms).astype(np.float32))


def plain_chunked(args, kw):
    """The plain version over slices of the queries, each with at most
    PLAIN_CHUNK_ELEMS taps (its [Q, K, S] transient); rows are independent,
    so the values are the unchunked version's."""
    from dmcf_tpu_torch.kernels.cconv_klist import cconv_klist_reference
    idx, a, t, feats, w, ks = args
    qf = kw.get("qfeats")
    q, k = idx.shape
    qc = max(1, PLAIN_CHUNK_ELEMS // (k * int(np.prod(ks))))
    return torch.cat([cconv_klist_reference(
        idx[s:s + qc], a[s:s + qc], t[s:s + qc], feats, w, ks,
        qfeats=None if qf is None else qf[s:s + qc],
        precision=kw["precision"], interpolation=kw["interpolation"])
        for s in range(0, q, qc)])


def launch_checks(log, what, max_err, show=True):
    """Every logged K-list launch against its plain version (fwd_check;
    chunked over queries, ``plain_chunked``); with ``show`` prints each
    launch's shape.  Updates max_err {bf16: err}."""
    with torch.no_grad():
        for name, args, kw, out in log:
            err = fwd_check(f"{what} {name}", out, plain_chunked(args, kw),
                            kw)
            max_err[bf16(kw)] = max(max_err[bf16(kw)], err)
            idx_, _, _, f_, w_, ks_ = args
            if show:
                print(f"    {name:12s} Q {idx_.shape[0]:4d} K "
                      f"{idx_.shape[1]:4d} N {f_.shape[0]:4d} Cin "
                      f"{f_.shape[1]:2d} Cout {w_.shape[1]:2d} S "
                      f"{int(np.prod(ks_)):3d} "
                      f"{'bf16' if bf16(kw) else 'fp32'} sym "
                      f"{kw['qfeats'] is not None:d}: max_abs_err {err:.3e}")


def train_step_phase(root, cfg_path, dev, model, sample, what,
                     batch_size=None, step0_free=2, cpu_check=False):
    """One train step at the config's batch (or ``batch_size``: its items
    are copies of one sequence) and first window (its first curriculum
    stage, the model's precision) on a sequence the port's rollout makes
    from ``sample``, its targets moved by seeded noise of 1e-3 (else every
    residual is 0): time, peak device memory, a finite loss and gradients,
    each K-list variant's and the FPS kernel's launches counted exactly
    against the forward launches of one step of ``model`` on ``sample``
    (``expected_train_launches`` with ``step0_free``; FPS twice an item a
    window step).  With ``cpu_check`` the step also runs on a CPU copy of
    ``model`` made before it: the loss within 1e-4 and every parameter's
    gradient within GRAD_TOL of that tensor's largest CPU element."""
    import yaml

    from dmcf_tpu_torch.models.losses import get_loss
    from dmcf_tpu_torch.pipelines.simulator import (make_optimizer,
                                                    make_train_step)
    from dmcf_tpu_torch.rollout import rollout

    with open(os.path.join(root, "configs", cfg_path)) as f:
        cfg = yaml.safe_load(f)
    batch_size = batch_size or int(cfg["pipeline"]["batch_size"])
    window = int(cfg["pipeline"]["windows"][0])
    cpu_model = copy.deepcopy(model).to("cpu") if cpu_check else None
    zero_counts()
    with torch.no_grad():
        model(sample)
    fwd, fps_fwd = counts()[:2], fps_launches()   # one forward step's
    n = sample["pos"].shape[0]
    frames = (torch.empty((window + 1, n, 3), device=dev),
              torch.empty((window + 1, n, 3), device=dev))
    rollout(model, sample, window, frames=frames)
    jitter = np.random.RandomState(0).normal(
        scale=1e-3, size=(window, n, 3)).astype(np.float32)
    frames[0][1:] += torch.from_numpy(jitter).to(dev) \
        * sample["fluid_mask"][:, None]
    batch = {"pos": frames[0], "vel": frames[1]}
    if sample.get("grav") is not None:
        batch["grav"] = sample["grav"].expand(window + 1, n, 3)
    batch = {k: v[None].expand(batch_size, *v.shape).contiguous()
             for k, v in batch.items()}
    for k in ("box", "box_normals", "fluid_mask", "box_mask"):
        batch[k] = sample[k][None].expand(batch_size, *sample[k].shape)
    batch["pre"] = torch.zeros(batch_size, dtype=torch.int32, device=dev)
    loss = {k: get_loss(**v) for k, v in cfg["model"]["loss"].items()}
    steps = [make_train_step(m, loss, *make_optimizer(
        m, cfg["pipeline"]["optimizer"]), window=window)
        for m in (model, cpu_model) if m is not None]
    time_w = np.ones(window, np.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    from dmcf_tpu_torch.kernels.cconv_klist import cconv_klist_bwd_data
    cconv_klist_bwd_data.workspace_peak = 0
    zero_counts()                # this training path starts here
    t0 = time.time()
    lvec, _, stats = steps[0](batch, time_w)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = counts() + [fps_launches()]          # and ends here
    peak = torch.cuda.max_memory_allocated(dev)
    want = expected_train_launches(batch_size, window, sum(fwd), fwd[1],
                                   step0_free=step0_free) \
        + [2 * batch_size * window * fps_fwd]
    print(f"  {what} train step, batch {batch_size} x window {window}, "
          f"{n} fluid rows: {seconds:.3f} s, peak memory allocated "
          f"{peak / 2 ** 30:.3f} GiB, loss {float(lvec.sum()):.6e}, "
          f"pair_overflow {float(stats['pair_overflow']):.0f}; launches "
          f"(fp32, bf16) fwd {launches[0:2]} bwd_data {launches[2:4]} "
          f"bwd_filter {launches[4:6]} fps {launches[6]} (want {want}: "
          f"{fwd} K-list and {fps_fwd} FPS launches a forward step); "
          f"largest data-kernel workspace "
          f"{cconv_klist_bwd_data.workspace_peak} B")
    check(bool(torch.isfinite(lvec).all()), f"finite {what} loss")
    check(launches == want, f"{what} train launches {launches}")
    check(all(bool(torch.isfinite(p.grad).all())
              for p in model.parameters() if p.grad is not None),
          f"finite {what} gradients")
    out = {"launches": launches, "seconds": seconds, "peak_bytes": peak}
    if cpu_model is None:
        return out
    lc, _, _ = steps[1]({k: v.cpu() for k, v in batch.items()}, time_w)
    close(lvec.sum(), lc.sum(), 1e-4, 0.0, f"{what} train loss")
    worst, zero = 0.0, []
    for (name, pg), (_, pc) in zip(model.named_parameters(),
                                   cpu_model.named_parameters()):
        check(pg.grad is not None and pc.grad is not None,
              f"{what} {name}: a gradient")
        scale = float(pc.grad.abs().max())
        err = float((pg.grad.cpu() - pc.grad).abs().max())
        check(err <= GRAD_TOL * scale,
              f"{what} {name}: grad card vs CPU {err} > {GRAD_TOL} x {scale}")
        worst = max(worst, err / scale if scale else err)
        if scale == 0:
            zero.append(name)
    print(f"  gradients card vs CPU within {worst:.2e} of each tensor's max "
          f"(tol {GRAD_TOL}); zero gradients: {zero}")
    return dict(out, grad_rel_err=worst)


def gated_rollout(model, sample, steps, what, log, fps_per_step=0,
                  momentum=False):
    """A rollout phase's main path: a ``steps``-step rollout
    (``bench.timed_rollout``) under the exactness gate, finite fluid rows,
    its peak memory, the K-list launches (fp32, bf16) counted exactly
    against the recorded step ``log`` and the FPS launches against
    ``fps_per_step``; with ``momentum``, the ASCC output's momentum ratio
    |sum out| / sum |out| after it (below 1e-5)."""
    from dmcf_tpu_torch.bench import timed_rollout
    from dmcf_tpu_torch.profile_step import record_launches

    dev = sample["pos"].device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()                # the rollout starts here
    pos, vel, gate, dt = timed_rollout(model, sample, steps)
    launches = counts()[:2] + [fps_launches()]      # and ends here
    peak = torch.cuda.max_memory_allocated(dev)
    ms = 1e3 * dt / steps
    want = [steps * x for x in counts_of(log)] + [steps * fps_per_step]
    print(f"  {steps}-step rollout: {ms:.3f} ms/step, peak "
          f"{peak / 2 ** 30:.3f} GiB, gate {gate}, launches K-list (fp32, "
          f"bf16) and FPS {launches} (want {want})")
    check(bool(torch.isfinite(pos[sample["fluid_mask"]]).all()),
          f"finite {what} rollout")
    check(gate["exact"], f"{what} exactness gate {gate}")
    check(launches == want, f"{what} rollout launches {launches}")
    ratio = None
    if momentum:
        _, end_log = record_launches(model, dict(sample, pos=pos, vel=vel))
        sym = [o for n_, _, _, o in end_log if n_ == "sym_conv0"][0]
        ratio = float((sym.sum(0).abs() / sym.abs().sum()).max())
        print(f"  ASCC output after the rollout: |sum out| / sum |out| "
              f"{ratio:.3e} (< 1e-5)")
        check(ratio < 1e-5, f"{what} ASCC momentum ratio {ratio}")
    return {"launches": launches, "ms_per_step": ms, "peak_bytes": peak,
            "gate": gate, "momentum_ratio": ratio,
            "end": dict(sample, pos=pos, vel=vel)}


def dropped(counts, caps):
    """The share of each pyramid scale's stamped voxels that its cap
    drops."""
    return [round(max(0.0, 1.0 - int(cap) / int(c)), 4) if int(c) else 0.0
            for c, cap in zip(counts, caps)]


def liquid3d_phase(root, dev, max_err):
    """Phase 16: ``configs/Liquid3d.yml`` at full width (its precision, a
    bf16 trunk; seed-0 weights) on ``liquid_scene``: every K-list launch
    of the first step against its plain version (K up to 1856 in chunks
    of ``conv_k_chunk`` 352, the symmetric 6x6x6 ASCC conv), a
    LIQUID_STEPS-step rollout under the exactness gate with each
    variant's launches counted, the ASCC momentum ratio after it, and one
    train step at the config's batch 8, window 2."""
    import yaml

    from dmcf_tpu_torch.models import build_model
    from dmcf_tpu_torch.profile_step import record_launches
    from dmcf_tpu_torch.scene import bench_sample

    with open(os.path.join(root, "configs", "Liquid3d.yml")) as f:
        cfg = yaml.safe_load(f)["model"]
    pos, box, nrm = liquid_scene()
    sample = bench_sample(pos, box, nrm, device=dev)
    rows = sample["pos"].shape[0] + sample["box"].shape[0]
    print(f"  scene: {len(pos)} fluid (block {LIQUID_BLOCK}) + {len(box)} "
          f"boundary particles at spacing 0.05, {rows} rows")
    check(rows <= 5400, f"{rows} rows")
    model = build_model(cfg, device=dev,
                        generator=torch.Generator().manual_seed(0))
    zero_counts()
    (p1, _, aux), log = record_launches(model, sample)
    torch.cuda.synchronize()
    step = counts()[:2]
    ks = [args[0].shape[1] for _, args, _, _ in log]
    print(f"  first step: K-list launches (fp32, bf16) {step}, slots a "
          f"launch {ks}; pair excess {dict((k, int(v)) for k, v in aux['pair_overflow_detail'].items())}")
    launch_checks(log, "liquid3d", max_err)
    per_conv = {}
    for n_, a_, _, _ in log:
        per_conv[n_] = per_conv.get(n_, 0) + 1
    chunked = {n_: c for n_, c in per_conv.items() if c > 1}
    wide = [k for k in ks if k > int(cfg["conv_k_chunk"])]
    check(not wide, f"every launch at most conv_k_chunk slots: {wide}")
    check(6 in chunked.values(), f"the K-1856 pair in 6 launches: {chunked}")
    check(sum(1 for n_, a_, _, _ in log if n_ == "sym_conv0"
              and int(np.prod(a_[5])) == 216 and a_[0].shape[1] == 96) == 1,
          "one symmetric S 216 ASCC launch")
    print(f"  convs chunked over K (launches): {chunked}")
    run = gated_rollout(model, sample, LIQUID_STEPS, "Liquid3d", log,
                        momentum=True)
    gate = run["gate"]
    # a scale over its cap drops voxels (the JAX package's pyramid counts
    # the same on this scene: scripts/liquid_pyramid.py); these timings
    # are those of the pyramid so cut, not of the uncut model
    print(f"  voxels dropped a scale: first step "
          f"{dropped(aux['scale_counts'], aux['scale_caps'])}, most over "
          f"the rollout {dropped(gate['scale_counts'], gate['scale_caps'])}"
          f" (scales_fit {gate['scales_fit']})")
    train = train_step_phase(root, "Liquid3d.yml", dev, model, sample,
                             "Liquid3d")
    return {"step": step, "rollout_launches": run["launches"],
            "train": train, "ms_per_step": run["ms_per_step"], "gate": gate,
            "dropped": dropped(gate["scale_counts"], gate["scale_caps"])}


def turn(sample, degrees):
    """The sample turned by ``degrees`` in the x-y plane (positions of the
    fluid rows, boundary, normals, gravity, velocities)."""
    a = np.deg2rad(degrees)
    rot = torch.tensor([[np.cos(a), np.sin(a), 0.0],
                        [-np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0]],
                       dtype=torch.float32, device=sample["pos"].device)
    s = dict(sample)
    fm = s["fluid_mask"][:, None]
    s["pos"] = torch.where(fm, sample["pos"] @ rot, sample["pos"])
    for k in ("vel", "grav", "box", "box_normals"):
        s[k] = sample[k] @ rot
    return s, rot


def wbc_phase(root, dev):
    """Phase 17: ``configs/WBC-SPH.yml`` (``grav_eqvar``) at full width on
    ``scene.build_scene`` at the config's spacing (0.005, the fluid
    jittered by a fifth of it): a WBC_STEPS
    rollout with gravity along -y and one of the whole scene and its
    gravity turned by 30 degrees, both under the exactness gate.  At
    precision "highest" the first steps' outputs agree within phase 7's
    fp32 tolerances (the position correction, in the model's frame, 1e-4
    of its max; positions turned back 1e-6): ``grav_eqvar`` turns both
    scenes into one frame before the network; at the config's own precision (a bf16 trunk) the
    differences are reported, and for both the rollouts' final
    positions."""
    import yaml

    from dmcf_tpu_torch.models import build_model
    from dmcf_tpu_torch.rollout import rollout
    from dmcf_tpu_torch.scene import bench_sample, build_scene

    with open(os.path.join(root, "configs", "WBC-SPH.yml")) as f:
        cfg = yaml.safe_load(f)["model"]
    pos, box, nrm = build_scene(spacing=0.005)
    # jittered by 0.2 spacing: on the near-lattice the ASCC output cancels
    # to rounding level (~1e-6 of its terms), and a relative comparison of
    # it would read rounding
    pos[:, :2] += np.random.RandomState(1).normal(
        scale=0.001, size=pos[:, :2].shape).astype(np.float32)
    upright = bench_sample(pos, box, nrm, device=dev)
    turned, rot = turn(upright, 30.0)
    fm = upright["fluid_mask"]
    out = {}
    for prec in ("highest", cfg.get("precision", "default")):
        model = build_model(dict(cfg, precision=prec), device=dev,
                            generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            pu, _, au = model(upright)
            pt, _, at = model(turned)
        # the position correction is the network's output in the frame
        # grav_eqvar turns every scene into: compared as it is
        pc_u = au["pos_correction"][fm]
        pc_t = at["pos_correction"][fm]
        scale = float(pc_u.abs().max())
        d_pc = float((pc_t - pc_u).abs().max())
        d_pos = float((pt[fm] @ rot.T - pu[fm]).abs().max())
        zero_counts()
        t0 = time.time()
        ru, _, gu = rollout(model, upright, WBC_STEPS)
        rt, _, gt = rollout(model, turned, WBC_STEPS)
        torch.cuda.synchronize()
        launches = counts()[:2]
        d_roll = float((rt[fm] @ rot.T - ru[fm]).abs().max())
        print(f"  precision {prec}: first step, turned vs upright: "
              f"pos_correction (the model's frame) {d_pc:.3e} of max "
              f"{scale:.3e}, positions turned back "
              f"{d_pos:.3e}; {WBC_STEPS}-step rollouts "
              f"({1e3 * (time.time() - t0) / (2 * WBC_STEPS):.3f} ms/step, "
              f"launches {launches}): final positions {d_roll:.3e}; gates "
              f"{gu} / {gt}")
        check(gu["exact"] and gt["exact"], f"WBC-SPH gates {gu} {gt}")
        check(bool(torch.isfinite(ru[fm]).all() and
                   torch.isfinite(rt[fm]).all()), "finite WBC rollouts")
        if prec == "highest":
            check(scale > 0 and d_pc <= 1e-4 * scale and d_pos <= 1e-6,
                  f"grav_eqvar at highest: {d_pc} of {scale}, {d_pos}")
        out[prec] = dict(d_pc=d_pc, scale=scale, d_pos=d_pos,
                         d_roll=d_roll, launches=launches)
    return out


def baselines_phase(root, dev, max_err):
    """Phase 18: the baselines of ``configs/other`` at full width (their
    precision, seed-0 weights): CConv 2D on the bench scene, CConv 3D on
    ``liquid_scene`` at spacing 0.055 (at 0.05 its radius, 0.1125, holds
    57 lattice points at rest against a K of 64), PointNet on the bench scene at spacing 0.008 (off
    its 0.01 radius: its pooling has no window, so neighbours exactly at
    the radius would count by rounding).  Each rolls out BASELINE_STEPS
    steps under the exactness gate; CConv's K-list launches of its first
    step are held against the plain version; each model's step on a small
    scene is held against the CPU path (the position correction 1e-4 of
    its max, positions 1e-6)."""
    import yaml

    from dmcf_tpu_torch.models import build_model
    from dmcf_tpu_torch.profile_step import record_launches
    from dmcf_tpu_torch.rollout import rollout
    from dmcf_tpu_torch.scene import bench_sample, build_scene

    cases = [("cconv.yml", lambda n=None: build_scene(n or 2304)),
             ("cconv3d.yml", lambda n=None: liquid_scene(
                 (6, 6, 6) if n else LIQUID_BLOCK, spacing=0.055)),
             ("pointnet.yml", lambda n=None: build_scene(n or 2304,
                                                         spacing=0.008))]
    out = {}
    for name, scene in cases:
        with open(os.path.join(root, "configs", "other", name)) as f:
            cfg = yaml.safe_load(f)["model"]
        model = build_model(cfg, device=dev,
                            generator=torch.Generator().manual_seed(0))
        sample = bench_sample(*scene(), device=dev)
        zero_counts()
        _, log = record_launches(model, sample)
        step = counts()[:2]
        if log:
            launch_checks(log, name, max_err)
        zero_counts()            # this baseline's rollout starts here
        t0 = time.time()
        p, _, gate = rollout(model, sample, BASELINE_STEPS)
        torch.cuda.synchronize()
        sec = time.time() - t0
        launches = counts()[:2]  # and ends here
        fm = sample["fluid_mask"]
        small = scene(64)
        s_gpu = bench_sample(*small, device=dev)
        s_cpu = bench_sample(*small, device="cpu")
        cpu_model = copy.deepcopy(model).to("cpu")
        with torch.no_grad():
            pg, _, ag = model(s_gpu)
            pc, _, ac = cpu_model(s_cpu)
        scale = float(ac["pos_correction"].abs().max())
        diff = float((ag["pos_correction"].cpu()
                      - ac["pos_correction"]).abs().max())
        d_pos = float((pg.cpu() - pc).abs().max())
        print(f"  {name}: {BASELINE_STEPS} steps {1e3 * sec / BASELINE_STEPS:.3f}"
              f" ms/step, gate {gate}, K-list launches (fp32, bf16) "
              f"{launches} ({step} a step); small scene card vs CPU: "
              f"pos_correction {diff:.3e} of max {scale:.3e}, positions "
              f"{d_pos:.3e}")
        check(gate["exact"], f"{name} exactness gate {gate}")
        check(bool(torch.isfinite(p[fm]).all()), f"finite {name} rollout")
        check(launches == [BASELINE_STEPS * x for x in step],
              f"{name} launches {launches}")
        check(scale > 0 and diff <= 1e-4 * scale and d_pos <= 1e-6,
              f"{name} card vs CPU {diff} of {scale}, {d_pos}")
        out[name] = dict(launches=launches, step=step)
    check(out["cconv.yml"]["step"] == [0, 5] and
          out["pointnet.yml"]["step"] == [0, 0],
          "CConv: 5 bf16 K-list launches a step (2 scale-0, 3 layers); "
          "PointNet none")
    return out


def search_ran(nl, method):
    """Which search produced the neighbor list ``nl`` (``method`` the one
    asked for): cell and grid lists carry ``cell_overflow``, the dense
    list keeps ``disp``, the chunked running top-K neither."""
    if nl.cell_overflow is not None:
        return "grid" if method == "grid" else "cell"
    return "dense" if nl.disp is not None else "chunked top-K"


def same_sets(a, b):
    """Whether two neighbor lists hold the same neighbour set per query
    (order aside) and the same counts."""
    def rows(nl):
        return torch.sort(torch.where(nl.mask, nl.idx, -1), dim=1).values
    return torch.equal(a.count, b.count) and torch.equal(rows(a), rows(b))


def canyon_phase(root, dev, max_err):
    """Phase 19: the root bench's canyon protocol on a generated scene of
    the canyon's size and contact load (``scene.canyon_frame``: 1,280
    fluid resting on the terrain, 185,436 boundary, 6,126 of them in
    contact) with ``configs/Liquid3d.yml`` at full width,
    ``CANYON_OVERRIDES`` and a contact crop of 8192.  The first step: each
    trunk pair's search and its time, every K-list launch against its plain
    version, the scale-0 pair's cell search on the card against the
    chunked top-K on the card and the cell search on the CPU, the contact
    counts card against CPU.  Then each step's worst pair excess over
    CANYON_TRACK steps (printed: under random weights the fluid falls into
    the floor and the budgets pass from step 4 or 5 on the CPU, in JAX as in
    the port, ``scripts/canyon_budget.py``), ``bench_canyon``'s warm-up and
    timed rollouts of CANYON_STEPS steps, a horizon over which JAX and the
    port are exact, under the exact gate (launches counted), the step's
    device time and busy share, and lazy dense pairs against eager ones on
    the bench scene."""
    from dmcf_tpu_torch.bench import (CANYON_BOOST, bench_canyon,
                                      canyon_exact, canyon_model)
    from dmcf_tpu_torch.models import pbf as pbf_mod
    from dmcf_tpu_torch.ops import neighbors
    from dmcf_tpu_torch.ops.cell_search import contact_weight_dense
    from dmcf_tpu_torch.profile_step import record_launches, trace
    from dmcf_tpu_torch.run_sample import scene_sample
    from dmcf_tpu_torch.scene import canyon_frame

    frame = canyon_frame()
    model = canyon_model(CANYON_CROP, dev)
    sample, _, _, box = scene_sample(model, frame, vel=CANYON_BOOST,
                                     device=dev, log=lambda m: None)
    print(f"  scene: {len(frame['pos'])} fluid, {len(box)} boundary; crop "
          f"{CANYON_CROP}, {model.precision} trunk")
    searches = []
    search = pbf_mod.search

    def timed_search(points, queries, radius, k, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nl = search(points, queries, radius, k, **kw)
        torch.cuda.synchronize()
        over = nl.cell_overflow
        searches.append((points.shape[0], queries.shape[0], radius, k,
                         search_ran(nl, kw["method"]),
                         1e3 * (time.perf_counter() - t0),
                         (0, 0) if over is None else
                         (int(over.max()), int((over > 0).sum()))))
        return nl

    pbf_mod.search = timed_search
    try:
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (_, _, aux), log = record_launches(model, sample)
        torch.cuda.synchronize()
        first_ms = 1e3 * (time.perf_counter() - t0)
        step = counts()[:2]
    finally:
        pbf_mod.search = search
    for n, q, r, k, how, ms, (over, n_over) in searches:
        print(f"  search N {n:6d} x Q {q:6d} r {r:g} K {k:4d}: {how}, "
              f"{ms:.3f} ms" + (f"; window overflow up to {over} rows at "
                                f"{n_over} queries" if n_over else ""))
    search_ms = sum(x[5] for x in searches)
    excess = {k: int(v) for k, v in aux["pair_overflow_detail"].items()}
    print(f"  first step {first_ms:.1f} ms (searches {search_ms:.1f} ms), "
          f"K-list launches (fp32, bf16) {step}; pair excess {excess}; "
          f"cell_overflow {int(aux.get('cell_overflow', -1))}; in contact "
          f"{int(aux['boundary_crop_count'])}")
    check(any(x[4] == "cell" for x in searches), "a cell search ran")
    launch_checks(log, "canyon", max_err)

    with torch.no_grad():
        data, _ = model.transform(sample)
        ctx = model.preprocess(data)
        all_pos, all_mask = ctx["all_pos"], ctx["all_mask"]
        r0, k0 = model._radii[0], model.neighbor_k
        occ = model.occ_for_radius(r0)
        kw = dict(points_mask=all_mask, queries_mask=all_mask)
        got = {}
        # the chunked running top-K is what search_method "brute" runs
        # past 8192 rows; fast_path_max 0 names it whatever the size
        for how, fn in (
                ("cell", lambda: neighbors.search(
                    all_pos, all_pos, r0, k0, method="cell", occ_cap=occ,
                    **kw)),
                ("brute", lambda: neighbors.fixed_radius_search(
                    all_pos, all_pos, r0, k0, fast_path_max=0, **kw))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got[how] = fn()
            torch.cuda.synchronize()
            got[how + "_ms"] = 1e3 * (time.perf_counter() - t0)
        cpu = neighbors.search(all_pos.cpu(), all_pos.cpu(), r0, k0,
                               method="cell", occ_cap=occ,
                               points_mask=all_mask.cpu(),
                               queries_mask=all_mask.cpu())
        cell, brute = got["cell"], got["brute"]
        exact = cell.cell_overflow == 0   # the queries the windows held
        sub = [nl._replace(idx=nl.idx[exact], mask=nl.mask[exact],
                           count=nl.count[exact]) for nl in (cell, brute)]
        lost = int((brute.count - cell.count)[~exact].sum())
        print(f"  scale-0 pair {all_pos.shape[0]} x {all_pos.shape[0]}: "
              f"cell (occ_cap {occ}) {got['cell_ms']:.3f} ms, chunked "
              f"top-K {got['brute_ms']:.3f} ms; max count "
              f"{int(brute.count.max())} of K {k0}; window overflow at "
              f"{int((~exact).sum())} queries (up to "
              f"{int(cell.cell_overflow.max())} rows), {lost} neighbours "
              f"lost there")
        check(int(brute.count.max()) <= k0, "no scale-0 K overflow")
        check(same_sets(*sub), "card cell search = card chunked top-K "
              "(sets, counts) wherever no window overflowed")
        check(bool((cell.count <= brute.count).all()),
              "an overflowed window only loses neighbours")
        check(torch.equal(cell.idx.cpu(), cpu.idx)
              and torch.equal(cell.mask.cpu(), cpu.mask)
              and torch.equal(cell.count.cpu(), cpu.count)
              and torch.equal(cell.cell_overflow.cpu(), cpu.cell_overflow),
              "card cell search = CPU cell search")
        for wide in (64, 128, 256, 512, 1024):   # the budget that holds all
            nl = neighbors.search(all_pos, all_pos, r0, k0, method="cell",
                                  occ_cap=wide, **kw)
            if int(nl.cell_overflow.max()) == 0:
                break
        print(f"  occ_cap {wide}: no window overflow, equal to the chunked "
              f"top-K {same_sets(nl, brute)}")
        check(int(nl.cell_overflow.max()) == 0 and same_sets(nl, brute),
              f"cell search at occ_cap {wide} = chunked top-K")
        n_fluid = ctx["n_fluid"]
        fpos, fmask = all_pos[:n_fluid], data["fluid_mask"].bool()
        ext = ctx["filter_extent"][-1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w_card = contact_weight_dense(fpos, data["box"], ext,
                                      points_mask=fmask,
                                      queries_mask=data["box_mask"])
        torch.cuda.synchronize()
        contact_ms = 1e3 * (time.perf_counter() - t0)
        w_cpu = contact_weight_dense(fpos.cpu(), data["box"].cpu(), ext,
                                     points_mask=fmask.cpu(),
                                     queries_mask=data["box_mask"].cpu())
        print(f"  contact counts over {data['box'].shape[0]} boundary rows"
              f": {contact_ms:.3f} ms on the card, {int((w_card > 0).sum())}"
              f" in contact, card = CPU {torch.equal(w_card.cpu(), w_cpu)}")
        check(torch.equal(w_card.cpu(), w_cpu), "contact counts card = CPU")
        check(int((w_card > 0).sum()) == int(aux["boundary_crop_count"]),
              "contact count = the step's boundary_crop_count")

    with torch.no_grad():
        s, worst = dict(sample), []
        for _ in range(CANYON_TRACK):
            s["pos"], s["vel"], a = model(s)
            worst.append(int(a["pair_overflow"]))
    first = next((t for t, w in enumerate(worst) if w > 0), None)
    print(f"  worst pair excess a step over {CANYON_TRACK} steps {worst}: "
          f"first step past a budget {first} (the CPU: 4 with these "
          f"weights, 5 in JAX and the port with JAX's)")

    zero_counts()                # the canyon rollouts start here
    res = bench_canyon(frame, steps=CANYON_STEPS, crop=CANYON_CROP,
                       device=dev, model=model)
    launches = counts()[:2]      # and end here
    print(f"  bench_canyon: {res['ms_per_step']:.3f} ms/step over "
          f"{CANYON_STEPS} steps, gate pair_overflow {res['pair_overflow']}"
          f" max_neighbors {res['max_neighbors']} (K {res['neighbor_k']}) "
          f"contact {res['boundary_contact_count']} (crop "
          f"{res['boundary_crop']}) cell_overflow {res['cell_overflow']} "
          f"finite {res['finite']}; scales {res['scale_counts']} caps "
          f"{res['scale_caps']}; launches {launches}")
    check(canyon_exact(res) and res["finite"], f"canyon gate {res}")
    check(launches == [2 * CANYON_STEPS * x for x in step]
          and min(launches) > 0, f"canyon launches {launches}")
    with torch.no_grad():
        tr = trace(lambda: model(sample), reps=3, top=8)
    share = (search_ms + contact_ms) / first_ms
    print(f"  device {tr['device_ms_per_step']:.3f} ms a step in "
          f"{tr['kernel_launches_per_step']} launches, busy share "
          f"{tr['device_busy_share']:.3f} of "
          f"{tr['profiled_ms_per_step']:.3f} ms; searches + contact count "
          f"{search_ms + contact_ms:.1f} ms of the first step's "
          f"{first_ms:.1f} ({share:.3f})")
    for r in tr["top_kernels"]:
        print(f"    {r['device_us_per_step']:10.1f} us "
              f"{r['calls_per_step']:6d}x  {r['name'][:90]}")
    lazy = lazy_dense_check(root, dev)
    return {"step": step, "launches": launches, "result": res,
            "worst_excess": worst, "searches": searches, "lost": lost,
            "occ_exact": wide,
            "search_ms": search_ms, "contact_ms": contact_ms,
            "first_ms": first_ms, "trace": {k: tr[k] for k in (
                "device_ms_per_step", "device_busy_share",
                "profiled_ms_per_step")}, "lazy": lazy}


def lazy_dense_check(root, dev):
    """Lazy dense pairs on the card: the WaterRamps bench step at
    "highest" with ``dense_lazy_min_elems`` 1 against the eager dense step
    (equal bit for bit at the lazy conv's source chunk of 512; within 1e-5
    of the correction's max unchunked: sums in another order)."""
    import yaml

    from dmcf_tpu_torch.models import build_model
    from dmcf_tpu_torch.scene import bench_sample, build_scene

    with open(os.path.join(root, "configs", "WaterRamps.yml")) as f:
        cfg = dict(yaml.safe_load(f)["model"], precision="highest")
    sample = bench_sample(*build_scene(), device=dev)
    outs = {}
    for name, over in (("lazy", dict(dense_lazy_min_elems=1)),
                       ("eager512", dict(dense_n_chunk_eval=512)),
                       ("eager", {})):
        m = build_model(dict(cfg, **over), device=dev,
                        generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            outs[name] = m(sample)
    lz, e5, e = (outs[k][2]["pos_correction"] for k in ("lazy", "eager512",
                                                        "eager"))
    scale = float(e.abs().max())
    diff = float((lz - e).abs().max())
    bitwise = torch.equal(lz, e5) and torch.equal(outs["lazy"][0],
                                                  outs["eager512"][0])
    print(f"  lazy dense pairs (WaterRamps, highest): = eager at chunk 512 "
          f"bit for bit {bitwise}; vs eager unchunked {diff:.3e} of max "
          f"{scale:.3e} (tol {1e-5 * scale:.3e})")
    check(bitwise, "lazy = eager (chunk 512) bit for bit")
    check(scale > 0 and diff <= 1e-5 * scale, "lazy vs eager unchunked")
    return {"bitwise": bitwise, "diff": diff, "scale": scale}


def inflow_phase(root, dev):
    """Phase 20: ``run_sample`` in the inflow regime of the root script's
    demo: ``configs/Liquid3d.yml`` with its shipped budgets and a crop of
    65536 on ``canyon_frame``'s scene with the block, the emitter,
    INFLOW_HEIGHT up (each event re-emits it where it started; on the
    floor it would overlap the fluid that has not yet left), INFLOW_STEPS
    steps with an inflow event every INFLOW_EVERY (each adds the
    1,280-particle block), the canyon velocity boost; the report printed,
    whether the rollout was exact (not gated: random weights may let the
    poured fluid fall into the floor) and at which pairs it dropped
    neighbours, active rows counted, launches counted, peak memory."""
    import yaml

    from dmcf_tpu_torch.bench import CANYON_BOOST
    from dmcf_tpu_torch.models import build_model
    from dmcf_tpu_torch.run_sample import run_sample
    from dmcf_tpu_torch.scene import canyon_frame

    with open(os.path.join(root, "configs", "Liquid3d.yml")) as f:
        cfg = dict(yaml.safe_load(f)["model"], boundary_crop_max=INFLOW_CROP)
    model = build_model(cfg, device=dev,
                        generator=torch.Generator().manual_seed(0))
    frame = canyon_frame(height=INFLOW_HEIGHT)
    n0 = len(frame["pos"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()                # the run_sample path starts here
    frames, report = run_sample(
        model, frame, INFLOW_STEPS + 1, inflow=INFLOW_STEPS,
        inflow_every=INFLOW_EVERY, chunk=INFLOW_EVERY, vel=CANYON_BOOST,
        device=dev, log=lambda m: print(f"  {m}"))
    launches = counts()[:2]      # and ends here
    peak = torch.cuda.max_memory_allocated(dev)
    active = (np.abs(frames[:, :, 0]) < 500.0).sum(1).tolist()
    events = [t for t in range(INFLOW_STEPS)
              if t % INFLOW_EVERY == INFLOW_EVERY - 1]
    want = [n0] + [n0 * (1 + sum(e <= t for e in events))
                   for t in range(INFLOW_STEPS)]
    over = {k: v for k, v in report["pair_overflow_detail"].items()
            if v > 0}
    print(f"  {report['ms_per_step']:.3f} ms/step, peak memory allocated "
          f"{peak / 2 ** 30:.3f} GiB, capacity {report['capacity']}, active "
          f"rows a frame {sorted(set(active))}, launches {launches}")
    exact = not over and report["max_neighbors"] <= report["neighbor_k"]
    print(f"  exact: {exact} (pair_overflow {report['pair_overflow']}, "
          f"max_neighbors {report['max_neighbors']} of K "
          f"{report['neighbor_k']}, finest-radius window overflow "
          f"{report['cell_overflow']}, in contact "
          f"{report['boundary_crop_count']} of crop "
          f"{report['boundary_crop_max']})" + (
              f"; the rollout drops neighbours at pairs {over}" if over
              else ""))
    check(active == want, f"active rows {active} != {want}")
    check(report["n_active"][-1] == n0 * (1 + len(events)),
          "1,280 rows an inflow event")
    check(bool(np.isfinite(frames).all()), "finite run_sample frames")
    check(min(launches) > 0 and all(x % INFLOW_STEPS == 0
                                    for x in launches),
          f"run_sample launches {launches}")
    check(report["boundary_crop_count"] <= INFLOW_CROP,
          "run_sample's crop holds every in-contact boundary row")
    report.pop("box")
    return {"launches": launches, "peak_bytes": peak, "report": report,
            "exact": exact}


OPTION_STEPS = 100           # phases 21-22: each option path's rollout
OPTION_CHECKED = 5           # its first steps: every FPS launch vs plain
OPTION_BATCH = 2             # its train step (at "highest"; the config's
                             # first window, 3 on both paths)
# phase 21 (path A): WaterRamps' SymNet with the FPS pyramid, density and
# pressure features, dens_norm and the pre-advection branch; phase 22
# (path B): column/hrnet.yml with the FPS pyramid, the equivariant output,
# circular kernels, one extra conv at scale 0 of layer 1 (at the config's
# own width) and transposed searches (its K-list pairs run both ways
# between 4 scales at one radius; path A's downward pairs are dense)
PATH_A = dict(voxel_size=None, dens_feats=True, pres_feats=True,
              dens_norm=True, use_pre_adv=True)
PATH_B = dict(voxel_size=None, equivar=True, circular=True,
              transpose_search_reuse=True,
              layer_channels=[[[8]], [[16, 16], [8], [4], [4]],
                              [[16], [8], [4], [4]], [[16]], [[1]]])


def fps_launches():
    from dmcf_tpu_torch.kernels.fps import farthest_point_sample
    return farthest_point_sample.launches


class CheckedFps:
    """Within: each FPS kernel launch the model makes held against the
    plain version on the same inputs, its inputs kept with the largest
    absolute difference of any output element (idx as integers, the
    selection mask as 0 / 1; 0 where the two are bitwise equal); the
    plain calls count no launch."""

    def __init__(self):
        self.log = []

    def __enter__(self):
        from dmcf_tpu_torch.kernels import fps
        from dmcf_tpu_torch.ops import sph

        def call(pos, mask, sample_max, count):
            idx, sel = fps.farthest_point_sample(pos, mask, sample_max,
                                                 count)
            ref = fps.farthest_point_sample_reference(pos, mask, sample_max,
                                                      count)
            err = max(int((idx.long() - ref[0].long()).abs().max()),
                      int((sel.int() - ref[1].int()).abs().max()))
            self.log.append(((pos, mask, sample_max, count), err))
            return idx, sel

        sph.farthest_point_sample = call
        return self

    def __exit__(self, *exc):
        from dmcf_tpu_torch.kernels.fps import farthest_point_sample
        from dmcf_tpu_torch.ops import sph
        sph.farthest_point_sample = farthest_point_sample


class CheckedInversions:
    """Within: each neighbour list that a ``SearchCache`` makes by
    inverting its transposed pair's list (``transpose_search_reuse``)
    held against the search it stands in for (``same_sets``: the same
    neighbour sets and counts), and each call of a conv of ``model`` fed
    such a list counted (``fed``)."""

    def __init__(self, model):
        self.model = model
        self.checked, self.fed = [], 0

    def __enter__(self):
        from dmcf_tpu_torch.models import pbf
        from dmcf_tpu_torch.models.layers import ContinuousConv
        from dmcf_tpu_torch.ops.neighbors import search

        made = []
        invert, get = pbf.invert_neighbors_list, pbf.SearchCache.get
        self._orig = invert, get

        def inverting(*args, **kw):
            made.append(invert(*args, **kw))
            return made[-1]

        def checked_get(cache, src, dst, radius, points, pmask, queries,
                        qmask, occ_cap=None, k=None):
            n = len(made)
            nl = get(cache, src, dst, radius, points, pmask, queries, qmask,
                     occ_cap=occ_cap, k=k)
            if len(made) > n:    # this call inverted the transposed list
                ref = search(points, queries, radius, k or cache.k,
                             method=cache.method, points_mask=pmask,
                             queries_mask=qmask,
                             occ_cap=occ_cap or cache.occ_cap)
                self.checked.append(((src, dst, float(radius)),
                                     same_sets(nl, ref)))
            return nl

        def count_fed(mod, args):
            if len(args) > 4 and any(args[4] is nl for nl in made):
                self.fed += 1

        pbf.invert_neighbors_list = inverting
        pbf.SearchCache.get = checked_get
        self._hooks = [m.register_forward_pre_hook(count_fed)
                       for m in self.model.modules()
                       if isinstance(m, ContinuousConv)]
        return self

    def __exit__(self, *exc):
        from dmcf_tpu_torch.models import pbf
        pbf.invert_neighbors_list, pbf.SearchCache.get = self._orig
        for h in self._hooks:
            h.remove()


def fps_sets(b, n, sample_max, dev):
    """``b`` unequal sets of ``n`` rows for the FPS kernel's checks, in
    turn: an exact 3D lattice at spacing 0.01 (distance ties at every
    pick) with every 7th row masked, random 2D points with the last third
    masked, random 3D points all valid (masked rows at the sentinel
    positions); and the counts a set, in turn sample_max // 2,
    sample_max // 3 + 1 and sample_max - 1."""
    from dmcf_tpu_torch.ops.sph import masked_positions
    rng = np.random.RandomState(n)
    side = int(np.ceil(n ** (1.0 / 3.0)))
    lattice = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                       -1).reshape(-1, 3)[:n] * 0.01
    pos = np.zeros((b, n, 3), np.float32)
    mask = np.ones((b, n), bool)
    for s in range(b):
        if s % 3 == 0:
            pos[s] = lattice
            mask[s, ::7] = False
        elif s % 3 == 1:
            pos[s, :, :2] = rng.uniform(-0.5, 0.5, (n, 2))
            mask[s, n - n // 3:] = False
        else:
            pos[s] = rng.uniform(-0.5, 0.5, (n, 3))
    pos = torch.stack([masked_positions(torch.from_numpy(p),
                                        torch.from_numpy(m))
                       for p, m in zip(pos, mask)])
    count = torch.tensor([(sample_max // 2, sample_max // 3 + 1,
                           sample_max - 1)[s % 3] for s in range(b)],
                         dtype=torch.int32)
    return (pos.to(dev), torch.from_numpy(mask).to(dev), count.to(dev))


def fps_cases():
    """The FPS kernel's checks, (name, batch, n, sample_max, forced
    schedule or None): ``kernels.fps.schedule`` at N 1, 128 (path B) and
    each N where it changes and N + 1 (the one-warp limit, each block
    schedule, the workspace), one warp and a block of two at every
    rows-a-thread count the kernel is built for, path A's shapes, a batch
    of nine, and the workspace with the positions in shared and in global
    memory."""
    from dmcf_tpu_torch.kernels import fps
    cases = {}
    boundaries = [n for n in range(1, fps.REGISTER_ROWS + 1)
                  if fps.schedule(n) != fps.schedule(n + 1)]
    for n in [1, 128] + [m for b in boundaries for m in (b, b + 1)]:
        cases.setdefault(f"n{n}", (3, n, min(n + 8, 64), None))
    for i in fps.ITEMS:  # every rows-a-thread count the kernel is built for
        cases[f"warp_items{i}"] = (3, 32 * i, 64, fps.Schedule("warp", 1, i))
        cases[f"block_items{i}"] = (3, 64 * i - 5, 64,
                                    fps.Schedule("block", 2, i))
    cases.update({
        "wr_scale1": (2, 2688, 1344, None),
        "wr_scale2": (2, 1344, 672, None),
        "lattice_holes": (2, 1327, 664, None),
        "batch_3d": (3, 343, 200, None),
        "column": (3, 48, 48, None),
        "batch_9": (9, 128, 128, None),
        "workspace_shared": (2, 12000, 48, None),
        "workspace_global": (2, 20000, 48, None),
    })
    return [(k,) + v for k, v in cases.items()]


def fps_kernel_phase(dev):
    """Phase 3b: the FPS kernel against its plain version at every case
    of ``fps_cases`` (idx and the selection mask bitwise equal, two
    launches bitwise equal).  Returns the cases, the largest difference
    of any output element and the schedules run."""
    from dmcf_tpu_torch.kernels.fps import (_launch,
                                            farthest_point_sample_reference,
                                            schedule)
    worst, ran = 0, set()
    cases = fps_cases()
    for name, b, n, s, sched in cases:
        pos, mask, count = fps_sets(b, n, s, dev)
        idx, sel = _launch(pos, mask, s, count, sched)
        again, again_sel = _launch(pos, mask, s, count, sched)
        ref_idx, ref_sel = farthest_point_sample_reference(pos, mask, s,
                                                           count)
        torch.cuda.synchronize()
        err = max(int((idx.long() - ref_idx.long()).abs().max()),
                  int((sel.int() - ref_sel.int()).abs().max()))
        check(err == 0, f"fps {name} (B {b} N {n} S {s}): kernel vs plain "
              f"{err}")
        check(torch.equal(idx, again) and torch.equal(sel, again_sel),
              f"fps {name}: two launches bitwise equal")
        worst = max(worst, err)
        ran.add(sched or schedule(n))
    regimes = sorted({r.regime for r in ran})
    print(f"  FPS kernel: {len(cases)} cases bitwise equal to the plain "
          f"version and to a second launch, {len(ran)} schedules "
          f"(regimes {regimes})")
    return dict(cases=len(cases), max_abs_err=worst, schedules=len(ran))


def fps_bound(pos, mask, sample_max):
    """Least time of one FPS call: bytes (positions and mask read once,
    the count, idx and the selection mask written once) over the memory
    rate, or operations (each pick after the first: each valid row's
    distance to the last pick, 3 subtractions, a product, two fused
    multiply-adds at 2 each, and a minimum, 9 fp32 operations) over the
    fp32 rate, whichever is larger.  Returns (ms, by, bytes, operations);
    the latency floor (sample_max dependent picks) is not in it: the
    smoke measures it (``fps_floor_ms``)."""
    b = pos.shape[0] if pos.dim() == 3 else 1
    n = pos.shape[-2]
    nbytes = b * (13 * n + 4 + 5 * sample_max)
    ops = 9 * int(mask.sum()) * (sample_max - 1)
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


# device ms of csrc/fps.cu's earlier design (two five-round shuffle trees
# and a barrier a pick, the positions read from shared memory) at the
# main path's FPS shapes (N, sample_max), as PERF.md records them (NVIDIA
# H100 80GB HBM3, 700.00 W): printed beside this run's times
FPS_EARLIER_DEVICE_MS = {(2688, 1344): 1.3674, (1344, 672): 0.6149,
                         (128, 128): 0.0946}


def fps_floor_ms(sched, picks, dev):
    """Device ms of ``sched``'s latency floor over ``picks`` picks: the
    kernel, through ``farthest_point_sample``, on a set of one row a
    thread under the same regime and warps (32 rows for one warp, 32 x
    ``BLOCK_WARPS`` for the block), where its time is the pick chain
    alone."""
    from dmcf_tpu_torch.kernels.fps import farthest_point_sample, schedule
    from dmcf_tpu_torch.profile_step import graph_ms
    rows = 32 * sched.warps
    check(schedule(rows) == sched._replace(items=1),
          f"fps latency floor: {rows} rows take {schedule(rows)}, not "
          f"{sched} at one row a thread")
    pos = torch.rand((rows, 3), generator=torch.Generator().manual_seed(0))
    pos, mask = pos.to(dev), torch.ones(rows, dtype=torch.bool, device=dev)
    count = torch.tensor(picks, dtype=torch.int32, device=dev)
    return graph_ms(lambda: farthest_point_sample(pos, mask, picks, count))


def fps_times(log):
    """The FPS kernel at each distinct (rows, sample_max) of ``log``: ms of
    calls back to back, device ms (graph replay), us a pick, its
    schedule's latency floor (``fps_floor_ms``) and the multiple of it,
    the plain version's ms and the bound (after the main path's counts
    are read)."""
    from dmcf_tpu_torch.kernels.fps import (farthest_point_sample,
                                            farthest_point_sample_reference,
                                            schedule)
    from dmcf_tpu_torch.profile_step import graph_ms
    out = {}
    for (pos, mask, s, count), _ in log:
        key = (pos.shape[-2], s)
        if key in out:
            continue
        sched = schedule(key[0])
        ms = cuda_ms(lambda: farthest_point_sample(pos, mask, s, count),
                     iters=20)
        d_ms = graph_ms(lambda: farthest_point_sample(pos, mask, s, count))
        f_ms = fps_floor_ms(sched, s, pos.device)
        p_ms = cuda_ms(lambda: farthest_point_sample_reference(
            pos, mask, s, count), iters=2, warmup=1)
        b_ms, b_by, nbytes, ops = fps_bound(pos, mask, s)
        earlier = FPS_EARLIER_DEVICE_MS.get(key)
        out[key] = dict(ms=ms, device_ms=d_ms, us_a_pick=1e3 * d_ms / s,
                        floor_ms=f_ms, floor_multiple=d_ms / f_ms,
                        schedule=sched._asdict(), plain_ms=p_ms,
                        bound_ms=b_ms, bound_by=b_by)
        print(f"  fps N {key[0]} sample_max {s} valid {int(mask.sum())}, "
              f"schedule {tuple(sched)}: kernel {ms:.4f} ms (device time "
              f"{d_ms:.4f}, {1e3 * d_ms / s:.4f} us a pick), latency floor "
              f"{f_ms:.4f} ms ({1e3 * f_ms / s:.4f} us a pick; the kernel "
              f"{d_ms / f_ms:.2f} x it), earlier design "
              f"{earlier if earlier is not None else 'not recorded'} ms, "
              f"plain {p_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}: "
              f"{nbytes} B, {ops} FLOP)")
    return out


def option_phase(root, what, cfg_path, overrides, sample, dev,
                 fps_per_step, step0_free, max_err, momentum=False,
                 inverted=False):
    """Phases 21-22: one option path, ``configs/<cfg_path>``'s model with
    ``overrides`` at its precision (seed-0 weights): its first
    OPTION_CHECKED steps with every FPS launch held against the plain
    version bit for bit, every K-list launch of the first step against
    its plain version and, with ``inverted``, every list inverted from its
    transpose (``transpose_search_reuse``) against the search it stands
    in for, at least one of them fed to a conv; then the main path, an
    OPTION_STEPS-step rollout (``gated_rollout``, FPS exactly
    ``fps_per_step`` a step), its device time a step (profiler), each FPS
    shape timed; then at "highest" one step card vs CPU (the correction
    within 1e-4 of its max) and one train step card vs CPU
    (``train_step_phase``, batch OPTION_BATCH)."""
    import yaml

    from dmcf_tpu_torch.models import build_model
    from dmcf_tpu_torch.profile_step import record_launches, trace
    from dmcf_tpu_torch.rollout import rollout

    with open(os.path.join(root, "configs", cfg_path)) as f:
        cfg = dict(yaml.safe_load(f)["model"], **overrides)
    model = build_model(cfg, device=dev,
                        generator=torch.Generator().manual_seed(0))
    fm = sample["fluid_mask"]
    rows = sample["pos"].shape[0] + sample["box"].shape[0]
    print(f"  {what}: {int(fm.sum())} fluid + {int(sample['box_mask'].sum())}"
          f" boundary particles in {rows} rows, precision "
          f"{model.precision}")
    with CheckedFps() as chk, CheckedInversions(model) as inv:
        (_, _, aux), log = record_launches(model, sample)
        rollout(model, sample, OPTION_CHECKED - 1)
    torch.cuda.synchronize()
    fps_err = max(err for _, err in chk.log)
    print(f"  FPS launches of the first {OPTION_CHECKED} steps: "
          f"{len(chk.log)}, bitwise equal to the plain version: "
          f"{sum(err == 0 for _, err in chk.log)}, largest difference "
          f"{fps_err} (shapes "
          f"{sorted({(a[0].shape[-2], a[2]) for a, _ in chk.log})})")
    check(len(chk.log) == fps_per_step * OPTION_CHECKED,
          f"{what}: {len(chk.log)} FPS launches in {OPTION_CHECKED} steps")
    check(fps_err == 0, f"{what}: FPS kernel vs plain")
    pairs = sorted({key for key, _ in inv.checked})
    print(f"  lists inverted from their transpose in the first "
          f"{OPTION_CHECKED} steps: {len(inv.checked)} (pairs {pairs}), "
          f"equal to a search of the pair: "
          f"{sum(eq for _, eq in inv.checked)}; conv calls fed one: "
          f"{inv.fed}")
    check(all(eq for _, eq in inv.checked),
          f"{what}: inverted lists = searches")
    check(bool(inv.fed) == inverted, f"{what}: {inv.fed} conv calls fed "
          f"an inverted list (transpose_search_reuse {inverted})")
    excess = {k: int(v) for k, v in aux["pair_overflow_detail"].items()}
    print(f"  first step: pair excess {excess}, scale counts "
          f"{aux['scale_counts'].tolist()} caps "
          f"{aux['scale_caps'].tolist()}")
    launch_checks(log, what, max_err)
    with torch.no_grad():
        model(sample)                            # warm-up step
    run = gated_rollout(model, sample, OPTION_STEPS, what, log,
                        fps_per_step=fps_per_step, momentum=momentum)
    with torch.no_grad():
        report = trace(lambda: model(sample), reps=3, top=8)
    print(f"  device time {report['device_ms_per_step']:.3f} ms a step in "
          f"{report['kernel_launches_per_step']} kernel launches, busy "
          f"share {report['device_busy_share']:.3f} of "
          f"{report['profiled_ms_per_step']:.3f} ms")
    times = fps_times(chk.log)

    # card vs CPU at "highest"
    exact = build_model(dict(cfg, precision="highest"), device=dev,
                        generator=torch.Generator().manual_seed(0))
    cpu_model = copy.deepcopy(exact).to("cpu")
    with torch.no_grad():
        pg, _, ag = exact(sample)
        pc, _, ac = cpu_model({k: v.cpu() for k, v in sample.items()})
    want = ac["pos_correction"]
    scale = float(want.abs().max())
    err = float((ag["pos_correction"].cpu() - want).abs().max())
    print(f"  one step at highest, card vs CPU: pos_correction max diff "
          f"{err:.3e} of max {scale:.3e} (tol 1e-4 of it); positions "
          f"{float((pg.cpu() - pc).abs().max()):.3e}")
    check(scale > 0 and err <= 1e-4 * scale,
          f"{what}: card vs CPU pos_correction {err}")
    train = train_step_phase(root, cfg_path, dev, exact, sample, what,
                             batch_size=OPTION_BATCH, step0_free=step0_free,
                             cpu_check=True)
    return dict(run, fps=times, fps_max_abs_err=fps_err,
                fps_checked=len(chk.log), inverted=len(inv.checked),
                inverted_fed=inv.fed,
                device_ms=report["device_ms_per_step"],
                device_launches=report["kernel_launches_per_step"],
                card_cpu_err=err / scale, train=train)


def counts_of(log):
    """K-list launches (fp32, bf16) in a recorded step's log."""
    n_bf16 = sum(bf16(kw) for _, _, kw, _ in log)
    return [len(log) - n_bf16, n_bf16]


def path_a_phase(root, dev, max_err):
    """Phase 21: path A, configs/WaterRamps.yml's SymNet at full width and
    depth (its bf16 trunk) with PATH_A's options on the bench scene."""
    from dmcf_tpu_torch.scene import bench_sample, build_scene

    sample = bench_sample(*build_scene(), device=dev)
    return option_phase(root, "path A", "WaterRamps.yml", PATH_A, sample,
                        dev, 2, 3, max_err, momentum=True)


def path_b_sample(root, dev):
    """Path B's scene: the column/hrnet.yml train split's largest scene,
    made on the card by the column kernel, its first frame as a sample on
    ``dev``."""
    from dmcf_tpu_torch.data import (DatasetGroup, get_rollout,
                                     pad_rollout_state)
    from dmcf_tpu_torch.pipelines.simulator import _STATE_KEYS

    full = column_config(root, "hrnet.yml")
    ds = dict(full["dataset"])
    ds["valid"] = dict(ds["valid"], timesteps=2)
    ds["test"] = dict(ds["test"], timesteps=2)
    group = DatasetGroup(split="train", cache_dir=None, device=dev.type,
                         **ds)
    dg = full["pipeline"]["data_generator"]
    split = {k: v for k, v in dg.items() if k not in ("train", "valid",
                                                      "test")}
    seqs = get_rollout(group.train, **split)
    seq = max(seqs, key=lambda s: s["pos"].shape[1])
    state = pad_rollout_state(seq)
    return {k: torch.as_tensor(np.ascontiguousarray(
        state[k][0] if k in ("pos", "vel", "grav") else state[k]),
        device=dev) for k in _STATE_KEYS if state.get(k) is not None}


def path_b_phase(root, dev, max_err):
    """Phase 22: path B, configs/column/hrnet.yml at full width with
    PATH_B's options, on ``path_b_sample``."""
    return option_phase(root, "path B", "column/hrnet.yml", PATH_B,
                        path_b_sample(root, dev), dev, 3, 2, max_err,
                        inverted=True)


REF_CKPT = os.path.join("tests", "data", "tf_ckpt_liquid3d", "ckpt")
REF_SCENE = os.path.join("tests", "data", "liquid_block.msgpack.zst")
REF_STEPS = 20               # phase 23's run_sample rollout


def abs_sum(arrays):
    """The sum of |w| over ``arrays`` in float64 (``math.fsum``: exact,
    so no order enters), as ``scripts/make_tf_reference_fixture.py``
    takes it."""
    import math
    return math.fsum(math.fsum(np.abs(np.asarray(a, np.float64)).ravel())
                     for a in arrays)


def reference_phase(root, dev, max_err, summary_dir):
    """Phase 23: a reference-format checkpoint and a dataset file on the
    card.  (a) The fixture bundle (``tests/data/tf_ckpt_liquid3d``: the
    reference's variable layout, the JAX package's init weights, written
    by TensorFlow) read by ``utils/tf_bundle.py`` and loaded by
    ``utils/tf_ckpt.py`` strictly into ``configs/Liquid3d.yml``'s SymNet
    at full width and its bf16 trunk: tensor count and sum |w| equal to
    ``tests/data/fixtures.json``, in the bundle and in the loaded model.
    (b) The native scene loader built with g++ and
    ``tests/data/liquid_block.msgpack.zst`` (phase 16's block) read
    through ``Dataset`` under ``DMCF_NATIVE_LOADER=1``: each array's
    sha256 equal to the fixtures'.  (c) ``run_sample.run_sample`` on that
    frame with those weights, REF_STEPS steps on the card, no velocity
    boost: the exactness gate, the K-list launches counted exactly
    against the first step's, every launch of the first step against its
    plain version (``launch_checks``), one step at "highest" card vs the
    CPU plain path (the correction within 1e-4 of its max; at bf16 one
    rounding flip of T moves it ~2e-4, phase 7), and on an isolated blob
    (``tests/test_tf_ckpt.py``'s) the ASCC output's momentum ratio under
    1e-5.  (d) Phase 11's events file: every record's masked CRC32C
    verifies, as many scalar events as ``metrics.jsonl`` has lines, each
    the same tag, step and value (float32)."""
    import hashlib

    import yaml

    from dmcf_tpu_torch.data import Dataset, native_loader
    from dmcf_tpu_torch.models import build_model
    from dmcf_tpu_torch.profile_step import record_launches
    from dmcf_tpu_torch.run_sample import capacity_for, run_sample, \
        scene_sample
    from dmcf_tpu_torch.scene import bench_sample
    from dmcf_tpu_torch.utils.tb_writer import read_events
    from dmcf_tpu_torch.utils.tf_bundle import load_checkpoint
    from dmcf_tpu_torch.utils.tf_ckpt import load_tf_reference_checkpoint

    with open(os.path.join(root, "tests", "data", "fixtures.json")) as f:
        fixtures = json.load(f)

    print("  (a) checkpoint")
    prefix = os.path.join(root, REF_CKPT)
    t0 = time.time()
    rd = load_checkpoint(prefix)
    keys = sorted(rd.get_variable_to_shape_map())
    total = abs_sum(rd.get_tensor(k) for k in keys)
    with open(os.path.join(root, "configs", "Liquid3d.yml")) as f:
        cfg = yaml.safe_load(f)["model"]
    model = build_model(cfg, device=dev,
                        generator=torch.Generator().manual_seed(0))
    state = load_tf_reference_checkpoint(prefix, model, strict=True)
    model.load_state_dict(state, strict=True)
    loaded = abs_sum(v.cpu().numpy() for v in model.state_dict().values())
    want = fixtures["tf_ckpt_liquid3d"]
    print(f"  bundle {REF_CKPT}: {len(keys)} tensors, sum |w| {total!r} "
          f"(fixtures: {want['tensors']}, {want['abs_sum']!r}); loaded "
          f"strictly into {type(model).__name__} ({model.precision}): "
          f"{len(state)} tensors, sum |w| {loaded!r} (fixtures: "
          f"{want['model_tensors']}, {want['model_abs_sum']!r}) in "
          f"{time.time() - t0:.2f} s")
    check(len(keys) == want["tensors"] and total == want["abs_sum"],
          "bundle tensors and sum |w| = fixtures.json")
    check(len(state) == want["model_tensors"]
          and loaded == want["model_abs_sum"],
          "loaded tensors and sum |w| = fixtures.json")
    check(model.precision == "default", "the config's bf16 trunk")

    print("  (b) dataset file through the native loader")
    libs = subprocess.run(["ldconfig", "-p"], capture_output=True,
                          text=True).stdout
    print("  " + "; ".join(ln.strip() for ln in libs.splitlines()
                           if "libzstd.so" in ln))
    t0 = time.time()
    log = native_loader.build()
    print(f"  native loader {native_loader.target().name} built in "
          f"{time.time() - t0:.2f} s" + (f"; g++ said:\n{log}" if log
                                         else ""))
    scene = os.path.join(root, REF_SCENE)
    before = os.environ.get("DMCF_NATIVE_LOADER")
    os.environ["DMCF_NATIVE_LOADER"] = "1"
    try:
        ds = Dataset(dataset_path=os.path.dirname(scene))
        check(ds.files == [scene], f"one scene file: {ds.files}")
        t0 = time.time()
        frames = ds[0]
        read_s = time.time() - t0
    finally:
        if before is None:
            os.environ.pop("DMCF_NATIVE_LOADER")
        else:
            os.environ["DMCF_NATIVE_LOADER"] = before
    frame = frames[0]
    want = fixtures["liquid_block"]
    digests = {k: hashlib.sha256(np.ascontiguousarray(frame[k]).tobytes())
               .hexdigest() for k in want["sha256"]}
    print(f"  {REF_SCENE}: {len(frames)} frame, {len(frame['pos'])} fluid "
          f"and {len(frame['box'])} boundary rows, read in {read_s:.3f} s; "
          f"sha256 equal to fixtures.json: "
          f"{ {k: d == want['sha256'][k] for k, d in digests.items()} }")
    check(digests == want["sha256"], "scene arrays' sha256")

    print(f"  (c) run_sample, {REF_STEPS} steps")
    zero = [0.0, 0.0, 0.0]
    n0 = len(frame["pos"])
    sample, _, _, _ = scene_sample(model, frame, vel=zero,
                                   capacity=capacity_for(n0, REF_STEPS + 1),
                                   device=dev, log=lambda m: None)
    (_, _, aux), log = record_launches(model, sample)
    step = counts_of(log)
    print(f"  first step: K-list launches (fp32, bf16) {step}; pair excess "
          f"{dict((k, int(v)) for k, v in aux['pair_overflow_detail'].items())}")
    launch_checks(log, "reference", max_err)
    exact = build_model(dict(cfg, precision="highest"), device=dev,
                        generator=torch.Generator().manual_seed(0))
    exact.load_state_dict(state, strict=True)
    cpu_model = copy.deepcopy(exact).to("cpu")
    with torch.no_grad():
        _, _, ag = exact(sample)
        _, _, ac = cpu_model({k: v.cpu() for k, v in sample.items()})
    fm = sample["fluid_mask"].cpu()
    want_c = ac["pos_correction"][fm]
    scale = float(want_c.abs().max())
    err = float((ag["pos_correction"].cpu()[fm] - want_c).abs().max())
    print(f"  one step at highest, card vs CPU: pos_correction max diff "
          f"{err:.3e} of max {scale:.3e} (tol 1e-4 of it)")
    check(scale > 0 and err <= 1e-4 * scale,
          f"reference: card vs CPU pos_correction {err}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()                # the reference path starts here
    out, report = run_sample(model, frame, REF_STEPS + 1, vel=zero,
                             device=dev, log=lambda m: print(f"  {m}"))
    launches = counts()[:2]      # and ends here
    peak = torch.cuda.max_memory_allocated(dev)
    gate = report["pair_overflow"] <= 0 \
        and report["max_neighbors"] <= report["neighbor_k"]
    print(f"  {report['ms_per_step']:.3f} ms/step, peak memory allocated "
          f"{peak / 2 ** 30:.3f} GiB, exact {gate} (pair_overflow "
          f"{report['pair_overflow']}, max_neighbors "
          f"{report['max_neighbors']} of K {report['neighbor_k']}), "
          f"launches {launches} (want {[REF_STEPS * x for x in step]})")
    check(bool(np.isfinite(out).all()), "finite run_sample frames")
    check(gate, f"reference exactness gate: {report['pair_overflow']}, "
          f"{report['max_neighbors']}")
    check(launches == [REF_STEPS * x for x in step],
          f"reference launches {launches}")
    rng = np.random.RandomState(1)
    blob = bench_sample(rng.uniform(-0.2, 0.2, (128, 3)).astype(np.float32),
                        np.full((2, 3), 100.0, np.float32),
                        np.tile(np.float32([0, 1, 0]), (2, 1)), device=dev)
    _, blog = record_launches(model, blob)
    sym = [o for n_, _, _, o in blog if n_ == "sym_conv0"][0]
    ratio = float((sym.sum(0).abs() / sym.abs().sum()).max())
    print(f"  isolated blob (128 fluid, boundary far): ASCC output |sum "
          f"out| / sum |out| {ratio:.3e} (< 1e-5)")
    check(ratio < 1e-5, f"reference blob momentum ratio {ratio}")

    print("  (d) phase 11's events file")
    (events_file,) = [n for n in os.listdir(summary_dir)
                      if n.startswith("events.out.tfevents.")]
    events = read_events(os.path.join(summary_dir, events_file))
    with open(os.path.join(summary_dir, "metrics.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    scalars = [e for e in events if "value" in e]
    texts = [e["tag"] for e in events if "text" in e]
    print(f"  {events_file}: {len(events)} records, CRC32C verified; "
          f"{len(scalars)} scalar events, text events {texts}; "
          f"metrics.jsonl {len(lines)} lines")
    check(events[0].get("file_version") == "brain.Event:2",
          "events file version record")
    check(len(scalars) == len(lines), "one scalar event a metrics line")
    check(all(e["tag"] == ln["tag"] and e["step"] == ln["step"]
              and e["value"] == float(np.float32(ln["value"]))
              for e, ln in zip(scalars, lines)),
          "scalar events = metrics.jsonl lines")
    check("config" in texts, "run_pipeline's config text event")
    return {"step": step, "launches": launches, "report": report,
            "peak_bytes": peak, "card_cpu_err": err / scale,
            "momentum_ratio": ratio, "events": len(events),
            "scalar_events": len(scalars)}


# phase 24: the interpolation modes of the K-list kernels (linear_border,
# nearest_neighbor) on the model path, the kernel cases, and the layer
# library
INTERP_MODES = ("linear_border", "nearest_neighbor")
NEAREST_STEPS = 100          # (a): the nearest_neighbor WaterRamps rollout
BORDER_STEPS = 20            # (b): the linear_border Liquid3d rollout
INTERP_BATCH = 2             # (a): its train steps (window 3)
SPARSE_VOXEL = 0.05          # (d): the layers' grid, the block's spacing


def variant(mode, which, half):
    """A kernel variant's name in the ``kernels`` line."""
    base = "cconv_klist" if which == "fwd" else f"cconv_klist_bwd_{which}"
    return f"{base}_{mode}" + ("_bf16" if half else "")


def launch_times(log, mode, rows, seed=0):
    """Each recorded launch of ``log`` (one step of a ``mode`` model) in
    its own variant: the forward's ms, device ms, plain ms and bound, and
    at the same shape both backward kernels held against the plain
    backward (``bwd_check``: the existing limits, two launches bitwise
    equal) and timed (``bwd_times``).  Sums a step's numbers into ``rows``
    {variant: dict}; updates each row's largest error."""
    from dmcf_tpu_torch.kernels.cconv_klist import (cconv_klist,
                                                    cconv_klist_reference)
    from dmcf_tpu_torch.profile_step import graph_ms

    def add(name, **kv):
        row = rows.setdefault(name, {})
        row["step_launches"] = row.get("step_launches", 0) + 1
        for k, v in kv.items():
            if k.endswith("err"):
                row[k] = max(row.get(k, 0.0), v)
            else:
                row[k] = row.get(k, 0.0) + v

    with torch.no_grad():
        for i, (name, args, kw, out) in enumerate(log):
            half = bf16(kw)
            kargs = kernel_args(args, kw)
            err = fwd_check(f"{mode} {name}", out,
                            cconv_klist_reference(*args, **kw), kw)
            add(variant(mode, "fwd", half),
                step_ms=cuda_ms(lambda: cconv_klist(*kargs, **kw), iters=10),
                step_device_ms=graph_ms(lambda: cconv_klist(*kargs, **kw)),
                step_plain_ms=cuda_ms(
                    lambda: cconv_klist_reference(*args, **kw), iters=5),
                step_bound_ms=bound(*args, kw["qfeats"], kw["precision"],
                                    mode)[0],
                max_abs_err=err)
            rel, abs_err, full = bwd_check(args, kw["qfeats"], seed + i,
                                           kw["precision"], mode)
            tm = bwd_times(full, kw["precision"], mode)
            for which, off, names in (("data", 0, ("dfeats", "dqfeats", "da",
                                                   "dt")),
                                      ("filter", 2, ("dw",))):
                add(variant(mode, which, half), step_ms=tm[off],
                    step_device_ms=tm[off + 1], step_plain_ms=tm[4],
                    step_bound_ms=tm[5 if which == "data" else 6][0],
                    max_abs_err=max(abs_err.get(n, 0.0) for n in names),
                    max_rel_err=max(rel.get(n, 0.0) for n in names))


def only_mode(mode, what):
    """Every launch counted since the last ``zero_counts`` was of ``mode``'s
    kernels (no other mode's); returns the counts."""
    got = counts()
    check(counts(mode) == got, f"{what}: launches {got} all {mode} "
          f"({counts(mode)})")
    return got


def tie_momentum(model, state):
    """The ASCC output's momentum ratio |sum out| / sum |out| after a
    nearest_neighbor rollout (``state``), and the pairs that break it:
    a slot whose filter coordinate t + h lies exactly half-way between two
    taps on an axis (t = 0 on an even axis: an offset with an exact zero
    component, as the boundary lattice's rows have) takes the even tap by
    round half to even, and so does its mirror pair, whose exchange then
    does not cancel (in JAX as in the port).  The ratio must lie below
    1e-5 once those slots are left out (the kernel run again with their
    weight 0); the slots are counted by kind (fluid or boundary row, each
    side).  Returns the numbers."""
    from dmcf_tpu_torch.kernels.cconv_klist import cconv_klist
    from dmcf_tpu_torch.profile_step import record_launches

    _, log = record_launches(model, state)
    _, (idx, a, t, feats, w, ks), kw, out = [
        e for e in log if e[0] == "sym_conv0"][0]

    def ratio(x):
        return float((x.sum(0).abs() / x.abs().sum()).max())

    half = torch.tensor([0.5 * (n - 1) for n in ks], device=t.device)
    x = t + half
    tie = ((x - torch.floor(x)) == 0.5) & (torch.tensor(ks, device=t.device)
                                           > 1)
    tie = tie.any(dim=-1) & (a != 0)
    kept = cconv_klist(idx, torch.where(tie, 0.0, a), t, feats, w, ks,
                       **kw)
    n_fluid = state["pos"].shape[0]
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None] < n_fluid
    cols = idx < n_fluid
    kinds = {f"{p}-{q}": int((tie & (rows == r) & (cols == c)).sum())
             for p, r in (("fluid", True), ("boundary", False))
             for q, c in (("fluid", True), ("boundary", False))}
    full, rest = ratio(out), ratio(kept)
    print(f"  ASCC output after the rollout: |sum out| / sum |out| "
          f"{full:.3e}; {int(tie.sum())} of {int((a != 0).sum())} slots "
          f"sit on an exact nearest_neighbor tie (by query-neighbour row "
          f"kind: {kinds}); without them {rest:.3e} (< 1e-5)")
    check(rest < 1e-5, f"ASCC momentum ratio without the tie pairs {rest}")
    return {"momentum_ratio": full, "momentum_ratio_untied": rest,
            "tie_slots": int(tie.sum()), "tie_kinds": kinds}


def nearest_phase(root, dev, mode_err, rows):
    """Phase 24 (a): configs/WaterRamps.yml at full width and depth, its
    bf16 trunk, seed-0 weights, ``interpolation: nearest_neighbor``, on
    the bench scene: every K-list launch of the first step against its
    plain version, each timed in its variant (a step's device time: 18
    bf16 launches and the fp32 ASCC one) with both backward kernels held
    against the plain backward at its shape (``launch_times``); a
    NEAREST_STEPS-step rollout
    under the exactness gate with the ASCC momentum ratio after it and the
    tie pairs that break it (``tie_momentum``); at
    "highest" one step card vs CPU and one train step (batch INTERP_BATCH,
    window 3) card vs CPU; one train step of the bf16 trunk (its backward
    kernels' bf16 variants).  Every launch of every run is a
    nearest_neighbor one."""
    import yaml

    from dmcf_tpu_torch.models import build_model
    from dmcf_tpu_torch.profile_step import record_launches, trace
    from dmcf_tpu_torch.scene import bench_sample, build_scene

    mode = "nearest_neighbor"
    with open(os.path.join(root, "configs", "WaterRamps.yml")) as f:
        cfg = dict(yaml.safe_load(f)["model"], interpolation=mode)
    sample = bench_sample(*build_scene(), device=dev)
    model = build_model(cfg, device=dev,
                        generator=torch.Generator().manual_seed(0))
    zero_counts()
    (_, _, aux), log = record_launches(model, sample)
    torch.cuda.synchronize()
    step = only_mode(mode, "nearest first step")[:2]
    check(step == [1, 18], f"nearest first step launches {step}")
    print(f"  first step: K-list launches (fp32, bf16) {step}, pair excess "
          f"{ {k: int(v) for k, v in aux['pair_overflow_detail'].items()} }")
    launch_checks(log, "nearest", mode_err[mode])
    with torch.no_grad():
        model(sample)                            # warm-up step
    run = gated_rollout(model, sample, NEAREST_STEPS,
                        "WaterRamps nearest_neighbor", log)
    only_mode(mode, "nearest rollout")
    run.update(tie_momentum(model, run.pop("end")))
    with torch.no_grad():
        report = trace(lambda: model(sample), reps=3, top=8)
    print(f"  device time {report['device_ms_per_step']:.3f} ms a step in "
          f"{report['kernel_launches_per_step']} kernel launches, busy "
          f"share {report['device_busy_share']:.3f} of "
          f"{report['profiled_ms_per_step']:.3f} ms")
    launch_times(log, mode, rows)

    exact = build_model(dict(cfg, precision="highest"), device=dev,
                        generator=torch.Generator().manual_seed(0))
    cpu_model = copy.deepcopy(exact).to("cpu")
    with torch.no_grad():
        pg, _, ag = exact(sample)
        pc, _, ac = cpu_model({k: v.cpu() for k, v in sample.items()})
    want = ac["pos_correction"]
    scale = float(want.abs().max())
    err = float((ag["pos_correction"].cpu() - want).abs().max())
    print(f"  one step at highest, card vs CPU: pos_correction max diff "
          f"{err:.3e} of max {scale:.3e} (tol 1e-4 of it); positions "
          f"{float((pg.cpu() - pc).abs().max()):.3e}")
    check(scale > 0 and err <= 1e-4 * scale,
          f"nearest card vs CPU pos_correction {err}")
    train = train_step_phase(root, "WaterRamps.yml", dev, exact, sample,
                             "nearest (highest)", batch_size=INTERP_BATCH,
                             cpu_check=True)
    only_mode(mode, "nearest train step (highest)")
    train16 = train_step_phase(root, "WaterRamps.yml", dev, model, sample,
                               "nearest (bf16 trunk)",
                               batch_size=INTERP_BATCH)
    only_mode(mode, "nearest train step (bf16 trunk)")
    return dict(run, step=step, device_ms=report["device_ms_per_step"],
                device_launches=report["kernel_launches_per_step"],
                card_cpu_err=err / scale, train=train, train16=train16)


def border_phase(root, dev, mode_err):
    """Phase 24 (b): configs/Liquid3d.yml (its bf16 trunk, seed-0 weights)
    with ``interpolation: linear_border`` on phase 16's block: every
    K-list launch of the first step against its plain version (the 8-tap
    3D instantiations, the 6x6x6 ASCC conv), a BORDER_STEPS-step rollout
    under the gate with the momentum ratio, the first step against the
    linear model's (the model maps in-radius offsets inside the span,
    where the two modes agree), at "highest" one step card vs CPU, and
    one train step (batch 1, the config's first window) at the bf16
    trunk, its launches counted exactly."""
    import yaml

    from dmcf_tpu_torch.models import build_model
    from dmcf_tpu_torch.profile_step import record_launches
    from dmcf_tpu_torch.scene import bench_sample

    mode = "linear_border"
    with open(os.path.join(root, "configs", "Liquid3d.yml")) as f:
        base = yaml.safe_load(f)["model"]
    cfg = dict(base, interpolation=mode)
    sample = bench_sample(*liquid_scene(), device=dev)
    model = build_model(cfg, device=dev,
                        generator=torch.Generator().manual_seed(0))
    zero_counts()
    (p1, _, aux), log = record_launches(model, sample)
    torch.cuda.synchronize()
    step = only_mode(mode, "linear_border first step")[:2]
    print(f"  first step: K-list launches (fp32, bf16) {step}")
    launch_checks(log, "linear_border", mode_err[mode])
    lin = build_model(base, device=dev,
                      generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        _, _, al = lin(sample)
    scale = float(al["pos_correction"].abs().max())
    same = float((aux["pos_correction"] - al["pos_correction"]).abs().max())
    print(f"  first step against the linear model's: pos_correction max "
          f"diff {same:.3e} of max {scale:.3e}")
    check(same <= 1e-5 * scale, f"linear_border vs linear step {same}")
    run = gated_rollout(model, sample, BORDER_STEPS, "Liquid3d linear_border",
                        log, momentum=True)
    only_mode(mode, "linear_border rollout")
    exact = build_model(dict(cfg, precision="highest"), device=dev,
                        generator=torch.Generator().manual_seed(0))
    cpu_model = copy.deepcopy(exact).to("cpu")
    with torch.no_grad():
        _, _, ag = exact(sample)
        _, _, ac = cpu_model({k: v.cpu() for k, v in sample.items()})
    want = ac["pos_correction"]
    scale = float(want.abs().max())
    err = float((ag["pos_correction"].cpu() - want).abs().max())
    print(f"  one step at highest, card vs CPU: pos_correction max diff "
          f"{err:.3e} of max {scale:.3e} (tol 1e-4 of it)")
    check(scale > 0 and err <= 1e-4 * scale,
          f"linear_border card vs CPU pos_correction {err}")
    train = train_step_phase(root, "Liquid3d.yml", dev, model, sample,
                             "Liquid3d linear_border", batch_size=1)
    only_mode(mode, "linear_border train step")
    return dict(run, step=step, card_cpu_err=err / scale, train=train)


def tie_times(t, ksize):
    """``t`` with every filter coordinate moved onto a tap centre or
    half-way between two (nearest_neighbor's exact ties: t + h a half),
    beyond the span's ends too, drawn from a seeded generator."""
    g = torch.Generator().manual_seed(7)
    cols = []
    for ax, n in enumerate(ksize):
        half = 0.5 * (n - 1)
        pts = torch.arange(-2 * n, 2 * n + 1, dtype=torch.float32) * 0.5
        pts = pts - (half % 1.0)
        pick = torch.randint(len(pts), t.shape[:2], generator=g)
        cols.append(pts[pick])
    return torch.stack(cols, dim=-1).to(t.device).contiguous()


def interp_case_phase(root, dev, mode_err, rows):
    """Phase 24 (c): the kernels of each mode at the trunk shape (the bench
    scene's scale-0 list, Q 2688, K 40, S 64, Cin 32 -> 32) and at a 3D
    shape (phase 16's block, [4, 4, 4], Cin 32 -> 32), with the identity
    mapping, ``align_corners=False`` and no window, so filter coordinates
    pass the span's ends with their weight (where linear and
    linear_border differ: checked), and with
    coordinates on exact nearest_neighbor ties: every mode x precision x
    {forward, data, filter} against its plain version within the existing
    limits, each variant's two launches bitwise equal (forward here, the
    backward kernels in ``bwd_check``); at the trunk shape each new
    variant timed for the ``kernels`` line."""
    import yaml

    from dmcf_tpu_torch.kernels.cconv_klist import (cconv_klist,
                                                    cconv_klist_reference)
    from dmcf_tpu_torch.ops import cconv, neighbors
    from dmcf_tpu_torch.ops.sph import masked_positions
    from dmcf_tpu_torch.profile_step import graph_ms
    from dmcf_tpu_torch.scene import bench_sample, build_scene

    def inputs(sample, r, k, ksize, seed):
        pos = torch.cat([masked_positions(sample["pos"],
                                          sample["fluid_mask"]),
                         masked_positions(sample["box"],
                                          sample["box_mask"])])
        m = torch.cat([sample["fluid_mask"], sample["box_mask"]])
        nl = neighbors.search(pos, pos, r, k, points_mask=m, queries_mask=m)
        # no window: the slots past the span (at the ball's edge, where a
        # window is ~0) keep their weight, so the modes differ plainly
        idx, a, t = cconv.klist_geometry(
            nl, 2 * r, ksize, coordinate_mapping="identity",
            align_corners=False)
        g = torch.Generator().manual_seed(seed)
        s = int(np.prod(ksize))
        feats = torch.randn((pos.shape[0], 32), generator=g).to(dev)
        w = (torch.randn((s * 32, 32), generator=g) * 0.05).to(dev)
        return idx, a, t, feats, w, ksize

    with open(os.path.join(root, "configs", "WaterRamps.yml")) as f:
        wr = yaml.safe_load(f)["model"]
    with open(os.path.join(root, "configs", "Liquid3d.yml")) as f:
        lq = yaml.safe_load(f)["model"]
    trunk = inputs(bench_sample(*build_scene(), device=dev),
                   float(wr["particle_radii"][0]), int(wr["neighbor_k"]),
                   tuple(wr["kernel_size"]), 1)
    three = inputs(bench_sample(*liquid_scene(), device=dev),
                   float(lq["particle_radii"][0]), 64,
                   tuple(lq["kernel_size"]), 2)
    ties = trunk[:2] + (tie_times(trunk[2], trunk[5]),) + trunk[3:]
    ties3 = three[:2] + (tie_times(three[2], three[5]),) + three[3:]
    cases = {"trunk": trunk, "3d": three, "trunk ties": ties,
             "3d ties": ties3}
    for what, args in cases.items():
        idx, a, t, feats, w, ks = args
        print(f"  {what}: Q {idx.shape[0]} K {idx.shape[1]} S "
              f"{int(np.prod(ks))} Cin 32 Cout 32, |t| up to "
              f"{float(t.abs().max()):.3f} (h {0.5 * (max(ks) - 1):.1f})")
        lin = cconv_klist_reference(*args, precision="highest")
        for mode in INTERP_MODES:
            for prec in ("highest", "default"):
                kw = dict(qfeats=None, precision=prec, interpolation=mode)
                kargs = kernel_args(args, kw)
                got = cconv_klist(*kargs, **kw)
                again = cconv_klist(*kargs, **kw)
                torch.cuda.synchronize()
                check(torch.equal(got, again),
                      f"{what} {mode} {prec}: two launches bitwise equal")
                ref = cconv_klist_reference(*args, **kw)
                err = fwd_check(f"{what} {mode} {prec}", got, ref, kw)
                mode_err[mode][bf16(kw)] = max(mode_err[mode][bf16(kw)],
                                               err)
                if prec == "highest" and not what.endswith("ties"):
                    apart = float((ref - lin).abs().max())
                    check(apart > 1e-4 * float(ref.abs().max()),
                          f"{what}: {mode} differs from linear ({apart})")
                rel, abs_err, full = bwd_check(args[:6], None, 11, prec,
                                               mode)
                print(f"    {mode:16s} {'bf16' if bf16(kw) else 'fp32'}: "
                      f"forward {err:.3e}; backward rel err " + " ".join(
                          f"{k} {v:.2e}" for k, v in rel.items()))
                for which, names in (("data", ("dfeats", "da", "dt")),
                                     ("filter", ("dw",))):
                    row = rows.setdefault(variant(mode, which, bf16(kw)),
                                          {})
                    row["max_abs_err"] = max(row.get("max_abs_err", 0.0), *(
                        abs_err.get(n, 0.0) for n in names))
                    row["max_rel_err"] = max(row.get("max_rel_err", 0.0), *(
                        rel.get(n, 0.0) for n in names))
                row = rows.setdefault(variant(mode, "fwd", bf16(kw)), {})
                row["max_abs_err"] = max(row.get("max_abs_err", 0.0), err)
                if what != "trunk":
                    continue
                b_ms, b_by, _, _ = bound(*args, None, prec, mode)
                row.update(ms=cuda_ms(lambda: cconv_klist(*kargs, **kw)),
                           device_ms=graph_ms(
                               lambda: cconv_klist(*kargs, **kw)),
                           plain_ms=cuda_ms(lambda: cconv_klist_reference(
                               *args, **kw), iters=10),
                           bound_ms=b_ms, bound_by=b_by)
                tm = bwd_times(full, prec, mode)
                for which, off, bnd in (("data", 0, tm[5]),
                                        ("filter", 2, tm[6])):
                    rows[variant(mode, which, bf16(kw))].update(
                        ms=tm[off], device_ms=tm[off + 1], plain_ms=tm[4],
                        bound_ms=bnd[0], bound_by=bnd[1])
                print(f"    trunk {variant(mode, 'fwd', bf16(kw))}: "
                      f"{row['ms']:.4f} ms (device {row['device_ms']:.4f}),"
                      f" plain {row['plain_ms']:.4f} ms, bound {b_ms:.5f} "
                      f"({b_by}); data {tm[0]:.4f} (device {tm[1]:.4f}), "
                      f"filter {tm[2]:.4f} (device {tm[3]:.4f}) ms")


def layers_phase(dev):
    """Phase 24 (d): ``SparseConv``, ``SparseConvTranspose`` (Linf
    searches on the card, nearest_neighbor kernels) and ``PointSampling``
    on phase 16's block snapped to a SPARSE_VOXEL grid, kernel [3, 3, 3],
    Cin 32 -> Cout 32, neighbor_k 32, seed-0 weights: card vs CPU within
    1e-5 of each output's max; the Linf search's lists card vs CPU
    exactly.  Returns {layer: relative error} and the launches."""
    from dmcf_tpu_torch.models.layers import (PointSampling, SparseConv,
                                              SparseConvTranspose)
    from dmcf_tpu_torch.ops.neighbors import fixed_radius_search
    from dmcf_tpu_torch.ops.windows import get_window_func

    pos, _, _ = liquid_scene()
    grid = (np.round(pos / SPARSE_VOXEL) * SPARSE_VOXEL).astype(np.float32)
    check(len(np.unique(np.round(grid / SPARSE_VOXEL), axis=0))
          == len(grid), "the snapped block's points are distinct")
    g = torch.Generator().manual_seed(0)
    pts = torch.from_numpy(grid)
    feats = torch.randn((len(grid), 32), generator=g)
    coarse = pts[::2].contiguous()
    layers = {
        "SparseConv": (SparseConv(32, 32, (3, 3, 3), generator=g),
                       (feats, pts, pts, SPARSE_VOXEL)),
        "SparseConvTranspose": (
            SparseConvTranspose(32, 32, (3, 3, 3), generator=g),
            (feats[::2].contiguous(), coarse, pts, SPARSE_VOXEL)),
        "PointSampling": (PointSampling(get_window_func("poly6")),
                          (feats, pts, coarse, 4 * SPARSE_VOXEL)),
    }
    radius = 3 * SPARSE_VOXEL * 0.51
    card = fixed_radius_search(pts.to(dev), pts.to(dev), radius, 32,
                               metric="Linf")
    host = fixed_radius_search(pts, pts, radius, 32, metric="Linf")
    check(all(torch.equal(x.cpu(), y) for x, y in zip(
        card[:4], host[:4])), "Linf search card vs CPU")
    print(f"  {len(grid)} points on the {SPARSE_VOXEL} grid; Linf search "
          f"(radius {radius:.4f}, K 32) card = CPU, neighbours a point "
          f"{int(card.count.min())}-{int(card.count.max())}")
    errs = {}
    zero_counts()
    for name, (layer, args) in layers.items():
        on_card = copy.deepcopy(layer).to(dev)
        with torch.no_grad():
            got = on_card(*(x.to(dev) if torch.is_tensor(x) else x
                            for x in args))
            want = layer(*args)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        err = float((got.cpu() - want).abs().max())
        print(f"  {name}: output {tuple(got.shape)}, card vs CPU {err:.3e} "
              f"of max {scale:.3e} (tol 1e-5 of it)")
        check(scale > 0 and err <= 1e-5 * scale, f"{name} card vs CPU {err}")
        errs[name] = err / scale
    launches = only_mode("nearest_neighbor", "sparse convs")
    check(launches[:2] == [2, 0], f"sparse convs' launches {launches}")
    return errs, launches


# ---------------------------------------------------------------------------
# phase 25: the multi-rank paths (``dmcf_tpu_torch/parallel``): data-parallel
# training and the slab-decomposed halo step over torch.distributed, one
# process a rank (``parallel.dist.spawn``; the rank bodies below)

MULTI_BLOCK = (100, 6, 22)   # 13,200 fluid in its full open box
MULTI_EXACT_STEPS = 3        # the halo rollout at "highest" vs one process
MULTI_STEPS = 20             # the timed bf16-trunk halo rollout
MULTI_CHUNK = 10
MULTI_TOL = 5e-5             # JAX's halo-rollout tolerance
DP_GRAD_TOL = 1e-5           # DP gradients vs one process (fp32), of each
#                              gradient's max
# The exactness check at "highest" runs Liquid3d's channels and radii
# with the overrides an exact single-process reference needs: the brute
# search (the cell search's window budget drops candidates on this
# scene, as on the canyon's: ROADMAP §3); pyramid caps with room (at the
# config's the scene's scale 1 drops 63 % of its voxels, and a slab would
# keep other voxels than the whole scene); and so pair (1, 2)'s K budget
# raised 1248 -> 1792 (its uncut scale 1 gives it 1,599 neighbours here:
# the budgets were sized on the canyon's contact set, where scale 1 is
# sparse).  The timed bf16-trunk rollout and its launch checks run the
# config as shipped: ``search_method: auto`` (the cell search at this
# size), its K budgets and its pyramid caps, as ``run_sample --spatial
# halo -c configs/Liquid3d.yml`` does.
MULTI_EXACT_OVERRIDES = {"search_method": "brute",
                         "scale_size_factor": [1.0, 1.5, 0.4],
                         "neighbor_k_pairs": [[96, 448, 2048],
                                              [448, 448, 2240],
                                              [384, 384, 384]]}
MULTI_HALO_ROOM = 1.5        # halo_cap over the largest zone's rows


def momentum_batch(cfg):
    """Phase 11's first seeded batch (loader seed 0, data scaled by 0.9),
    numpy."""
    from dmcf_tpu_torch.data import DatasetGroup, get_dataloader

    pcfg = cfg["pipeline"]
    group = DatasetGroup(split="train", cache_dir=None, **cfg["dataset"])
    dg = dict(pcfg["data_generator"], scale=[0.9, 0.9, 0.0])
    split = {k: v for k, v in dg.items() if k not in ("train", "valid",
                                                      "test")}
    loader = get_dataloader(group.train, batch_size=int(pcfg["batch_size"]),
                            window=int(pcfg["windows"][0]), **split,
                            **dict(dg["train"], seed=0))
    try:
        return next(loader)
    finally:
        loader.close()


def first_frame(batch, grav):
    """Item 0's first frame of a batch as a model sample (numpy), gravity
    rows ``grav`` where the batch has none."""
    s = {k: np.asarray(batch[k][0][0]) for k in ("pos", "vel")}
    for k in ("box", "box_normals", "fluid_mask", "box_mask"):
        s[k] = np.asarray(batch[k][0])
    g = batch.get("grav")
    s["grav"] = (np.asarray(g[0][0]) if g is not None else np.tile(
        np.float32([0.0, grav, 0.0]), (len(s["pos"]), 1)))
    return s


def _card_model(cfg, state, dev):
    from dmcf_tpu_torch.models import build_model

    model = build_model(dict(cfg), device=dev)
    model.load_state_dict(state)
    return model


def _momentum_step(model, cfg, group=None):
    from dmcf_tpu_torch.models.losses import get_loss
    from dmcf_tpu_torch.pipelines.simulator import (make_optimizer,
                                                    make_train_step)

    loss = {k: get_loss(**v) for k, v in cfg["model"]["loss"].items()}
    return make_train_step(model, loss, *make_optimizer(
        model, cfg["pipeline"]["optimizer"]),
        window=int(cfg["pipeline"]["windows"][0]), group=group)


def _on(batch, dev, group=None):
    from dmcf_tpu_torch.parallel import shard_batch

    if group is not None:
        batch = shard_batch(batch, group)
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()
            if v is not None}


def nccl_rank(group, cfg, state, batch):
    """Phase 25 (a), the one rank of an NCCL world: phase 11's momentum
    train step (the config's bf16 trunk) on one process and data-parallel
    (the collectives over NCCL), each from the same weights; and a
    one-slab halo step of the model at "highest" against its plain
    step."""
    from dmcf_tpu_torch.parallel import halo_model as hm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = group.device
    t0 = time.time()
    window = int(cfg["pipeline"]["windows"][0])
    time_w = np.ones(window, np.float32)
    models = [_card_model(cfg["model"], state, dev) for _ in range(2)]
    lvecs = []
    for m, g in zip(models, (None, group)):
        zero_counts()
        lvec, _, _ = _momentum_step(m, cfg, g)(_on(batch, dev, g), time_w)
        torch.cuda.synchronize()
        lvecs.append(lvec.cpu())
    dp_counts = counts()                # the DP step's launches
    t_train = time.time() - t0
    same = all(torch.equal(a, b) for a, b in zip(
        models[0].parameters(), models[1].parameters()))

    exact = _card_model(dict(cfg["model"], precision="highest"), state, dev)
    sample = first_frame(batch, float(exact.grav))
    width = 1.5 * hm.receptive_field(exact)
    parts = hm.partition_model_sample(sample, 1, width)
    step = hm.make_halo_model_step(exact, group, halo_width=width,
                                   halo_cap=16, axis=parts["axis"])
    zero_counts()
    with torch.no_grad():
        p, _, aux = step(hm.shard_model_parts(parts, 0, dev))
        halo_counts = counts()
        zero_counts()
        p1, _, _ = exact({k: torch.as_tensor(v, device=dev)
                          for k, v in sample.items()})
        plain_counts = counts()
    fm = sample["fluid_mask"].astype(bool)
    got = hm.gather_owned(parts, p, len(fm))
    return {"transport": group.transport, "same": same,
            "lvec": [v.tolist() for v in lvecs], "dp_counts": dp_counts,
            "halo_counts": halo_counts, "plain_counts": plain_counts,
            "halo_err": float(np.abs(got[fm] - p1.cpu().numpy()[fm]).max()),
            "halo_overflow": int(aux["halo_overflow"]),
            "n_fluid": int(fm.sum()), "train_s": t_train,
            "rank_s": time.time() - t0}


def gloo_rank(group, runs, state, sample, width, halo_cap, mcfg, mstate,
              mbatch):
    """Phase 25 (b), one of two gloo ranks on one card.  For each of
    ``runs`` ((name, model config, steps): Liquid3d at "highest" with
    MULTI_EXACT_OVERRIDES, then as shipped at its bf16 trunk): the halo
    step once with every K-list launch held against its plain version,
    then a ``halo_rollout_host`` of ``steps`` steps (chunk MULTI_CHUNK)
    timed between barriers; then the momentum train step at "highest"
    with one item a rank."""
    from dmcf_tpu_torch.parallel import halo_model as hm
    from dmcf_tpu_torch.profile_step import launch_log

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = group.device
    t_rank = time.time()
    out = {"transport": group.transport, "part_s": {}}
    max_err = {False: 0.0, True: 0.0}
    gparts = hm.partition_model_sample(sample, group.world_size, width,
                                       bcap_round=1024)
    mine = hm.shard_model_parts(gparts, group.rank, dev)
    fm = sample["fluid_mask"].astype(bool)
    for name, cfg, steps in runs:
        model = _card_model(cfg, state, dev)
        step = hm.make_halo_model_step(model, group, halo_width=width,
                                       halo_cap=halo_cap, axis=gparts["axis"])
        t0 = time.time()
        with launch_log(model) as log, torch.no_grad():
            _, _, aux = step(mine)
        torch.cuda.synchronize()
        out["part_s"][f"{name} first step"] = time.time() - t0
        t0 = time.time()
        launch_checks(log, f"rank {group.rank} {name}", max_err, show=False)
        out["part_s"][f"{name} launch checks"] = time.time() - t0
        out[f"{name}_checked"] = [sum(not bf16(kw) for _, _, kw, _ in log),
                                  sum(bf16(kw) for _, _, kw, _ in log)]
        out[f"{name}_scale_counts"] = aux["scale_counts"].tolist()
        del log
        torch.cuda.synchronize()
        group.barrier()
        zero_counts()                   # this rank's path starts here
        t0 = time.time()
        frames, report = hm.halo_rollout_host(
            model, group, sample, steps, chunk=MULTI_CHUNK,
            halo_width=width, halo_cap=halo_cap)
        torch.cuda.synchronize()
        group.barrier()
        out[f"{name}_seconds"] = time.time() - t0
        out[f"{name}_counts"] = counts()  # and ends here
        out[f"{name}_report"] = report
        out[f"{name}_has_frames"] = frames is not None  # rank 0 alone
        if frames is not None:
            out[f"{name}_finite"] = bool(np.isfinite(frames[:, fm]).all())
            if name == "exact":
                out["exact_frames"] = frames
        del model, step
        torch.cuda.empty_cache()
    out["max_err"] = max_err

    model = _card_model(dict(mcfg["model"], precision="highest"), mstate, dev)
    window = int(mcfg["pipeline"]["windows"][0])
    zero_counts()
    lvec, _, _ = _momentum_step(model, mcfg, group)(
        _on(mbatch, dev, group), np.ones(window, np.float32))
    torch.cuda.synchronize()
    out["dp_counts"] = counts()
    out["part_s"]["rank"] = time.time() - t_rank
    out["dp_lvec"] = lvec.tolist()
    out["dp_grads"] = {n: p.grad.cpu() for n, p in model.named_parameters()}
    return out


def parked_rows_check(pos, dev, radius=0.1, k=96, cell_cap=32, occ_cap=64):
    """The halo code's parked rows (pad rows from 1e9, unused send slots
    from 2e9, unmatched receive slots from 3e9 and 6e9; masked) beside
    ``pos`` in each cell-based search on the card, the hash-probe grid
    search and the sorted-window cell search that ``search_method: auto``
    picks at this size (``ops.neighbors.search``): they enter no cell
    table and use up no query's ``cell_cap`` or window (``occ_cap``), so
    the lists equal a search of ``pos`` alone and the CPU's (the cell
    coordinates saturate alike).  Returns the number of parked rows."""
    from dmcf_tpu_torch.ops.neighbors import search
    from dmcf_tpu_torch.parallel import halo

    slot = np.arange(16)[:, None]
    parked = np.concatenate([halo.PAD_FAR + slot * 7.0,
                             halo.HALO_FAR + slot, halo.RECV_FAR + slot,
                             2 * halo.RECV_FAR + slot])
    parked = np.repeat(parked, 3, 1).astype(np.float32)
    n = len(pos)
    full = torch.from_numpy(np.concatenate([pos, parked]))
    fmask = torch.arange(len(full)) < n
    for method in ("grid", "cell"):
        kw = dict(method=method, cell_cap=cell_cap, occ_cap=occ_cap)
        got = {d: search(full.to(d), full.to(d), radius, k,
                         points_mask=fmask.to(d), queries_mask=fmask.to(d),
                         **kw) for d in (dev, "cpu")}
        ref = search(full[:n].to(dev), full[:n].to(dev), radius, k, **kw)
        card = got[dev]
        for name in ("idx", "mask", "count", "cell_overflow"):
            a, b = getattr(card, name), getattr(ref, name)
            check(torch.equal(a[:n], b),
                  f"parked rows, {method} search: {name} as without them")
            check(torch.equal(a.cpu(), getattr(got["cpu"], name)),
                  f"parked rows, {method} search: {name} card = CPU")
        check(int(card.count[n:].max()) == 0
              and int(card.cell_overflow[n:].max()) == 0,
              f"parked rows, {method} search: they find nothing and "
              "overflow nothing")
    return len(parked)


def multi_rank_phase(root, dev, max_err, smi):
    """Phase 25: (a) an NCCL world of one rank, spawned: phase 11's
    momentum train step data-parallel, its parameters bit for bit those of
    the step on one process, and a one-slab halo step within 2e-5 of the
    plain step; (b) two gloo ranks on this card (``exchange`` through
    pinned host buffers): ``configs/Liquid3d.yml`` at full width on
    ``liquid_scene(MULTI_BLOCK)`` with its full boundary, no crop, the
    halo code's parked rows beside its fluid in the grid and cell searches
    (``parked_rows_check``), the halo rollout at "highest"
    (MULTI_EXACT_OVERRIDES) within MULTI_TOL of the rollout on one process
    with no halo, pair or voxel overflow and the voxel-count witness, the
    config as shipped at its bf16 trunk (the cell search, its K budgets
    and pyramid caps) timed over MULTI_STEPS steps with no halo overflow
    and its search and voxel overflows beside one process's, every K-list
    launch of each rank's first step of both against its plain version,
    and the momentum train step with one item a rank against the step on
    one process.  Two ranks share one card: no scale-out is measured.
    Returns the launches of each path (summed over the ranks) and the
    figures."""
    import yaml

    from dmcf_tpu_torch.models import build_model
    from dmcf_tpu_torch.models.layers import ContinuousConv
    from dmcf_tpu_torch.parallel import halo_model as hm
    from dmcf_tpu_torch.parallel.dist import spawn
    from dmcf_tpu_torch.parallel.halo import min_slab_width
    from dmcf_tpu_torch.rollout import rollout
    from dmcf_tpu_torch.scene import bench_sample

    t_phase = time.time()
    mcfg = momentum_cfg(root)
    batch = momentum_batch(mcfg)
    mmodel = build_model(mcfg["model"], device=dev,
                         generator=torch.Generator().manual_seed(42))
    mstate = {k: v.cpu() for k, v in mmodel.state_dict().items()}
    convs = sum(isinstance(m, ContinuousConv) for m in mmodel.modules())
    n_bf16 = sum(isinstance(m, ContinuousConv) and m.precision != "highest"
                 for m in mmodel.modules())
    items, window = int(mcfg["pipeline"]["batch_size"]), \
        int(mcfg["pipeline"]["windows"][0])

    part("(a) NCCL, world size 1, spawned")
    t0 = time.time()
    (a,) = spawn(nccl_rank, 1, backend="nccl", devices=["cuda:0"],
                 args=(mcfg, mstate, batch))
    want = expected_train_launches(items, window, convs, n_bf16)
    print(f"  ({smi}) {a['transport']}: momentum DP train step (batch "
          f"{items}, window {window}) parameters bitwise the one-process "
          f"step's: {a['same']}; loss vectors {a['lvec']}; DP launches "
          f"{a['dp_counts']} (want {want}); one-slab halo step vs plain "
          f"{a['halo_err']:.3e} on {a['n_fluid']} fluid, launches "
          f"{a['halo_counts'][:2]}; {time.time() - t0:.1f} s (the rank "
          f"{a['rank_s']:.1f} s, its two train steps {a['train_s']:.1f})")
    check(a["transport"] == "nccl", "(a) runs on NCCL")
    check(a["same"], "(a) DP parameters bitwise the one-process step's")
    check(a["dp_counts"] == want, f"(a) DP launches {a['dp_counts']}")
    check(a["halo_err"] <= 2e-5 and a["halo_overflow"] == 0,
          f"(a) one-slab halo step {a['halo_err']}")
    check(a["halo_counts"] == a["plain_counts"],
          f"(a) halo step launches {a['halo_counts']}, plain "
          f"{a['plain_counts']}")

    part("(b) gloo, 2 ranks on cuda:0")
    with open(os.path.join(root, "configs", "Liquid3d.yml")) as f:
        cfg = dict(yaml.safe_load(f)["model"])          # as shipped
    xcfg = dict(cfg, precision="highest", **MULTI_EXACT_OVERRIDES)
    pos, box, nrm = liquid_scene(MULTI_BLOCK)
    tsample = bench_sample(pos, box, nrm, device=dev)
    sample = {k: v.cpu().numpy() for k, v in tsample.items()}
    exact = build_model(xcfg, device=dev,
                        generator=torch.Generator().manual_seed(0))
    state = {k: v.cpu() for k, v in exact.state_dict().items()}
    rf = hm.receptive_field(exact)
    width = 1.5 * rf
    gparts = hm.partition_model_sample(sample, 2, width, bcap_round=1024)
    zones = hm.zone_rows(gparts, width)
    # a rank's exchange buffer: MULTI_HALO_ROOM x the largest zone (JAX's
    # default doubles it: with two ranks each has one neighbour, so half
    # of its halo slots stay empty anyway)
    halo_cap = int(-(-int(MULTI_HALO_ROOM * zones.max()) // 16) * 16)
    # the exact ranks' pyramid caps: the one process's in rows (a rank's
    # rows, owned + halo slots + its boundary slice, are more; the voxels
    # they stamp are fewer)
    rows_1 = tsample["pos"].shape[0] + tsample["box"].shape[0]
    rows_rank = gparts["cap"] + 2 * halo_cap + gparts["box"].shape[1]
    xcfg_rank = dict(xcfg, scale_size_factor=[
        f * rows_1 / rows_rank for f in xcfg["scale_size_factor"]])
    owned = gparts["mask"].sum(1)
    recv = [int(zones[1, 0]), int(zones[0, 1])]     # rank 0 <- 1, 1 <- 0
    ax = gparts["axis"]
    extent = [float(np.ptp(gparts["pos"][d][gparts["mask"][d], ax]))
              for d in range(2)]
    n_parked = parked_rows_check(pos, dev)
    print(f"  {n_parked} parked rows beside the {len(pos)} fluid in the grid "
          f"and cell searches: no cell table entry, no cell_cap or window "
          f"used, card = CPU")
    print(f"  scene: {len(pos)} fluid (block {MULTI_BLOCK}) + {len(box)} "
          f"boundary, no crop; rf {rf:.3f}, halo width {width:.3f}, "
          f"halo_cap {halo_cap}, min slab width "
          f"{min_slab_width(gparts['bounds'])} (the two end slabs are "
          f"open), slabs' fluid extent along axis {ax}: {extent}; owned "
          f"rows {owned.tolist()}, halo rows received {recv}, boundary "
          f"rows a rank {gparts['box_mask'].sum(1).tolist()} of "
          f"{gparts['box'].shape[1]}; rows a rank {rows_rank} (one process "
          f"{rows_1})")
    check(min(extent) >= width, f"each slab {extent} at least the halo "
          f"width {width}")

    # one process: the reference frames, each run's first-step launches,
    # and the shipped config's rollout timed beside the ranks'
    n = tsample["pos"].shape[0]
    frames = (torch.empty((MULTI_EXACT_STEPS + 1, n, 3), device=dev),
              torch.empty((MULTI_EXACT_STEPS + 1, n, 3), device=dev))
    zero_counts()
    with torch.no_grad():
        _, _, aux1 = exact(tsample)
    step_counts = counts()[:2]
    _, _, gate1 = rollout(exact, tsample, MULTI_EXACT_STEPS, frames=frames)
    want_frames = frames[0][1:].cpu().numpy()
    shipped = build_model(cfg, device=dev)
    shipped.load_state_dict(state)
    zero_counts()
    with torch.no_grad():
        shipped(tsample)
    bf_counts = counts()[:2]
    torch.cuda.synchronize()
    t0 = time.time()
    _, _, gate16 = rollout(shipped, tsample, MULTI_STEPS)
    torch.cuda.synchronize()
    ms1 = 1e3 * (time.time() - t0) / MULTI_STEPS
    print(f"  one process: {MULTI_EXACT_STEPS}-step rollout at highest "
          f"(exactness overrides), gate {gate1}; a step's launches (fp32, "
          f"bf16) {step_counts} there, {bf_counts} as shipped; ({smi}) "
          f"the shipped config's rollout {ms1:.1f} ms/step over "
          f"{MULTI_STEPS} steps, gate {gate16}")
    check(gate1["exact"] and gate1["scales_fit"],
          f"the one-process rollout is exact with its scales fitting {gate1}")
    mref = build_model(dict(mcfg["model"], precision="highest"), device=dev)
    mref.load_state_dict(mstate)
    lref, _, _ = _momentum_step(mref, mcfg)(_on(batch, dev),
                                            np.ones(window, np.float32))
    del exact, shipped
    torch.cuda.empty_cache()

    t0 = time.time()
    runs = [("exact", xcfg_rank, MULTI_EXACT_STEPS),
            ("shipped", cfg, MULTI_STEPS)]
    ranks = spawn(gloo_rank, 2, backend="gloo",
                  devices=["cuda:0", "cuda:0"],
                  args=(runs, state, sample, width, halo_cap, mcfg, mstate,
                        batch))
    spawn_s = time.time() - t0
    fm = sample["fluid_mask"].astype(bool)
    r0 = ranks[0]
    err = float(np.abs(r0["exact_frames"][:, fm] - want_frames[:, fm]).max())
    rep, rep16 = r0["exact_report"], r0["shipped_report"]
    for name in ("exact", "shipped"):
        check(r0[f"{name}_finite"], f"(b) finite {name} rollout")
        check([r[f"{name}_has_frames"] for r in ranks] == [True, False],
              f"(b) the {name} frames gather on rank 0 alone")
    for r in ranks:
        check(r["transport"] == "gloo via pinned host memory",
              f"(b) transport {r['transport']}")
        for name in ("exact", "shipped"):
            check(r[f"{name}_report"] == r0[f"{name}_report"],
                  f"(b) every rank's {name} report alike")
        for half in (False, True):
            max_err[half] = max(max_err[half], r["max_err"][half])
    print("  rank seconds: " + "; ".join(
        f"rank {i} " + ", ".join(f"{k} {v:.1f}"
                                 for k, v in r["part_s"].items())
        for i, r in enumerate(ranks)))
    counts_sh = np.asarray(r0["exact_scale_counts"])     # [D, n_scales]
    counts_1 = aux1["scale_counts"].cpu().numpy()
    witness = all(counts_sh[:, s].sum() >= counts_1[s]
                  and (counts_sh[:, s] <= counts_1[s]).all()
                  for s in range(1, len(counts_1)))
    paths = {
        "halo_exact": [sum(r["exact_counts"][i] for r in ranks)
                       for i in range(6)],
        "halo_rollout": [sum(r["shipped_counts"][i] for r in ranks)
                         for i in range(6)],
        "dp_train_gloo": [sum(r["dp_counts"][i] for r in ranks)
                          for i in range(6)],
        "dp_train_nccl": a["dp_counts"]}
    want_exact = [2 * MULTI_EXACT_STEPS * c for c in step_counts]
    want_roll = [2 * MULTI_STEPS * c for c in bf_counts]
    ms16 = 1e3 * r0["shipped_seconds"] / MULTI_STEPS
    # the halo report's name of each gate figure, and the rollout gate's
    gate_keys = (("pair_overflow", "pair_overflow"),
                 ("neighbor_overflow", "max_neighbors"),
                 ("cell_overflow", "cell_overflow"),
                 ("scale_counts", "scale_counts"),
                 ("scale_caps", "scale_caps"), ("scales_fit", "scales_fit"))
    print(f"  ({smi}) halo rollout at highest: {MULTI_EXACT_STEPS} steps "
          f"within {err:.3e} of one process (tol {MULTI_TOL}), report "
          f"{rep}, first-step voxel counts a rank {counts_sh.tolist()} vs "
          f"one process {counts_1.tolist()} (witness {witness}), "
          f"{1e3 * r0['exact_seconds'] / MULTI_EXACT_STEPS:.1f} ms/step")
    print(f"  ({smi}) halo rollout of the shipped config (bf16 trunk): "
          f"{MULTI_STEPS} steps, chunk {MULTI_CHUNK}, {ms16:.1f} ms/step on "
          f"2 ranks sharing one card (no scale-out; one process "
          f"{ms1:.1f}), report {rep16}")
    print("  shipped config, the ranks' rollout vs one process's: " + "; ".join(
        f"{k} {rep16.get(k)} vs {gate16.get(g)}" for k, g in gate_keys))
    print(f"  K-list launches checked against the plain version: "
          + "; ".join(f"rank {i} {r['exact_checked']} (highest), "
                      f"{r['shipped_checked']} (shipped, bf16 trunk)"
                      for i, r in enumerate(ranks))
          + f"; max_abs_err fp32 {max(r['max_err'][False] for r in ranks):.3e}"
          f" bf16 {max(r['max_err'][True] for r in ranks):.3e}")
    print(f"  launches (fwd fp32, bf16, data fp32, bf16, filter fp32, bf16) "
          f"{paths} (halo_exact want {want_exact[:2]}, halo_rollout "
          f"{want_roll[:2]})")
    check(err <= MULTI_TOL, f"(b) halo rollout vs one process {err}")
    check(rep["halo_overflow"] == 0 and rep["pair_overflow"] <= 0
          and rep["neighbor_overflow"] <= int(xcfg["neighbor_k"])
          and rep.get("cell_overflow", 0) == 0 and rep["scales_fit"],
          f"(b) the exact halo rollout's gate {rep}")
    check(rep["repartitions"] == 0, "(b) no re-partition in 3 steps")
    check(witness, "(b) the voxel-count witness")
    check(rep16["halo_overflow"] == 0,
          f"(b) the shipped halo rollout's exchange {rep16}")
    check(paths["halo_exact"][:2] == want_exact[:2],
          f"(b) halo_exact launches {paths['halo_exact']}")
    check(paths["halo_rollout"][:2] == want_roll[:2],
          f"(b) halo_rollout launches {paths['halo_rollout']}")
    check(all(r["exact_checked"] == step_counts
              and r["shipped_checked"] == bf_counts for r in ranks),
          "(b) every launch of each rank's first steps checked")

    # data parallel, one item a rank, against one process (fp32)
    dp_err = 0.0
    for r in ranks:
        np.testing.assert_allclose(r["dp_lvec"], lref.tolist(), rtol=2e-4)
        for name, p in mref.named_parameters():
            g, scale = r["dp_grads"][name], float(p.grad.abs().max())
            e = float((g - p.grad.cpu()).abs().max())
            check(e <= DP_GRAD_TOL * scale or e == 0.0,
                  f"(b) DP gradient {name} {e} > {DP_GRAD_TOL} x {scale}")
            dp_err = max(dp_err, e / scale if scale else e)
    want_dp = expected_train_launches(items, window, convs, 0)
    print(f"  ({smi}) momentum DP train step at highest, one item a rank: "
          f"gradients within {dp_err:.2e} of each one's max (tol "
          f"{DP_GRAD_TOL}), launches {paths['dp_train_gloo']} (want "
          f"{want_dp}); spawn and ranks {spawn_s:.1f} s; phase "
          f"{time.time() - t_phase:.1f} s")
    check(paths["dp_train_gloo"] == want_dp,
          f"(b) DP launches {paths['dp_train_gloo']}")
    return {"paths": paths, "ms_per_step": ms16, "ms_per_step_1": ms1,
            "exact_err": err, "gate_1": gate16,
            "dp_grad_rel_err": dp_err, "report": rep16, "halo_cap": halo_cap,
            "width": width, "rf": rf, "owned": owned.tolist(),
            "received": recv, "nccl": a, "seconds": time.time() - t_phase}


# ---------------------------------------------------------------------------
# phase 26: the particle-sharded step (``parallel/spatial.make_sharded_step``):
# every rank holds every point and searches and convolves its own block of
# each point set's query rows on the K-list kernels, one spawned process a
# rank (the rank bodies below)

SHARDED_STEPS = 20           # (b): the timed bf16-trunk sharded rollout
SHARDED_TOL = 1e-5           # positions, sharded step vs one process


def on_card(sample, dev):
    return {k: None if v is None else torch.as_tensor(v, device=dev)
            for k, v in sample.items()}


def even_rows(sample, world):
    """``sample`` (numpy) with each particle array padded by masked rows
    to a multiple of ``world`` rows (``shard_sample`` splits evenly)."""
    out = dict(sample)
    for keys, mask in ((("pos", "vel", "grav"), "fluid_mask"),
                       (("box", "box_normals"), "box_mask")):
        n = len(sample[mask])
        pad = -n % world
        for k in keys + (mask,):
            if sample.get(k) is not None and pad:
                v = np.asarray(sample[k])
                out[k] = np.concatenate(
                    [v, np.zeros((pad,) + v.shape[1:], v.dtype)])
    return out


def aux_cpu(aux):
    """A step's aux on the CPU (the pair details as ints)."""
    return {k: ({a: int(b) for a, b in v.items()} if isinstance(v, dict)
                else v.detach().cpu()) for k, v in aux.items()}


def aux_diff(got, want):
    """The keys of two aux dicts (``aux_cpu``) that differ: every value
    equal but the position correction, held within SHARDED_TOL."""
    bad = sorted(set(got) ^ set(want))
    for k in set(got) & set(want):
        a, b = got[k], want[k]
        if isinstance(b, dict):
            same = a == b
        elif k == "pos_correction":
            same = float((a - b).abs().max()) <= SHARDED_TOL
        else:
            same = torch.equal(a, b)
        if not same:
            bad.append(k)
    return bad


def sharded_nccl_rank(group, cfg, state, sample):
    """Phase 26 (a), the one rank of an NCCL world: WaterRamps' SymNet at
    its precision, the sharded step against the one-process step, bit for
    bit, and each one's K-list launches."""
    from dmcf_tpu_torch.parallel.spatial import (make_sharded_step,
                                                 shard_sample)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = group.device
    model = _card_model(cfg, state, dev)
    s = on_card(sample, dev)
    zero_counts()
    with torch.no_grad():
        p1, v1, a1 = model(s)
    one = counts()[:2]
    step = make_sharded_step(model, group)
    zero_counts()
    p, v, a = step(shard_sample(s, group))
    torch.cuda.synchronize()
    sharded = counts()[:2]
    return {"transport": group.transport, "one_counts": one,
            "counts": sharded,
            "same": torch.equal(p, p1) and torch.equal(v, v1)
            and not aux_diff(aux_cpu(a), aux_cpu(a1)),
            "gathers": step.split.gathers,
            "gather_bytes": step.split.gather_bytes,
            "reductions": step.split.reductions}


def sharded_gloo_rank(group, cfg, state, sample, steps, exact_runs):
    """Phase 26 (b)-(c), one of two gloo ranks on one card.  (b)
    WaterRamps' SymNet at its bf16 trunk: the first sharded step with
    every K-list launch held against its plain version (each launch's
    query rows kept), then a ``steps``-step sharded rollout, each step fed
    this rank's own output blocks, timed between barriers, the exactness
    gate read every step; then one sharded step of each of
    ``exact_runs`` ((name, model config, state, numpy sample)), its
    blocks, aux and launches (K-list fp32, bf16, FPS)."""
    from dmcf_tpu_torch.parallel.spatial import (make_sharded_step,
                                                 shard_sample)
    from dmcf_tpu_torch.profile_step import launch_log

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = group.device
    t_rank = time.time()
    out = {"transport": group.transport, "part_s": {}}
    max_err = {False: 0.0, True: 0.0}
    model = _card_model(cfg, state, dev)
    step = make_sharded_step(model, group)
    mine = on_card(shard_sample(sample, group), dev)
    zero_counts()
    with launch_log(model) as log:
        step(mine)
    torch.cuda.synchronize()
    out["first_counts"] = counts()[:2]
    out["split"] = [step.split.gathers, step.split.gather_bytes,
                    step.split.reductions]
    t0 = time.time()
    launch_checks(log, f"rank {group.rank}", max_err, show=False)
    out["part_s"]["launch checks"] = time.time() - t0
    out["rows"] = [args[0].shape[0] for _, args, _, _ in log]
    out["checked"] = counts_of(log)
    out["max_err"] = max_err
    del log

    k = int(model.neighbor_k)
    gates = []
    torch.cuda.synchronize()
    group.barrier()
    zero_counts()                       # this rank's rollout starts here
    t0 = time.time()
    for _ in range(steps):
        p, v, aux = step(mine)
        mine = dict(mine, pos=p, vel=v)
        gates.append([int(aux["pair_overflow"]),
                      int(aux["neighbor_overflow"])])
    torch.cuda.synchronize()
    group.barrier()
    out["seconds"] = time.time() - t0
    out["counts"] = counts()[:2]        # and ends here
    out["gates"] = gates
    out["exact"] = all(e <= 0 and n <= k for e, n in gates)
    fm = mine["fluid_mask"].bool()
    out["finite"] = bool(torch.isfinite(mine["pos"][fm]).all())
    del model, step
    for name, rcfg, rstate, rsample in exact_runs:
        t0 = time.time()
        model = _card_model(rcfg, rstate, dev)
        step = make_sharded_step(model, group)
        zero_counts()
        p, v, aux = step(on_card(shard_sample(rsample, group), dev))
        torch.cuda.synchronize()
        out[name] = {"pos": p.cpu(), "vel": v.cpu(), "aux": aux_cpu(aux),
                     "counts": counts()[:2] + [fps_launches()],
                     "split": [step.split.gathers, step.split.gather_bytes,
                               step.split.reductions]}
        out["part_s"][name] = time.time() - t0
        del model, step
        torch.cuda.empty_cache()
    out["part_s"]["rank"] = time.time() - t_rank
    return out


def sharded_phase(root, dev, max_err, smi):
    """Phase 26: the particle-sharded step.  (a) An NCCL world of one
    rank, spawned: WaterRamps' SymNet at full width and depth (its bf16
    trunk, seed-0 weights) on the bench scene, the sharded step bit for
    bit the one-process step.  (b) Two gloo ranks sharing the card: the
    same model's first sharded step with every K-list launch of each
    rank against its plain version (one process's 18 bf16 + 1 fp32
    launches a rank, each at most ceil(Q/2) query rows), a timed
    SHARDED_STEPS-step sharded rollout under the exactness gate beside one
    process's, and one step at "highest" against one process.  (c) On
    the same ranks, paths the halo step cannot run, one step each at
    "highest" against one process: path B (``column/hrnet.yml`` with the
    farthest-point pyramid, ``transpose_search_reuse``, ``equivar``,
    circular kernels: the FPS kernel on each rank) and
    ``configs/Liquid3d.yml`` as shipped on ``liquid_scene(MULTI_BLOCK)``
    (the cell search, its K budgets and caps: overflows included).  Two
    ranks share one card: no scale-out is measured.  Returns the
    launches and the figures."""
    import yaml

    from dmcf_tpu_torch.models import build_model
    from dmcf_tpu_torch.parallel.dist import spawn
    from dmcf_tpu_torch.profile_step import record_launches
    from dmcf_tpu_torch.scene import bench_sample, build_scene

    t_phase = time.time()
    with open(os.path.join(root, "configs", "WaterRamps.yml")) as f:
        wcfg = yaml.safe_load(f)["model"]
    tsample = bench_sample(*build_scene(), device=dev)
    sample = {k: v.cpu().numpy() for k, v in tsample.items()}
    model = build_model(wcfg, device=dev,
                        generator=torch.Generator().manual_seed(0))
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    n_rows = len(sample["pos"]) + len(sample["box"])

    part("(a) NCCL, world size 1, spawned")
    t0 = time.time()
    (a,) = spawn(sharded_nccl_rank, 1, backend="nccl", devices=["cuda:0"],
                 args=(wcfg, state, sample))
    print(f"  ({smi}) {a['transport']}: WaterRamps SymNet (bf16 trunk) on "
          f"{int(sample['fluid_mask'].sum())} fluid + "
          f"{int(sample['box_mask'].sum())} boundary ({n_rows} rows): the "
          f"sharded step bitwise the one-process step: {a['same']}; "
          f"launches {a['counts']} (one process {a['one_counts']}); "
          f"{a['gathers']} all-gathers ({a['gather_bytes']} B), "
          f"{a['reductions']} reductions; {time.time() - t0:.1f} s")
    check(a["transport"] == "nccl", "(a) runs on NCCL")
    check(a["same"], "(a) the sharded step at world size 1 is bitwise the "
          "one-process step")
    check(a["counts"] == a["one_counts"] == [1, 18],
          f"(a) launches {a['counts']}, one process {a['one_counts']}")

    # one process: the bf16 step's launches, its rollout timed as the
    # ranks' (the gate read every step), and each exact run's step
    (_, _, _), one_log = record_launches(model, tsample)
    one_rows = [args[0].shape[0] for _, args, _, _ in one_log]
    step_counts = counts_of(one_log)
    k = int(model.neighbor_k)
    with torch.no_grad():
        model(tsample)                               # warm-up step
        torch.cuda.synchronize()
        cur, gates1 = dict(tsample), []
        t0 = time.time()
        for _ in range(SHARDED_STEPS):
            p, v, aux = model(cur)
            cur = dict(cur, pos=p, vel=v)
            gates1.append([int(aux["pair_overflow"]),
                           int(aux["neighbor_overflow"])])
        torch.cuda.synchronize()
    ms1 = 1e3 * (time.time() - t0) / SHARDED_STEPS
    exact1 = all(e <= 0 and n <= k for e, n in gates1)
    del model
    exact_runs, refs = [], {}
    with open(os.path.join(root, "configs", "column", "hrnet.yml")) as f:
        bcfg = dict(yaml.safe_load(f)["model"], **PATH_B,
                    precision="highest")
    with open(os.path.join(root, "configs", "Liquid3d.yml")) as f:
        lcfg = dict(yaml.safe_load(f)["model"], precision="highest")
    lsample = {k_: v.cpu().numpy() for k_, v in bench_sample(
        *liquid_scene(MULTI_BLOCK), device=dev).items()}
    for name, cfg, smp in (
            ("waterramps", dict(wcfg, precision="highest"), sample),
            ("path_b", bcfg, even_rows({
                k_: v.cpu().numpy()
                for k_, v in path_b_sample(root, dev).items()}, 2)),
            ("liquid3d", lcfg, lsample)):
        m = build_model(cfg, device=dev,
                        generator=torch.Generator().manual_seed(0))
        zero_counts()
        with torch.no_grad():
            p, v, aux = m(on_card(smp, dev))
        torch.cuda.synchronize()
        refs[name] = {"pos": p.cpu(), "vel": v.cpu(), "aux": aux_cpu(aux),
                      "counts": counts()[:2] + [fps_launches()],
                      "rows": len(smp["pos"]) + len(smp["box"]),
                      "fm": torch.from_numpy(smp["fluid_mask"].astype(bool)),
                      "fluid": int(smp["fluid_mask"].sum()),
                      "boundary": int(smp["box_mask"].sum())}
        exact_runs.append((name, cfg, {k_: v.cpu() for k_, v in
                                       m.state_dict().items()}, smp))
        del m
    torch.cuda.empty_cache()

    part("(b)-(c) gloo, 2 ranks on cuda:0")
    t0 = time.time()
    ranks = spawn(sharded_gloo_rank, 2, backend="gloo",
                  devices=["cuda:0", "cuda:0"],
                  args=(wcfg, state, sample, SHARDED_STEPS, exact_runs))
    spawn_s = time.time() - t0
    for i, r in enumerate(ranks):
        check(r["transport"] == "gloo via pinned host memory",
              f"(b) rank {i} transport {r['transport']}")
        for half in (False, True):
            max_err[half] = max(max_err[half], r["max_err"][half])
        check(r["checked"] == step_counts == [1, 18]
              and r["first_counts"] == step_counts,
              f"(b) rank {i} first-step launches {r['checked']}, one "
              f"process {step_counts}")
        check(len(r["rows"]) == len(one_rows) and all(
            q <= -(-n // 2) for q, n in zip(r["rows"], one_rows)),
              f"(b) rank {i} launch rows {r['rows']} vs one process "
              f"{one_rows}")
        check(r["finite"], f"(b) rank {i} finite rollout")
        check(r["exact"], f"(b) rank {i} exactness gate {r['gates']}")
        check(r["counts"] == [SHARDED_STEPS * c for c in step_counts],
              f"(b) rank {i} rollout launches {r['counts']}")
    ms2 = 1e3 * max(r["seconds"] for r in ranks) / SHARDED_STEPS
    print("  rank seconds: " + "; ".join(
        f"rank {i} " + ", ".join(f"{k_} {v:.1f}"
                                 for k_, v in r["part_s"].items())
        for i, r in enumerate(ranks)))
    print(f"  (b) first sharded step of each rank: launches "
          f"{[r['checked'] for r in ranks]} (one process {step_counts}), "
          f"query rows a launch rank 0 {ranks[0]['rows']}, rank 1 "
          f"{ranks[1]['rows']} of {one_rows}; all-gathers a step "
          f"{ranks[0]['split'][0]} ({ranks[0]['split'][1]} B gathered), "
          f"reductions {ranks[0]['split'][2]}; max_abs_err fp32 "
          f"{max(r['max_err'][False] for r in ranks):.3e} bf16 "
          f"{max(r['max_err'][True] for r in ranks):.3e}")
    print(f"  ({smi}) (b) {SHARDED_STEPS}-step sharded rollout (bf16 "
          f"trunk): {ms2:.1f} ms/step on 2 ranks sharing one card (no "
          f"scale-out), one process {ms1:.1f} ms/step; gate exact every "
          f"step: ranks {[r['exact'] for r in ranks]}, one process "
          f"{exact1}; launches a rank {[r['counts'] for r in ranks]}")
    figures = {}
    for name, ref in refs.items():
        got_p = torch.cat([r[name]["pos"] for r in ranks])
        got_v = torch.cat([r[name]["vel"] for r in ranks])
        fm = ref["fm"]
        err = float((got_p - ref["pos"])[fm].abs().max())
        verr = float((got_v - ref["vel"])[fm].abs().max())
        bitwise = torch.equal(got_p, ref["pos"]) and torch.equal(
            got_v, ref["vel"])
        bad = [aux_diff(r[name]["aux"], ref["aux"]) for r in ranks]
        aux = ref["aux"]
        over = {k_: aux[k_].tolist() if torch.is_tensor(aux[k_])
                else aux[k_] for k_ in ("neighbor_overflow", "pair_overflow",
                                        "cell_overflow", "scale_counts",
                                        "scale_caps") if k_ in aux}
        print(f"  ({smi}) {name} at highest ({ref['fluid']} fluid + "
              f"{ref['boundary']} boundary, {ref['rows']} rows): sharded "
              f"vs one process positions {err:.3e}, velocities "
              f"{verr:.3e}, bitwise {bitwise}; aux keys that differ "
              f"{bad}; one process's overflows {over}; launches a rank "
              f"(K-list fp32, bf16, FPS) "
              f"{[r[name]['counts'] for r in ranks]}, one process "
              f"{ref['counts']}; all-gathers a step "
              f"{ranks[0][name]['split']}")
        check(err <= SHARDED_TOL, f"{name}: sharded vs one process {err}")
        check(not any(bad), f"{name}: aux differs in {bad}")
        check(all(r[name]["counts"] == ref["counts"] for r in ranks),
              f"{name}: each rank's launches as one process's")
        figures[name] = {"pos_err": err, "vel_err": verr,
                         "bitwise": bitwise, "overflows": over,
                         "split": ranks[0][name]["split"]}
    check(refs["path_b"]["counts"][2] == 3, "path B: the FPS kernel on "
          "each rank, 3 launches a step")
    paths = {"sharded_nccl": a["counts"],
             "sharded_first_step": [sum(r["first_counts"][i] for r in ranks)
                                    for i in range(2)],
             "sharded_rollout": [sum(r["counts"][i] for r in ranks)
                                 for i in range(2)],
             "sharded_exact": [sum(r[n]["counts"][i] for r in ranks
                                   for n in refs) for i in range(3)]}
    print(f"  launches (K-list fp32, bf16; FPS last in sharded_exact), "
          f"summed over the ranks: {paths}; spawn and ranks {spawn_s:.1f} "
          f"s; phase {time.time() - t_phase:.1f} s")
    return {"paths": paths, "ms_per_step": ms2, "ms_per_step_1": ms1,
            "split": ranks[0]["split"], "figures": figures, "nccl": a,
            "seconds": time.time() - t_phase}


def main(argv):
    steps = int(argv[argv.index("--steps") + 1]) if "--steps" in argv \
        else HORIZON
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA device", file=sys.stderr)
        return 2

    from dmcf_tpu_torch.bench import timed_rollout
    from dmcf_tpu_torch.kernels import build
    from dmcf_tpu_torch.kernels.cconv_klist import (cconv_klist,
                                                    cconv_klist_reference)
    from dmcf_tpu_torch.models import build_model
    from dmcf_tpu_torch.profile_step import (graph_ms, print_report, profile,
                                             record_launches)
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
    t0 = time.time()
    with ThreadPoolExecutor() as pool:  # one nvcc a source, all at once
        logs = dict(zip(build.sources(),
                        pool.map(build.build, build.sources())))
    print(f"built {len(logs)} sources in {time.time() - t0:.1f} s")
    for name, log in logs.items():
        print(f"{name}: {'compiled' if log else 'already built'}")
        for line in log.splitlines():
            if "entry function" in line:  # the variant: <kSym, kTaps,
                print(f"  {line.split(chr(39))[1]}")  # kBF16> and so on
            if "registers" in line or "spill" in line:
                print(f"  {line.strip()}")
    lib = build.load_library("cconv_klist")
    for cin, cout, sym, half in ((32, 32, 0, 0), (32, 32, 0, 1),
                                 (4, 8, 0, 1), (32, 2, 1, 0)):
        print(f"  dynamic shared memory, S 64 Cin {cin} Cout {cout} sym "
              f"{sym} bf16 {half}: "
              f"{lib.cconv_klist_smem_bytes(cin, cout, 1, 8, 8, sym, half)}"
              f" B a block")

    phase("3 kernel vs plain twin")
    with open(os.path.join(root, "configs", "WaterRamps.yml")) as f:
        cfg = yaml.safe_load(f)["model"]
    pos, box, nrm = build_scene()
    sample = bench_sample(pos, box, nrm, device=dev)
    shapes = waterramps_shapes(cfg, sample, dev)
    q, k = shapes["trunk"][0].shape
    ksize = shapes["trunk"][5]
    max_err = {False: 0.0, True: 0.0}
    checks = [(name, "highest") for name in shapes] + [("trunk", "default")]
    for name, prec in checks:
        i_, a_, t_, f_, w_, ks_, qf_ = shapes[name]
        kw = dict(qfeats=qf_, precision=prec)
        got = cconv_klist(i_, a_, t_, f_, w_, ks_, **kw)
        again = cconv_klist(i_, a_, t_, f_, w_, ks_, **kw)
        torch.cuda.synchronize()
        what = f"{name} {'bf16' if bf16(kw) else 'fp32'}"
        check(torch.equal(got, again), f"{what}: two launches bitwise equal")
        ref = cconv_klist_reference(i_, a_, t_, f_, w_, ks_, **kw)
        err = fwd_check(what, got, ref, kw)
        ratio = float((got.sum(0).abs() / got.abs().sum()).max())
        print(f"{what}: Q {q} K {k} Cin {f_.shape[1]} Cout {w_.shape[1]} "
              f"max_abs_err {err:.3e} (tol "
              f"{BF16_TOL * float(ref.abs().max()) if bf16(kw) else TOL:.3e})"
              f" momentum_ratio {ratio:.3e}")
        if name == "ascc":
            check(ratio < 1e-5, f"ASCC momentum ratio {ratio} < 1e-5")
        max_err[bf16(kw)] = max(max_err[bf16(kw)], err)
    trunk = {}
    i_, a_, t_, f_, w_, _, _ = shapes["trunk"]
    for prec in ("highest", "default"):
        kw = dict(precision=prec)
        kargs = kernel_args((i_, a_, t_, f_, w_, ksize), kw)
        trunk[prec] = dict(
            ms=cuda_ms(lambda: cconv_klist(*kargs, **kw)),
            device_ms=graph_ms(lambda: cconv_klist(*kargs, **kw)),
            plain_ms=cuda_ms(lambda: cconv_klist_reference(
                i_, a_, t_, f_, w_, ksize, **kw)))
        b_ms, b_by, nbytes, ops = bound(i_, a_, t_, f_, w_, ksize, None,
                                        prec)
        trunk[prec].update(bound_ms=b_ms, bound_by=b_by)
        tm = trunk[prec]
        print(f"trunk shape {'bf16' if bf16(kw) else 'fp32'}: kernel "
              f"{tm['ms']:.4f} ms (device time {tm['device_ms']:.4f}), "
              f"plain twin {tm['plain_ms']:.4f} ms, bound {b_ms:.5f} ms "
              f"({b_by}: {nbytes} B, {ops} FLOP), share of bound "
              f"{b_ms / tm['ms']:.3f} (of device time "
              f"{b_ms / tm['device_ms']:.3f})")

    phase("3b FPS kernel vs its plain version under every schedule")
    fps_check = fps_kernel_phase(dev)

    phase("4 one WaterRamps SymNet step (the config's precision: a bf16 "
          "trunk)")
    model = build_model(cfg, device=dev,
                        generator=torch.Generator().manual_seed(0))
    check(model.precision == "default", f"precision {model.precision}")
    zero_counts()              # main path starts here
    t0 = time.time()
    # keeps each kernel launch of this step (its conv's module name, inputs
    # and output) for phase 6
    (p1, v1, aux), launch_log = record_launches(model, sample)
    torch.cuda.synchronize()
    fm = sample["fluid_mask"]
    check(p1.shape == sample["pos"].shape, "step output shape")
    check(bool(torch.isfinite(p1[fm]).all() and torch.isfinite(v1[fm]).all()),
          "finite step output")
    step_launches = counts()[:2]
    print(f"first step {1e3 * (time.time() - t0):.1f} ms, kernel launches "
          f"fp32 {step_launches[0]} bf16 {step_launches[1]}, "
          f"neighbor_overflow {int(aux['neighbor_overflow'])}, pair_overflow "
          f"{int(aux['pair_overflow'])}, scale_counts "
          f"{aux['scale_counts'].tolist()} caps "
          f"{aux['scale_caps'].tolist()}")
    check(step_launches == [1, 18] and len(launch_log) == 19,
          f"{step_launches} fp32/bf16 kernel launches per step")

    phase(f"5 rollout ({steps} steps, the bench's timed rollout, bf16 "
          "trunk)")
    pos, vel, gate, dt = timed_rollout(model, sample, steps)
    launches = counts()[:2]    # main path ends here
    finite = bool(torch.isfinite(pos[fm]).all())
    ms_step = 1e3 * dt / steps
    print(f"steps {steps}, {ms_step:.3f} ms/step ({steps / dt:.2f} "
          f"steps/s), finite {finite}, gate {gate}")
    check(finite, "finite rollout")
    check(gate["exact"], f"exactness gate {gate}")
    expected = [1 + steps, 18 * (1 + steps)]
    check(launches == expected, f"{launches} launches == {expected}")
    end = dict(sample, pos=pos, vel=vel)
    _, end_log = record_launches(model, end)
    sym = [out for name, _, _, out in end_log if name == "sym_conv0"][0]
    ratio = float((sym.sum(0).abs() / sym.abs().sum()).max())
    print(f"ASCC output after the rollout: |sum out| / sum |out| "
          f"{ratio:.3e} (< 1e-5)")
    check(ratio < 1e-5, f"ASCC momentum ratio after the rollout {ratio}")

    phase("6 kernel vs plain twin at each launch of the first step, both "
          "variants")
    fp32_model = build_model(dict(cfg, precision="highest"), device=dev,
                             generator=torch.Generator().manual_seed(0))
    _, fp32_log = record_launches(fp32_model, sample)
    per_launch = {}  # (model, bf16 launch): [launches, ms, device ms,
    #                  plain ms, bound ms] summed over a step
    runs = [("model_bf16", e) for e in launch_log] \
        + [("model_fp32", e) for e in fp32_log]
    with torch.no_grad():
        for key, (name, args, kw, out) in runs:
            err = fwd_check(name, out, cconv_klist_reference(*args, **kw),
                            kw)
            max_err[bf16(kw)] = max(max_err[bf16(kw)], err)
            kargs = kernel_args(args, kw)
            ms = cuda_ms(lambda: cconv_klist(*kargs, **kw), iters=20)
            d_ms = graph_ms(lambda: cconv_klist(*kargs, **kw))
            p_ms = cuda_ms(lambda: cconv_klist_reference(*args, **kw),
                           iters=20)
            b_ms, b_by, _, _ = bound(*args, kw["qfeats"], kw["precision"],
                                     kw["interpolation"])
            sums = per_launch.setdefault((key, bf16(kw)), [0, 0.0, 0.0,
                                                           0.0, 0.0])
            for n_, v in enumerate((1, ms, d_ms, p_ms, b_ms)):
                sums[n_] += v
            idx_, _, _, f_, w_, ks_ = args
            print(f"{name:11s} Q {idx_.shape[0]:4d} K {idx_.shape[1]} "
                  f"N {f_.shape[0]:4d} Cin {f_.shape[1]:2d} "
                  f"Cout {w_.shape[1]:2d} S {int(np.prod(ks_))} "
                  f"{'bf16' if bf16(kw) else 'fp32'} "
                  f"sym {kw['qfeats'] is not None:d}: kernel {ms:.4f} ms "
                  f"(device time {d_ms:.4f}), plain twin {p_ms:.4f} ms, "
                  f"bound {b_ms:.5f} ms ({b_by}), max_abs_err {err:.3e}")
    for (key, half), (n_, ms, d_ms, p_ms, b_ms) in per_launch.items():
        print(f"per step, {key} model, {'bf16' if half else 'fp32'} "
              f"launches ({n_}): kernel {ms:.4f} ms (device time "
              f"{d_ms:.4f}), plain twin {p_ms:.4f} ms, bound {b_ms:.5f} ms,"
              f" share of bound {b_ms / ms:.3f} (of device time "
              f"{b_ms / d_ms:.3f})")

    phase("7 small scene: card vs plain path on the CPU (bf16 trunk), "
          "one-step bf16 flips of T counted apart")
    small_scene_phase(model, dev)

    phase("8 where a step's time goes (bf16 trunk)")
    print_report(profile(steps=10), top=12)

    phase("9 valid pipeline on the card (configs/other/momentum.yml)")
    valid = valid_phase(root, dev)
    for half in (False, True):
        max_err[half] = max(max_err[half], valid["max_abs_err"][half])

    phase("10 backward kernels vs the plain backward, both variants")
    bwd = bwd_phase(root, dev, shapes)

    phase("11 momentum training on the card (run_pipeline --split train, "
          "bf16 trunk)")
    train = train_phase(root, dev)

    phase("12 one WaterRamps train step (batch 16, window 3, bf16 trunk)")
    wr_train = train_step_phase(root, "WaterRamps.yml", dev, model, sample,
                                "WaterRamps")

    phase(f"13 the fp32 path: {FP32_STEPS}-step rollout and momentum train "
          "steps at precision highest")
    with torch.no_grad():
        fp32_model(sample)                          # warm-up step
    zero_counts()              # the fp32 rollout starts here
    pos32, _, gate32, dt32 = timed_rollout(fp32_model, sample, FP32_STEPS)
    fp32_launches = counts()[:2]   # and ends here
    print(f"steps {FP32_STEPS}, {1e3 * dt32 / FP32_STEPS:.3f} ms/step, "
          f"gate {gate32}; launches fp32 {fp32_launches[0]} bf16 "
          f"{fp32_launches[1]}; the bf16 rollout above {ms_step:.3f} "
          f"ms/step")
    check(bool(torch.isfinite(pos32[fm]).all()), "finite fp32 rollout")
    check(gate32["exact"], f"fp32 exactness gate {gate32}")
    check(fp32_launches == [19 * FP32_STEPS, 0],
          f"fp32 rollout launches {fp32_launches}")
    fp32_train_s = fp32_train_phase(root, dev)

    phase("14 column kernel: vs its plain version, vs the JAX fixture, the "
          "symnet.yml splits at full size")
    column = column_phase(root, dev)

    phase(f"15 column configs on the card: symnet.yml trains "
          f"{COLUMN_ITERS} iterations and validates, hrnet.yml and "
          f"symnet_wide.yml one step each")
    column_cfgs = column_configs_phase(root, dev)

    phase(f"16 Liquid3d at full width: {LIQUID_STEPS}-step rollout, every "
          f"launch of a step vs plain, train step batch 8 x window 2")
    liquid = liquid3d_phase(root, dev, max_err)

    phase(f"17 WBC-SPH (grav_eqvar): {WBC_STEPS}-step rollouts upright and "
          f"turned by 30 degrees")
    wbc = wbc_phase(root, dev)

    phase(f"18 the baselines (other/cconv.yml, cconv3d.yml, pointnet.yml): "
          f"{BASELINE_STEPS}-step rollouts, card vs CPU")
    baselines = baselines_phase(root, dev, max_err)

    phase(f"19 the canyon protocol: a generated scene of the canyon's size,"
          f" crop {CANYON_CROP}, {CANYON_STEPS}-step timed rollout; lazy "
          f"dense pairs")
    canyon = canyon_phase(root, dev, max_err)

    phase(f"20 run_sample, inflow regime: {INFLOW_STEPS} steps, an event "
          f"every {INFLOW_EVERY}, crop {INFLOW_CROP}")
    inflow = inflow_phase(root, dev)

    phase(f"21 path A: WaterRamps SymNet with the FPS pyramid, density and "
          f"pressure features, dens_norm, pre-advection: {OPTION_STEPS}-step "
          f"rollout, card vs CPU, train step")
    path_a = path_a_phase(root, dev, max_err)

    phase(f"22 path B: column/hrnet.yml with the FPS pyramid, equivar, "
          f"circular kernels, an extra per-scale conv, transposed searches: "
          f"{OPTION_STEPS}-step rollout, card vs CPU, train step")
    path_b = path_b_phase(root, dev, max_err)

    phase(f"23 reference checkpoint and dataset file on the card: the "
          f"fixture bundle without TensorFlow, the scene through the native "
          f"loader, a {REF_STEPS}-step run_sample, phase 11's events file")
    reference = reference_phase(root, dev, max_err, train["summary_dir"])
    train.pop("tmp").cleanup()

    phase(f"24 interpolation modes: (a) WaterRamps nearest_neighbor at "
          f"full width ({NEAREST_STEPS}-step rollout, card vs CPU, train "
          f"steps), (b) Liquid3d linear_border ({BORDER_STEPS} steps), (c) "
          f"the kernels of each mode past the span and on ties, (d) "
          f"SparseConv, SparseConvTranspose and PointSampling")
    mode_err = {m: {False: 0.0, True: 0.0} for m in INTERP_MODES}
    mode_rows = {}
    part("(a) WaterRamps, interpolation nearest_neighbor")
    nearest = nearest_phase(root, dev, mode_err, mode_rows)
    part("(b) Liquid3d, interpolation linear_border")
    border = border_phase(root, dev, mode_err)
    part("(c) the kernels of each mode")
    interp_case_phase(root, dev, mode_err, mode_rows)
    part("(d) the layer library")
    sparse_err, sparse_launches = layers_phase(dev)

    phase(f"25 multi-rank: (a) NCCL, world size 1: the momentum DP train "
          f"step and a one-slab halo step; (b) gloo, 2 ranks on one card: "
          f"Liquid3d's halo rollout on {MULTI_BLOCK} at highest vs one "
          f"process and {MULTI_STEPS} timed steps of the config as shipped, "
          f"the DP train step with one item a rank")
    multi = multi_rank_phase(root, dev, max_err, smi)

    phase(f"26 the particle-sharded step: (a) NCCL, world size 1, bitwise "
          f"the one-process step; (b) gloo, 2 ranks on one card: every "
          f"K-list launch of each rank's first step vs plain, a "
          f"{SHARDED_STEPS}-step rollout, a step at highest vs one process;"
          f" (c) path B and Liquid3d as shipped at highest vs one process")
    sharded = sharded_phase(root, dev, max_err, smi)

    pallas = "dmcf_tpu/experimental/pallas_cconv.py:136 " \
        "(pallas_continuous_conv)"
    vjp = "none (no TPU kernel): the VJP of dmcf_tpu/ops/cconv.py:173 " \
        "continuous_conv, XLA autodiff"
    kernels = []
    for half, prec in ((False, "highest"), (True, "default")):
        tm = trunk[prec]
        row = per_launch.get(("model_bf16" if half else "model_fp32", half))
        kernels.append({
            "name": "cconv_klist_bf16" if half else "cconv_klist",
            "route": "cuda",
            "source": "dmcf_tpu_torch/csrc/cconv_klist.cu",
            "replaces": pallas,
            "launches": launches[int(half)],
            "launches_per_step": step_launches[int(half)],
            "fp32_rollout_launches": fp32_launches[int(half)],
            "valid_launches": valid["launches"][int(half)],
            "valid_launches_per_step":
                valid["launches_per_step"][int(half)],
            "train_launches": train["launches"][int(half)],
            "waterramps_train_launches": wr_train["launches"][int(half)],
            "column_path_launches": column_cfgs["launches"][int(half)],
            "liquid3d_launches_per_step": liquid["step"][int(half)],
            "liquid3d_rollout_launches":
                liquid["rollout_launches"][int(half)],
            "liquid3d_train_launches":
                liquid["train"]["launches"][int(half)],
            "wbc_launches": sum(v["launches"][int(half)]
                                for v in wbc.values()),
            "baseline_launches": {k: v["launches"][int(half)]
                                  for k, v in baselines.items()},
            "canyon_launches_per_step": canyon["step"][int(half)],
            "canyon_rollout_launches": canyon["launches"][int(half)],
            "run_sample_launches": inflow["launches"][int(half)],
            "path_a_launches": path_a["launches"][int(half)],
            "path_b_launches": path_b["launches"][int(half)],
            "reference_ckpt_launches_per_step": reference["step"][int(half)],
            "reference_ckpt_launches": reference["launches"][int(half)],
            "multi_rank_launches": {k: v[int(half)]
                                    for k, v in multi["paths"].items()},
            "sharded_launches": {k: v[int(half)]
                                 for k, v in sharded["paths"].items()},
            "max_abs_err": max_err[half],
            "ms": tm["ms"],
            "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"],
            "library_ms": None,
            "device_ms": tm["device_ms"],
            "step_launches_timed": row[0],
            "step_ms": row[1],
            "step_device_ms": row[2],
            "step_plain_ms": row[3],
            "step_bound_ms": row[4],
        })
    grads = {"data": ("dfeats", "dqfeats", "da", "dt"), "filter": ("dw",)}
    for half, prec in ((False, "highest"), (True, "default")):
        for i, which in ((2, "data"), (4, "filter")):
            tm = bwd[("trunk", prec)]
            off = 0 if which == "data" else 2
            bnd = tm[5] if which == "data" else tm[6]
            mom = bwd["momentum_step"][prec]
            kernels.append({
                "name": f"cconv_klist_bwd_{which}"
                        + ("_bf16" if half else ""),
                "route": "cuda",
                "source": "dmcf_tpu_torch/csrc/cconv_klist_bwd.cu",
                "replaces": vjp,
                "launches": train["launches"][i + int(half)],
                "launches_per_train_step":
                    train["launches_per_step"][i + int(half)],
                "waterramps_train_launches":
                    wr_train["launches"][i + int(half)],
                "column_path_launches":
                    column_cfgs["launches"][i + int(half)],
                "liquid3d_train_launches":
                    liquid["train"]["launches"][i + int(half)],
                "multi_rank_launches": {
                    k: v[i + int(half)] for k, v in multi["paths"].items()
                    if k.startswith("dp_train")},
                "max_abs_err": max(bwd["worst_abs"][prec].get(g, 0.0)
                                   for g in grads[which]),
                "max_rel_err": max(bwd["worst"][prec].get(g, 0.0)
                                   for g in grads[which]),
                "ms": tm[off],
                "device_ms": tm[off + 1],
                "plain_ms": tm[4],
                "bound_ms": bnd[0],
                "bound_by": bnd[1],
                "library_ms": None,
                "momentum_step_device_ms": mom[f"{which}_device_ms"],
                "momentum_step_bound_ms": mom[f"{which}_bound_ms"],
            })
            # two launches bitwise equal at every phase-10 shape
            kernels[-1]["deterministic"] = bwd["bitwise_shapes"][prec] > 0
            kernels[-1]["bitwise_shapes"] = bwd["bitwise_shapes"][prec]
    kernels.append({
        "name": "column_sph",
        "route": "cuda",
        "source": "dmcf_tpu_torch/csrc/column_sph.cu",
        "replaces": "none (no TPU kernel): dmcf_tpu/data/generators.py:118 "
                    "_column_solve_jax (XLA, pinned to the CPU)",
        "launches": column_cfgs["column_launches"],
        "max_abs_err": column["max_abs_err"],
        "ms": column["ms"],
        "plain_ms": column["plain_ms"],
        "bound_ms": column["bound_ms"],
        "bound_by": column["bound_by"],
        "library_ms": None,
        "fixture_err": column["fixture_err"],
        "fixture40_err": column["fixture40_err"],
        "split_seconds": {k: v["seconds"]
                          for k, v in column["splits"].items()},
        "split_iterations": {k: v["iterations"]
                             for k, v in column["splits"].items()},
        "split_bound_ms": {k: v["bound_ms"]
                           for k, v in column["splits"].items()},
        "us_per_iteration": {k: v["us_per_iteration"]
                             for k, v in column["splits"].items()},
    })
    paths = {  # each mode's runs: (forward launches, train launches)
        "nearest_neighbor": {
            "rollout": nearest["launches"][:2],
            "layers": sparse_launches[:2],
            "train_highest": nearest["train"]["launches"][:6],
            "train_bf16": nearest["train16"]["launches"][:6]},
        "linear_border": {
            "rollout": border["launches"][:2],
            "train_bf16": border["train"]["launches"][:6]}}
    for mode in INTERP_MODES:
        for which, off in (("fwd", 0), ("data", 2), ("filter", 4)):
            for half in (False, True):
                name = variant(mode, which, half)
                row = mode_rows[name]
                per_path = {f"{k}_launches": v[off + int(half)]
                            for k, v in paths[mode].items()
                            if len(v) > off + int(half)}
                n = sum(per_path.values())
                check(n > 0, f"{name}: launched on a phase-24 path")
                err = row.get("max_abs_err", 0.0)
                if which == "fwd":
                    err = max(err, mode_err[mode][half])
                kernels.append(dict({
                    "name": name,
                    "route": "cuda",
                    "source": "dmcf_tpu_torch/csrc/"
                              + ("cconv_klist.cu" if which == "fwd"
                                 else "cconv_klist_bwd.cu"),
                    "replaces": pallas if which == "fwd" else vjp,
                    "launches": n,
                    "max_abs_err": err,
                    "ms": row["ms"],
                    "plain_ms": row["plain_ms"],
                    "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"],
                    "library_ms": None,
                    "device_ms": row["device_ms"],
                    "interpolation": mode,
                    "deterministic": True,
                }, **per_path, **{k: row[k] for k in (
                    "max_rel_err", "step_launches", "step_ms",
                    "step_device_ms", "step_plain_ms", "step_bound_ms")
                    if k in row}))
    fps_a = path_a["fps"][max(path_a["fps"])]   # scale 1, the larger
    kernels.append({
        "name": "fps",
        "route": "cuda",
        "source": "dmcf_tpu_torch/csrc/fps.cu",
        "replaces": "none (no TPU kernel): dmcf_tpu/ops/sph.py:223 "
                    "farthest_point_sample (an XLA fori_loop)",
        "launches": path_a["launches"][2] + path_b["launches"][2],
        "path_a_launches": path_a["launches"][2],
        "path_b_launches": path_b["launches"][2],
        "path_a_train_launches": path_a["train"]["launches"][6],
        "path_b_train_launches": path_b["train"]["launches"][6],
        "sharded_launches": {"sharded_exact":
                             sharded["paths"]["sharded_exact"][2]},
        # the largest difference of any output element (idx, mask) from
        # the plain version over every checked launch of both paths
        "max_abs_err": max(path_a["fps_max_abs_err"],
                           path_b["fps_max_abs_err"],
                           fps_check["max_abs_err"]),
        "checked_launches": path_a["fps_checked"] + path_b["fps_checked"],
        "schedule_cases": fps_check["cases"],
        "schedules_checked": fps_check["schedules"],
        "ms": fps_a["ms"],
        "device_ms": fps_a["device_ms"],
        "floor_ms": fps_a["floor_ms"],
        "floor_multiple": fps_a["floor_multiple"],
        "plain_ms": fps_a["plain_ms"],
        "bound_ms": fps_a["bound_ms"],
        "bound_by": fps_a["bound_by"],
        "library_ms": None,
        "shapes": {f"{p} N {k[0]} S {k[1]}": v
                   for p, r in (("path A", path_a), ("path B", path_b))
                   for k, v in r["fps"].items()},
    })
    print(f"fps ({smi}): {fps_check['cases']} schedule cases bitwise; "
          + "; ".join(f"N {k[0]} S {k[1]} {v['device_ms']:.4f} ms "
                      f"({v['us_a_pick']:.4f} us a pick, "
                      f"{v['floor_multiple']:.2f} x the floor "
                      f"{v['floor_ms']:.4f}; earlier design "
                      f"{FPS_EARLIER_DEVICE_MS.get(k, 'not recorded')})"
                      for r in (path_a, path_b) for k, v in r["fps"].items()))
    for label, r in (("A", path_a), ("B", path_b)):
        print(f"path {label} ({smi}): {r['ms_per_step']:.3f} ms/step, device "
              f"{r['device_ms']:.3f} ms in {r['device_launches']} launches, "
              f"peak {r['peak_bytes'] / 2 ** 30:.3f} GiB, launches (K-list "
              f"fp32, bf16, fps) {r['launches']}, card vs CPU "
              f"{r['card_cpu_err']:.2e}, train step "
              f"{r['train']['seconds']:.3f} s (grads within "
              f"{r['train']['grad_rel_err']:.2e}), inverted lists "
              f"{r['inverted']} fed to {r['inverted_fed']} conv calls")
    print(f"column: splits {column['splits']}; symnet.yml losses "
          f"{column_cfgs['losses'][0]:.4e} -> {column_cfgs['losses'][-1]:.4e}"
          f"; Liquid3d {liquid['ms_per_step']:.3f} ms/step (voxels "
          f"dropped a scale {liquid['dropped']}), train step "
          f"{liquid['train']['seconds']:.3f} s, peak "
          f"{liquid['train']['peak_bytes'] / 2 ** 30:.3f} GiB")
    print(f"canyon: {canyon['result']['ms_per_step']:.3f} ms/step "
          f"({CANYON_STEPS} steps), device {canyon['trace']} ; run_sample "
          f"inflow {inflow['report']['ms_per_step']:.3f} ms/step, peak "
          f"{inflow['peak_bytes'] / 2 ** 30:.3f} GiB, exact "
          f"{inflow['exact']} (pair_overflow "
          f"{inflow['report']['pair_overflow']})")
    rep = reference["report"]
    print(f"reference checkpoint ({smi}): run_sample {REF_STEPS} steps "
          f"{rep['ms_per_step']:.3f} ms/step, peak "
          f"{reference['peak_bytes'] / 2 ** 30:.3f} GiB, launches (K-list "
          f"fp32, bf16) {reference['launches']}, card vs CPU "
          f"{reference['card_cpu_err']:.2e}, blob momentum ratio "
          f"{reference['momentum_ratio']:.3e}; phase 11's events file "
          f"{reference['events']} records, {reference['scalar_events']} "
          f"scalars")
    print(f"interpolation modes ({smi}): nearest_neighbor WaterRamps "
          f"{nearest['ms_per_step']:.3f} ms/step ({NEAREST_STEPS} steps, "
          f"device {nearest['device_ms']:.3f} ms in "
          f"{nearest['device_launches']} launches, momentum ratio "
          f"{nearest['momentum_ratio']:.3e}, {nearest['tie_slots']} tie "
          f"slots, without them {nearest['momentum_ratio_untied']:.3e}), "
          f"card vs CPU "
          f"{nearest['card_cpu_err']:.2e}, train steps "
          f"{nearest['train']['seconds']:.3f} s (highest, grads within "
          f"{nearest['train']['grad_rel_err']:.2e}) and "
          f"{nearest['train16']['seconds']:.3f} s (bf16 trunk); "
          f"linear_border Liquid3d {border['ms_per_step']:.3f} ms/step "
          f"({BORDER_STEPS} steps, momentum ratio "
          f"{border['momentum_ratio']:.3e}), card vs CPU "
          f"{border['card_cpu_err']:.2e}; layers card vs CPU " + ", ".join(
              f"{k} {v:.2e}" for k, v in sparse_err.items()))
    for name, row in sorted(mode_rows.items()):
        if "step_device_ms" in row:
            print(f"  {name}: {row['step_launches']} launches a step, "
                  f"device {row['step_device_ms']:.4f} ms a step (plain "
                  f"{row['step_plain_ms']:.4f}, bound "
                  f"{row['step_bound_ms']:.5f}); trunk shape "
                  f"{row['device_ms']:.4f} ms")
    print(f"multi-rank ({smi}): (a) {multi['nccl']['transport']}, DP "
          f"parameters bitwise {multi['nccl']['same']}, one-slab halo "
          f"{multi['nccl']['halo_err']:.2e}; (b) Liquid3d halo rollout at "
          f"highest within {multi['exact_err']:.2e} of one process, as "
          f"shipped (bf16 trunk) {multi['ms_per_step']:.1f} ms/step on 2 "
          f"ranks sharing one card (one process "
          f"{multi['ms_per_step_1']:.1f}) "
          f"(no scale-out), DP gradients within "
          f"{multi['dp_grad_rel_err']:.2e}; phase {multi['seconds']:.1f} s")
    print(f"sharded step ({smi}): (a) bitwise at world size 1 "
          f"{sharded['nccl']['same']}; (b) {SHARDED_STEPS}-step rollout "
          f"{sharded['ms_per_step']:.1f} ms/step on 2 ranks sharing one card "
          f"(one process {sharded['ms_per_step_1']:.1f}; no scale-out), "
          f"{sharded['split'][0]} all-gathers a step "
          f"({sharded['split'][1]} B); (c) " + ", ".join(
              f"{k} {v['pos_err']:.2e} (bitwise {v['bitwise']})"
              for k, v in sharded["figures"].items())
          + f"; phase {sharded['seconds']:.1f} s")
    print(f"rollout: bf16 trunk {ms_step:.3f} ms/step ({steps} steps), "
          f"fp32 {1e3 * dt32 / FP32_STEPS:.3f} ms/step ({FP32_STEPS} "
          f"steps)")
    print(f"train: momentum {train['step_s']:.4f} s a step (batch 2, "
          f"window 3, bf16 trunk), {fp32_train_s:.4f} s at fp32; WaterRamps "
          f"batch 16 x window 3 "
          f"{wr_train['seconds']:.3f} s, peak "
          f"{wr_train['peak_bytes'] / 2 ** 30:.3f} GiB")
    print(f"smoke wall time: {time.time() - _START:.1f} s (from after "
          f"importing torch, the kernels' build included)")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
