#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port (``dmcf_tpu_torch``) only: builds its CUDA kernels from
the sources in this checkout, holds each kernel variant (fp32 and bf16)
against its plain PyTorch twin on the card, runs the WaterRamps SymNet
(``configs/WaterRamps.yml`` at its own precision, a bf16 trunk: full
width, random weights from a seeded ``torch.Generator``) on the bench
scene for one step and the bench's timed 600-step rollout
(``dmcf_tpu_torch.bench.timed_rollout``), checks the bench's exactness
gate, the ASCC output's momentum ratio and each variant's launch counts,
holds each kernel against its twin again at every launch of the first
step of the bf16-trunk model and of the fp32 one (and times each: the
conv inventory), checks a small-scene agreement with the plain path on the
CPU, profiles where a step's time goes, runs the valid pipeline of
``configs/other/momentum.yml`` (phase 9: ``Simulator.run_valid`` with the
full metric suite, each variant's launches on that path counted exactly,
card against CPU, momentum drift), holds the backward kernels of both
variants against the plain backward at every launch shape of a momentum
train step and at the WaterRamps trunk shape (phase 10), trains the
momentum config on the card through ``run_pipeline --split train`` with
every kernel variant's launches counted exactly and its first two steps
held against the CPU path (phase 11), runs one WaterRamps train step at
batch 16, window 3 (phase 12), runs the fp32 path (precision "highest": a
100-step rollout and momentum train steps, phase 13), and prints one
``kernels`` JSON line (each kernel variant, its launches on each path),
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
TRAIN_ITERS = 20             # phase 11's run_train iterations
# momentum drift |sum v_T - sum v_0| / sum |v_0| of a momentum rollout: the
# velocity is a position difference over dt, so each step rounds each
# particle's velocity by up to ~ulp(|x| ~ 0.25) / dt = 1.2e-5; once the
# corrections make those roundings independent, 202 particles over 39
# steps walk to ~2e-5 of sum |v_0| ~ 54 whatever the ASCC sums to (the
# CPU gives 2.2e-5 with the data scaled by 0.9).  Five times that:
DRIFT_BOUND = 1e-4


def phase(name):
    print(f"== {name}", flush=True)


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


def bound(idx, a, t, feats, w, ksize, qfeats, precision="highest"):
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
    nz = _tap_tensor(t, a, ksize) != 0          # [Q, K, S]
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
              precision="highest"):
    """Least time the card could take for one backward kernel, as
    ``bound`` for the forward, all operations at the fp32 rate.  data:
    reads idx, a, t, feats, w, qfeats, dout, writes dfeats, dqfeats, da,
    dt; computes dT on the (query, tap row) pairs some slot's hats touch
    (2 Cin Cout each) and, per touched tap, the dA dot product and the dg
    update (4 Cin).  filter: reads the same but w, writes dW; rebuilds T
    over the non-zero taps (2 Cin each) and multiplies it by dout over the
    touched rows (2 Cin Cout each).  The bf16 variants read feats and w as
    bf16 and write dfeats and dW in fp32.  Returns (ms, by)."""
    from dmcf_tpu_torch.kernels.cconv_klist import _tap_tensor, is_bf16
    cin, cout = feats.shape[1], w.shape[1]
    half = 2 if is_bf16(precision) else 4

    def nbytes(xs):
        return sum(x.numel() * x.element_size() for x in xs if x is not None)

    if which == "data":
        hz = _tap_tensor(t, torch.ones_like(a), ksize) != 0
        ops = 2 * int(hz.any(dim=1).sum()) * cin * cout \
            + 4 * int(hz.sum()) * cin
        moved = nbytes((idx, a, t, qfeats, dout)) \
            + (feats.numel() + w.numel()) * half \
            + feats.numel() * 4 + nbytes((qfeats, a, t))
    else:
        nz = _tap_tensor(t, a, ksize) != 0
        ops = 2 * int(nz.sum()) * cin + 2 * int(nz.any(dim=1).sum()) * cin \
            * cout
        moved = nbytes((idx, a, t, qfeats, dout)) + feats.numel() * half \
            + nbytes((w,))
    ops_ms = ops / FP32_FLOP_PER_S * 1e3
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def bwd_check(args, qfeats, seed, precision="highest"):
    """Both backward kernels (the ``precision``'s variant) at one launch
    shape (the forward's inputs ``args``) against the plain backward, on a
    random dout: per gradient the max abs error over that gradient's max
    abs (0 where both are 0), and the max abs error; the bf16 variant's
    dfeats and dW apart from one-step rounding flips, whose count is
    checked and printed."""
    from dmcf_tpu_torch.kernels.cconv_klist import (
        cconv_klist_bwd_data, cconv_klist_bwd_filter,
        cconv_klist_bwd_reference, is_bf16, rounding_flips)
    idx, a, t, feats, w, ksize = args
    half = is_bf16(precision)
    if half:
        feats, w = feats.bfloat16(), w.bfloat16()
    g = torch.Generator(device=feats.device).manual_seed(seed)
    dout = torch.randn((idx.shape[0], w.shape[1]), generator=g,
                       device=feats.device)
    full = (dout, idx, a, t, feats, w, ksize, qfeats)
    kw = dict(precision=precision)
    dfeats, dqfeats, da, dt = cconv_klist_bwd_data(*full, **kw)
    got = (dfeats, dqfeats, cconv_klist_bwd_filter(*full, **kw), da, dt)
    torch.cuda.synchronize()
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
        check(err <= tol * scale,
              f"{name}: kernel vs plain backward {err} > {tol} x {scale}")
    if flips:
        print("    one-step bf16 rounding flips: " + ", ".join(
            f"{k} {v} of {got[BWD_NAMES.index(k)].numel()}"
            for k, v in flips.items()))
    return rel, abs_err, full


def bwd_times(full, precision="highest"):
    """(data ms, data device ms, filter ms, filter device ms, plain ms,
    data bound (ms, by), filter bound (ms, by)) at one launch shape."""
    from dmcf_tpu_torch.kernels.cconv_klist import (
        cconv_klist_bwd_data, cconv_klist_bwd_filter,
        cconv_klist_bwd_reference)
    from dmcf_tpu_torch.profile_step import graph_ms
    kw = dict(precision=precision)
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
    per_step = 2 + sum(len(row) for layer in model.convs for row in layer) \
        + n_sym
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
            b_ms, b_by, _, _ = bound(*args, kw["qfeats"], kw["precision"])
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

    def one(args, qfeats, seed, prec, what):
        rel, err, full = bwd_check(args, qfeats, seed, prec)
        tm = bwd_times(full, prec)
        for k, v in err.items():
            worst_abs[prec][k] = max(worst_abs[prec].get(k, 0.0), v)
        for k, v in rel.items():
            worst[prec][k] = max(worst[prec].get(k, 0.0), v)
        print(f"  {what} {'bf16' if prec == 'default' else 'fp32'}: data "
              f"{tm[0]:.4f} ms (device {tm[1]:.4f}, bound {tm[5][0]:.5f} "
              f"{tm[5][1]}), filter {tm[2]:.4f} ms (device {tm[3]:.4f}, "
              f"bound {tm[6][0]:.5f} {tm[6][1]}), plain {tm[4]:.4f} ms; rel "
              "err " + " ".join(f"{k} {v:.2e}" for k, v in rel.items()))
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
    out["worst"], out["worst_abs"] = worst, worst_abs
    return out


def counts():
    """Launches of each kernel variant: [forward fp32, forward bf16, data
    fp32, data bf16, filter fp32, filter bf16]."""
    from dmcf_tpu_torch.kernels.cconv_klist import (
        cconv_klist, cconv_klist_bwd_data, cconv_klist_bwd_filter)
    return [n for f in (cconv_klist, cconv_klist_bwd_data,
                        cconv_klist_bwd_filter)
            for n in (f.launches, f.launches_bf16)]


def zero_counts():
    from dmcf_tpu_torch.kernels.cconv_klist import (
        cconv_klist, cconv_klist_bwd_data, cconv_klist_bwd_filter)
    for f in (cconv_klist, cconv_klist_bwd_data, cconv_klist_bwd_filter):
        f.launches = f.launches_bf16 = 0


def expected_train_launches(items, window, convs, bf16_convs):
    """Launches of one train step over ``items`` items, as ``counts``
    orders them, of a model with ``convs`` K-list convs of which
    ``bf16_convs`` (the scale-0 and trunk convs at the default precision)
    run the bf16 variants: each variant's forward kernel twice a conv a
    step (the forward and its recompute under the per-step checkpoint), its
    filter kernel once a conv a step, its data kernel the same but for the
    two scale-0 convs of step 0, whose inputs (the detached starting state)
    take no gradient."""
    n = {False: convs - bf16_convs, True: bf16_convs}
    scale0 = {False: 2 - min(2, bf16_convs), True: min(2, bf16_convs)}
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
    gradient non-zero; then the card's s per train step."""
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
    tmp.cleanup()
    return {"launches": launches, "launches_per_step": step,
            "step_s": step_s, "grad_rel_err": grad_err, "seconds": seconds}


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


def waterramps_train_phase(root, dev, model, sample, klist, klist_bf16):
    """Phase 12: one WaterRamps train step at the config's first
    curriculum stage (batch 16, window 3, ``dense_n_chunk`` 256) and its
    precision (a bf16 trunk) on a 4-frame sequence the port's rollout makes
    from the bench scene: time, peak device memory, a finite loss, the
    launches of each kernel variant counted exactly (``klist`` K-list convs
    a step, ``klist_bf16`` of them bf16)."""
    import yaml

    from dmcf_tpu_torch.models.losses import get_loss
    from dmcf_tpu_torch.pipelines.simulator import (make_optimizer,
                                                    make_train_step)
    from dmcf_tpu_torch.rollout import rollout

    with open(os.path.join(root, "configs", "WaterRamps.yml")) as f:
        cfg = yaml.safe_load(f)
    batch_size = int(cfg["pipeline"]["batch_size"])
    window = int(cfg["pipeline"]["windows"][0])
    n = sample["pos"].shape[0]
    frames = (torch.empty((window + 1, n, 3), device=dev),
              torch.empty((window + 1, n, 3), device=dev))
    rollout(model, sample, window, frames=frames)
    batch = {"pos": frames[0], "vel": frames[1],
             "grav": sample["grav"].expand(window + 1, n, 3)}
    batch = {k: v[None].expand(batch_size, *v.shape).contiguous()
             for k, v in batch.items()}
    for k in ("box", "box_normals", "fluid_mask", "box_mask"):
        batch[k] = sample[k][None].expand(batch_size, *sample[k].shape)
    batch["pre"] = torch.zeros(batch_size, dtype=torch.int32, device=dev)
    loss = {k: get_loss(**v) for k, v in cfg["model"]["loss"].items()}
    step = make_train_step(model, loss, *make_optimizer(
        model, cfg["pipeline"]["optimizer"]), window=window)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()                # the WaterRamps training path starts here
    t0 = time.time()
    lvec, _, stats = step(batch, np.ones(window, np.float32))
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = counts()          # and ends here
    peak = torch.cuda.max_memory_allocated(dev)
    want = expected_train_launches(batch_size, window, klist, klist_bf16)
    print(f"  batch {batch_size} x window {window}, {n} fluid rows: "
          f"{seconds:.3f} s, peak memory allocated {peak / 2 ** 30:.3f} GiB"
          f", loss {float(lvec.sum()):.6e}, max_neighbors "
          f"{float(stats['max_neighbors']):.0f}, pair_overflow "
          f"{float(stats['pair_overflow']):.0f}; launches {launches} (want "
          f"{want}: {klist} K-list convs a step, {klist_bf16} bf16)")
    check(bool(torch.isfinite(lvec).all()), "finite WaterRamps loss")
    check(launches == want, f"WaterRamps train launches {launches}")
    check(all(bool(torch.isfinite(p.grad).all())
              for p in model.parameters()), "finite WaterRamps gradients")
    return {"launches": launches, "seconds": seconds, "peak_bytes": peak}


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
            b_ms, b_by, _, _ = bound(*args, kw["qfeats"], kw["precision"])
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

    phase("7 small scene: card vs plain path on the CPU (bf16 trunk)")
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
          f"{diff:.3e} (tol {1e-4 * scale:.3e}); positions max diff "
          f"{float((pg.cpu() - pc).abs().max()):.3e} (tol 1e-6)")
    check(scale > 0 and diff <= 1e-4 * scale,
          f"card vs CPU pos_correction {diff} <= 1e-4 * {scale}")
    check(torch.allclose(pg.cpu(), pc, atol=1e-6, rtol=0),
          "card vs CPU positions within 1e-6")

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
    wr_train = waterramps_train_phase(root, dev, model, sample, 19, 18)

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
    print(f"rollout: bf16 trunk {ms_step:.3f} ms/step ({steps} steps), "
          f"fp32 {1e3 * dt32 / FP32_STEPS:.3f} ms/step ({FP32_STEPS} "
          f"steps)")
    print(f"train: momentum {train['step_s']:.4f} s a step (batch 2, "
          f"window 3, bf16 trunk), {fp32_train_s:.4f} s at fp32; WaterRamps "
          f"batch 16 x window 3 "
          f"{wr_train['seconds']:.3f} s, peak "
          f"{wr_train['peak_bytes'] / 2 ** 30:.3f} GiB")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
