"""Where a WaterRamps SymNet step's time goes on the card.

    python -m dmcf_tpu_torch.profile_step [--steps N] [--out FILE.json]

Builds the model of ``configs/WaterRamps.yml`` (random weights, seed 0; the
config's precision, a bf16 trunk) on the bench scene, then reports its precision and (1) steady-state
wall time per step, (2) the synchronised wall time of each stage of a step
(preprocess: advection, voxel pyramid, finest search, scale-0 convs;
trunk: HRNet convs with their searches and dense pairs; ASCC output conv;
postprocess), and (3) a
``torch.profiler`` trace summary: device time per step, the device's busy
share of the wall time, and the ops with the most device time.  Needs a
CUDA device; never falls back to the CPU.  ``graph_ms`` (a kernel's
device time), ``record_launches`` (the K-list conv calls of one step;
``launch_log`` those of any block) and
``trace`` (a profiler summary of any callable) serve ``chip_smoke.py`` and
``scripts/torch_klist_phases.py`` too.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import torch

from . import resolve_device
from .kernels.cconv_klist import cconv_klist
from .models import build_model
from .models.hrnet import HRNet
from .models.layers import ContinuousConv
from .ops import cconv
from .scene import bench_sample, build_scene


def _sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def graph_ms(fn, iters=20, reps=5):
    """Device time of one call of ``fn``: ``iters`` calls captured in a CUDA
    graph, replayed ``reps`` times between CUDA events, so no host launch
    gap is counted."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


@contextlib.contextmanager
def launch_log(model):
    """Keeps each K-list conv call of ``model`` made inside the block:
    yields the list it fills with (conv module name, args, kwargs,
    output), in call order.  A pre-hook names the conv; the ops module's
    handle on the wrapper is swapped for a recording one."""
    log, current = [], {}
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, name=name: current.update(conv=name))
        for name, m in model.named_modules()
        if isinstance(m, ContinuousConv)]

    def recording(*args, **kw):
        out = cconv_klist(*args, **kw)
        log.append((current["conv"], args, kw, out))
        return out

    cconv.cconv_klist = recording
    try:
        yield log
    finally:
        cconv.cconv_klist = cconv_klist
        for h in hooks:
            h.remove()


def record_launches(model, sample):
    """One model step on ``sample`` that keeps each K-list conv call:
    returns (the step's outputs, ``launch_log``'s list)."""
    with launch_log(model) as log, torch.no_grad():
        outputs = model(sample)
    return outputs, log


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile(steps=20, top=25):
    import yaml

    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "configs", "WaterRamps.yml")) as f:
        cfg = yaml.safe_load(f)["model"]
    model = build_model(cfg, device=dev,
                        generator=torch.Generator().manual_seed(0))
    sample = bench_sample(*build_scene(), device=dev)
    report = {"device": torch.cuda.get_device_name(0), "steps": steps,
              "precision": model.precision}

    with torch.no_grad():
        for _ in range(3):
            model(sample)
        _, wall = _sync_time(lambda: [model(sample) for _ in range(steps)])
        report["ms_per_step"] = wall / steps

        data, _ = model.transform(sample)
        stages = {"preprocess": 0.0, "trunk": 0.0, "ascc": 0.0,
                  "postprocess": 0.0}
        for _ in range(steps):
            ctx, t_pre = _sync_time(lambda: model.preprocess(data))
            trunk, t_trunk = _sync_time(
                lambda: HRNet.net_forward(model, ctx, data))
            out, t_ascc = _sync_time(lambda: model.ascc(trunk, ctx))
            _, t_post = _sync_time(
                lambda: model.postprocess(out, ctx, data))
            stages["preprocess"] += t_pre / steps
            stages["trunk"] += t_trunk / steps
            stages["ascc"] += t_ascc / steps
            stages["postprocess"] += t_post / steps
        report["stage_ms"] = stages

        report.update(trace(lambda: model(sample), reps=5, top=top))
    return report


def trace(fn, reps=5, top=25):
    """``torch.profiler`` over ``reps`` calls of ``fn``: per call, the wall
    time (``profiled_ms_per_step``), the device time and its share of the
    wall, the kernel launches, and the kernels and host ops with the most
    device time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, prof_wall = _sync_time(lambda: [fn() for _ in range(reps)])
    kernels, ops = [], []
    for e in prof.key_averages():
        row = (e.key, _device_us(e) / reps, e.count // reps)
        # device-side events are the kernels themselves; host ops carry
        # the device time of the kernels they launched
        (kernels if str(e.device_type).endswith("CUDA") else ops).append(row)
    kernels.sort(key=lambda r: -r[1])
    ops.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in kernels) / 1e3
    report = {"profiled_ms_per_step": prof_wall / reps,
              "device_ms_per_step": device_ms,
              "device_busy_share": device_ms / (prof_wall / reps),
              "kernel_launches_per_step": sum(r[2] for r in kernels)}
    for name, rows in (("top_kernels", kernels), ("top_ops", ops)):
        report[name] = [{"name": k, "device_us_per_step": us,
                         "calls_per_step": c}
                        for k, us, c in rows[:top] if us > 0]
    return report


def print_report(report, top=None):
    """Print a ``profile`` report (or a ``trace`` one: no stage times), the
    first ``top`` rows of each table."""
    if "stage_ms" in report:
        print(f"device {report['device']}, precision "
              f"{report['precision']}: {report['ms_per_step']:.3f} "
              f"ms/step over {report['steps']} steps")
        for k, v in report["stage_ms"].items():
            print(f"  stage {k:12s} {v:9.3f} ms (synchronised wall)")
    print(f"profiler: {report['device_ms_per_step']:.3f} ms device time per "
          f"step in {report['kernel_launches_per_step']} kernel launches, "
          f"busy share {report['device_busy_share']:.3f} of "
          f"{report['profiled_ms_per_step']:.3f} ms wall")
    for name in ("top_kernels", "top_ops"):
        print(name)
        for r in report[name][:top]:
            print(f"  {r['device_us_per_step']:10.1f} us "
                  f"{r['calls_per_step']:6d}x  {r['name'][:100]}")


def main(argv):
    steps = int(argv[argv.index("--steps") + 1]) if "--steps" in argv else 20
    report = profile(steps)
    if "--out" in argv:
        path = argv[argv.index("--out") + 1]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(report, f, indent=1)
    print_report(report)


if __name__ == "__main__":
    main(sys.argv[1:])
