"""Where a WaterRamps SymNet step's time goes on the card.

    python -m dmcf_tpu_torch.profile_step [--steps N] [--out FILE.json]
    python -m dmcf_tpu_torch.profile_step --summary TRACE.json

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
``scripts/torch_klist_phases.py`` too; ``trace_file_summary`` gives the
same summary (``summarise``) of a Chrome trace that the train loop's
``profile_step`` capture wrote
(``python -m dmcf_tpu_torch.profile_step --summary FILE.json``, any
machine).
"""

from __future__ import annotations

import contextlib
import json
import os
import re
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


def trace(fn, reps=5, top=25, host=True):
    """``torch.profiler`` over ``reps`` calls of ``fn``: ``summarise``'s
    report per call, the window being the synchronised wall time of the
    calls, plus the host ops with the most device time (``top_ops``).
    ``host=False`` records the card's activity alone and gives no
    ``top_ops``: the profiler's processing of a step of ~10^5 kernels
    then takes a fraction of the time."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        _, prof_wall = _sync_time(lambda: [fn() for _ in range(reps)])
    device, ops = [], []
    for e in prof.key_averages():
        # device-side events are the kernels, copies and memsets
        # themselves; host ops carry the device time of what they launched
        if str(e.device_type).endswith("CUDA"):
            kind = ("memset" if e.key.startswith("Memset") else
                    "memcpy" if e.key.startswith("Memcpy") else "kernel")
            device.append((e.key, kind, _device_us(e), e.count))
        else:
            ops.append((e.key, _device_us(e) / reps, e.count // reps))
    report = summarise(device, prof_wall, reps, top)
    if host:
        ops.sort(key=lambda r: -r[1])
        report["top_ops"] = [{"name": k, "device_us_per_step": us,
                              "calls_per_step": c}
                             for k, us, c in ops[:top] if us > 0]
    return report


# the hand kernels' symbols (csrc/*.cu), as the device events name them
HAND_KERNELS = ("cconv_klist_kernel", "cconv_klist_bwd_dT_kernel",
                "cconv_klist_bwd_walk_kernel",
                "cconv_klist_bwd_dfeats_kernel",
                "cconv_klist_bwd_filter_kernel",
                "cconv_klist_bwd_filter_sum_kernel", "fps_warp_kernel",
                "fps_block_kernel", "fps_workspace_kernel",
                "column_sph_kernel")
_HAND = re.compile(r"(?<!\w)(" + "|".join(HAND_KERNELS) + r")(?!\w)")
# the Chrome trace's categories of events that ran on the device
_DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "memcpy",
                "gpu_memset": "memset"}


def summarise(device, window_ms, calls=1, top=25):
    """The one summary of a profiler capture, from its device events
    ``device``: (name, kind "kernel", "memcpy" or "memset", device us,
    events), each name once, over a captured window of ``window_ms`` that
    made ``calls`` calls.  Per call: the window (``profiled_ms_per_step``),
    the device time (``device_ms_per_step``, the device events' summed
    time), the busy share (that device time over the window: the events
    of one stream do not overlap), the kernels, the device events, the
    memsets, each hand kernel's events by its symbol (``hand_kernels``),
    and the kernels, copies and memsets with the most device time."""
    rows = sorted(device, key=lambda r: -r[2])
    hand = dict.fromkeys(HAND_KERNELS, 0)
    for name, kind, _, n in rows:
        m = _HAND.search(name) if kind == "kernel" else None
        if m:
            hand[m.group(1)] += n // calls
    wall = window_ms / calls
    device_ms = sum(r[2] for r in rows) / 1e3 / calls
    return {"profiled_ms_per_step": wall, "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / wall if wall else 0.0,
            "kernel_launches_per_step": sum(n for _, kind, _, n in rows
                                            if kind == "kernel") // calls,
            "device_events": sum(r[3] for r in rows) // calls,
            "memsets": sum(n for _, kind, _, n in rows
                           if kind == "memset") // calls,
            "hand_kernels": hand,
            "top_kernels": [{"name": k, "device_us_per_step": us / calls,
                             "calls_per_step": n // calls}
                            for k, _, us, n in rows[:top] if us > 0]}


def trace_file_summary(path, top=25):
    """``summarise`` of a ``torch.profiler`` Chrome trace
    (``export_chrome_trace``, as the train loop's ``profile_step`` capture
    writes it), the whole file as one call: the window is the span of its
    events; ``device_events`` is 0 for a trace with no device activity."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    lo = min((float(e["ts"]) for e in events), default=0.0)
    hi = max((float(e["ts"]) + float(e["dur"]) for e in events),
             default=0.0)
    by_name = {}
    for e in events:
        kind = _DEVICE_CATS.get(e.get("cat"))
        if kind is not None:
            _, us, n = by_name.get(e["name"], (kind, 0.0, 0))
            by_name[e["name"]] = (kind, us + float(e["dur"]), n + 1)
    return summarise([(k, *v) for k, v in by_name.items()], (hi - lo) / 1e3,
                     top=top)


def format_report(report, top=None):
    """The lines ``print_report`` prints."""
    lines = []
    if "stage_ms" in report:
        lines.append(f"device {report['device']}, precision "
                     f"{report['precision']}: {report['ms_per_step']:.3f} "
                     f"ms/step over {report['steps']} steps")
        for k, v in report["stage_ms"].items():
            lines.append(f"  stage {k:12s} {v:9.3f} ms (synchronised wall)")
    lines.append(
        f"profiler: {report['device_ms_per_step']:.3f} ms device time per "
        f"step in {report['kernel_launches_per_step']} kernel launches, "
        f"busy share {report['device_busy_share']:.3f} of "
        f"{report['profiled_ms_per_step']:.3f} ms wall")
    if "hand_kernels" in report:
        lines.append("hand kernels' events: " + (", ".join(
            f"{k} {n}" for k, n in report["hand_kernels"].items() if n)
            or "none") + f"; memsets {report['memsets']}")
    for name in ("top_kernels", "top_ops"):
        if name not in report:
            continue
        lines.append(name)
        for r in report[name][:top]:
            lines.append(f"  {r['device_us_per_step']:10.1f} us "
                         f"{r['calls_per_step']:6d}x  {r['name'][:100]}")
    return lines


def print_report(report, top=None):
    """Print a ``profile`` report (or a ``trace`` or ``trace_file_summary``
    one: no stage times), the first ``top`` rows of each table."""
    print("\n".join(format_report(report, top)))


def main(argv):
    if "--summary" in argv:
        print_report(trace_file_summary(argv[argv.index("--summary") + 1]),
                     top=25)
        return
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
