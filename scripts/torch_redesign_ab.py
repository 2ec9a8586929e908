"""Device time of the K-list data- and filter-gradient kernels and of the
column solver, for comparing two trees of the port on one card.

    python -m scripts.torch_redesign_ab [--label NAME] [--splits train,...]
        [--launches FILE]
    python -m scripts.torch_redesign_ab --capture FILE

Imports ``dmcf_tpu_torch`` and ``chip_smoke`` from the tree it is run in,
so run it from each tree's root in turn on one card (parent, change,
change, parent).  Prints the card's name and power limit and one JSON
line: the data and filter kernels' device time a wrapper call (CUDA-graph
replay, ``profile_step.graph_ms``; the data wrapper's index preparation
included) and the data wrapper's
time a call issued back to back (``chip_smoke.cuda_ms``), in both
variants at the WaterRamps trunk shape
(``chip_smoke.waterramps_shapes`` on the bench scene) and at shapes of the
momentum model's K 48, 96 and 256 pairs (a search over N points in a
square, as ``tests/test_torch_kernels.py`` builds them), and the seconds
and microseconds a projection iteration of ``configs/column/symnet.yml``'s
splits made by the column kernel.  Needs a CUDA device and nvcc; imports
only the port.

``--capture FILE`` (run once, in a tree whose ``chip_smoke.py`` has the
train-step phases' ``batch_size``) saves the inputs of every data-gradient
launch of one train step of each training path of ``chip_smoke.py``:
momentum (``run_pipeline --split train``, one iteration), WaterRamps and
Liquid3d (``chip_smoke``'s train-step phases at batch 1: the smoke's
items are copies of one sequence) and the column path (``symnet.yml``,
one iteration), with the weight that makes each path's launches those of
one ``chip_smoke.py`` run (``TRAIN_ITERS``, the batch sizes,
``COLUMN_ITERS``).  ``--launches FILE`` then adds to the JSON line, under
``paths``, each path's device time of one pass over its captured launches
(one CUDA graph of them all, replayed), the pass's launches (fp32, bf16),
and that time times the weight: the data kernel's device time in one smoke
run, path by path; ``total_ms`` sums them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

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


def _run_pipeline(tmp, dev, *args):
    """One train iteration of ``run_pipeline`` on ``dev``, no validation;
    its logs under ``tmp``."""
    from dmcf_tpu_torch import run_pipeline

    return run_pipeline.main([
        *args, "--split", "train", "--device", dev.type,
        "--dataset.cache_dir", "none", "--pipeline.max_epoch", "0",
        "--pipeline.iter", "1", "--pipeline.run_valid_every_epoch", "false",
        "--pipeline.run_test_every_epoch", "false",
        "--main_log_dir", os.path.join(tmp, "logs"),
        "--output_dir", os.path.join(tmp, "out"),
        "--pipeline.train_sum_dir", os.path.join(tmp, "sum")])


def capture(path, dev):
    """Saves {path name: (weight, [data-wrapper arguments, ...])} to
    ``path`` (see the module docstring)."""
    import tempfile

    import chip_smoke
    import yaml
    from dmcf_tpu_torch.kernels import cconv_klist as ck
    from dmcf_tpu_torch.models import build_model
    from dmcf_tpu_torch.scene import bench_sample, build_scene

    root = os.getcwd()
    wrapper = ck.cconv_klist_bwd_data
    calls = []

    def recording(*args, **kw):
        calls.append(tuple(x.detach().clone() if torch.is_tensor(x) else x
                           for x in args))
        return wrapper(*args, **kw)

    # the wrapper counts its launches on the module's name for it
    recording.launches = recording.launches_bf16 = 0
    recording.workspace_peak = 0

    def cfg(name):
        with open(os.path.join(root, "configs", name)) as f:
            return yaml.safe_load(f)

    def momentum(tmp):
        _run_pipeline(tmp, dev, "--cfg_file", os.path.join(
            root, "configs", "other", "momentum.yml"),
            "--pipeline.data_generator.scale", "[0.9,0.9,0.0]")

    def waterramps(tmp):
        model = build_model(cfg("WaterRamps.yml")["model"], device=dev,
                            generator=torch.Generator().manual_seed(0))
        sample = bench_sample(*build_scene(), device=dev)
        chip_smoke.train_step_phase(root, "WaterRamps.yml", dev, model,
                                    sample, "WaterRamps", batch_size=1)

    def column(tmp):
        _run_pipeline(tmp, dev, "--cfg_file", os.path.join(
            root, "configs", "column", "symnet.yml"),
            "--dataset.test.timesteps", "2")

    def liquid3d(tmp):
        model = build_model(cfg("Liquid3d.yml")["model"], device=dev,
                            generator=torch.Generator().manual_seed(0))
        sample = bench_sample(*chip_smoke.liquid_scene(), device=dev)
        chip_smoke.train_step_phase(root, "Liquid3d.yml", dev, model, sample,
                                    "Liquid3d", batch_size=1)

    paths = {"momentum": (momentum, chip_smoke.TRAIN_ITERS),
             "waterramps": (waterramps, int(
                 cfg("WaterRamps.yml")["pipeline"]["batch_size"])),
             "column": (column, chip_smoke.COLUMN_ITERS),
             "liquid3d": (liquid3d, int(
                 cfg("Liquid3d.yml")["pipeline"]["batch_size"]))}
    out = {}
    ck.cconv_klist_bwd_data = recording
    try:
        for name, (fn, weight) in paths.items():
            calls.clear()
            try:  # a path that fails is left out, the others kept
                with tempfile.TemporaryDirectory() as tmp:
                    fn(tmp)
                torch.cuda.synchronize()
            except Exception:
                traceback.print_exc()
                print(f"capture {name}: failed, left out", flush=True)
                continue
            out[name] = (weight, list(calls))
            print(f"capture {name}: {len(calls)} data launches a pass, "
                  f"weight {weight}", flush=True)
    finally:
        ck.cconv_klist_bwd_data = wrapper
    torch.save(out, path)


def time_paths(path, ck, graph_ms):
    """Each captured path's data-kernel device time: one pass and the
    weighted total (see the module docstring)."""
    captured = torch.load(path, weights_only=False)
    out, total = {}, 0.0
    for name, (weight, calls) in captured.items():
        def one_pass(calls=calls):
            for c in calls:
                ck.cconv_klist_bwd_data(*c[:8], precision=c[8])
        ms = graph_ms(one_pass, iters=1, reps=5)
        n_bf16 = sum(ck.is_bf16(c[8]) for c in calls)
        out[name] = {"launches_fp32_bf16": [len(calls) - n_bf16, n_bf16],
                     "pass_ms": ms, "weight": weight,
                     "smoke_ms": ms * weight}
        total += ms * weight
    return out, total


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--splits", default="train")
    ap.add_argument("--capture", default=None, metavar="FILE")
    ap.add_argument("--launches", default=None, metavar="FILE")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_redesign_ab needs a CUDA device")
    sys.path.insert(0, os.getcwd())
    if args.capture:
        capture(args.capture, torch.device("cuda"))
        return
    import chip_smoke
    import yaml
    from dmcf_tpu_torch.data.generators import column_problem
    from dmcf_tpu_torch.kernels import cconv_klist as ck
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
    out = {"label": args.label, "data_device_ms": {}, "data_ms": {},
           "filter_device_ms": {}, "column": {}}
    for name, (xs, ks) in shapes.items():
        idx, a, t, feats, w = xs
        g = torch.Generator(device=dev).manual_seed(0)
        dout = torch.randn((idx.shape[0], w.shape[1]), generator=g,
                           device=dev)
        for prec, tag in (("highest", "fp32"), ("default", "bf16")):
            fw = (feats, w) if prec == "highest" else (feats.bfloat16(),
                                                       w.bfloat16())
            full = (dout, idx, a, t, *fw, ks, None)
            key = f"{name}_{tag}"
            out["data_device_ms"][key] = graph_ms(
                lambda: ck.cconv_klist_bwd_data(*full, precision=prec))
            out["data_ms"][key] = chip_smoke.cuda_ms(
                lambda: ck.cconv_klist_bwd_data(*full, precision=prec),
                iters=20)
            out["filter_device_ms"][key] = graph_ms(
                lambda: ck.cconv_klist_bwd_filter(*full, precision=prec))
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
    if args.launches:
        out["paths"], out["total_ms"] = time_paths(args.launches, ck,
                                                   graph_ms)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
