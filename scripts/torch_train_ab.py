"""Host-clock time of the port's bf16 training paths and of the bench
rollout, for comparing two trees of the port on one card.

    python scripts/torch_train_ab.py --tree DIR [--label NAME]
        [--momentum-steps N] [--waterramps-steps N] [--rollout-steps N]
        [--rollout-reps R] [--device cpu --waterramps-batch B
        --scene-fluid N]

Imports ``dmcf_tpu_torch`` from ``DIR`` (its kernels build into DIR's
``dmcf_tpu_torch/_build``) and nothing from the tree the script sits in,
so one call can run it on a parent checkout and on a change in turn
(parent, change, change, parent).  Uses only entry points both trees
have.  Measures, as ``chip_smoke.py`` phases 11, 12 and 5 do:

- the momentum train step (``configs/other/momentum.yml``, its
  precision, a bf16 trunk; batch 2, window 3, data scaled by 0.9, a
  seeded loader, weights seeded 42): 2 warm-up steps, then each of
  ``--momentum-steps`` steps on its own, and the profiler's device time
  and launches of one more;
- the WaterRamps train step (``configs/WaterRamps.yml``, batch 16,
  window 3, seed-0 weights, on a 4-frame sequence the rollout makes from
  the bench scene): the first step, as phase 12 times it, then each of
  the next ``--waterramps-steps`` - 1;
- the bench rollout's ms/step (``bench.timed_rollout``), ``--rollout-reps``
  rollouts of ``--rollout-steps`` steps after one warm-up step, with the
  profiler's device time and launches of one step and the ATen operators
  one step dispatches (a count of the host's work, the same on any
  device).

A count of 0 skips a training path.

Prints the card's name and power limit and one JSON line.  Needs a CUDA
device and nvcc; ``--device cpu`` with a small batch and scene checks
the script itself (its times are no device number).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", default=None)
    ap.add_argument("--momentum-steps", type=int, default=5)
    ap.add_argument("--waterramps-steps", type=int, default=2)
    ap.add_argument("--rollout-steps", type=int, default=100)
    ap.add_argument("--rollout-reps", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--waterramps-batch", type=int, default=None)
    ap.add_argument("--scene-fluid", type=int, default=None)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import numpy as np
    import torch
    import yaml

    import dmcf_tpu_torch
    from dmcf_tpu_torch.bench import timed_rollout
    from dmcf_tpu_torch.data import DatasetGroup, get_dataloader
    from dmcf_tpu_torch.models import build_model
    from dmcf_tpu_torch.models.losses import get_loss
    from dmcf_tpu_torch.pipelines.simulator import (make_optimizer,
                                                    make_train_step)
    from dmcf_tpu_torch.profile_step import trace
    from dmcf_tpu_torch.rollout import rollout
    from dmcf_tpu_torch.scene import bench_sample, build_scene
    from torch.utils._python_dispatch import TorchDispatchMode

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("torch_train_ab: needs a CUDA device", file=sys.stderr)
        return 2
    assert os.path.dirname(os.path.dirname(
        os.path.abspath(dmcf_tpu_torch.__file__))) == tree
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip() \
        if dev.type == "cuda" else "cpu"

    def cfg(*path):
        with open(os.path.join(tree, "configs", *path)) as f:
            return yaml.safe_load(f)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def timed(fn):
        sync()
        t0 = time.time()
        fn()
        sync()
        return time.time() - t0

    class OpCount(TorchDispatchMode):
        """Counts the ATen operators dispatched within."""
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    def momentum(steps):
        """Phase 11's timed train steps."""
        mom = cfg("other", "momentum.yml")
        pcfg = mom["pipeline"]
        group = DatasetGroup(split="train", cache_dir=None,
                             **mom["dataset"])
        dg = dict(pcfg["data_generator"], scale=[0.9, 0.9, 0.0])
        split = {k: v for k, v in dg.items() if k not in ("train", "valid",
                                                          "test")}
        batch_size = int(pcfg["batch_size"])
        window = int(pcfg["windows"][0])
        loader = get_dataloader(group.train, batch_size=batch_size,
                                window=window, **split,
                                **dict(dg["train"], seed=0))
        batches = [{k: torch.as_tensor(v, device=dev)
                    for k, v in next(loader).items() if v is not None}
                   for _ in range(steps + 3)]
        loader.close()
        model = build_model(mom["model"], device=dev,
                            generator=torch.Generator().manual_seed(42))
        loss = {k: get_loss(**v) for k, v in mom["model"]["loss"].items()}
        step = make_train_step(model, loss, *make_optimizer(
            model, pcfg["optimizer"]), window=window)
        time_w = np.ones(window, np.float32)
        for b in batches[:2]:
            step(b, time_w)
        mom_s = [timed(lambda b=b: step(b, time_w))
                 for b in batches[2:-1]]
        report = trace(lambda: step(batches[-1], time_w), reps=1, top=5) \
            if dev.type == "cuda" else {}
        return {"momentum_step_s": mom_s,
                "momentum_step_mean_s": sum(mom_s) / len(mom_s),
                "momentum_device_ms": report.get("device_ms_per_step"),
                "momentum_profiled_ms": report.get("profiled_ms_per_step"),
                "momentum_launches": report.get("kernel_launches_per_step")}

    def waterramps(wr, model, sample, steps):
        """Phase 12's train step, the first and ``steps`` - 1 more."""
        wb = args.waterramps_batch or int(wr["pipeline"]["batch_size"])
        ww = int(wr["pipeline"]["windows"][0])
        n = sample["pos"].shape[0]
        frames = (torch.empty((ww + 1, n, 3), device=dev),
                  torch.empty((ww + 1, n, 3), device=dev))
        rollout(model, sample, ww, frames=frames)
        batch = {"pos": frames[0], "vel": frames[1],
                 "grav": sample["grav"].expand(ww + 1, n, 3)}
        batch = {k: v[None].expand(wb, *v.shape).contiguous()
                 for k, v in batch.items()}
        for k in ("box", "box_normals", "fluid_mask", "box_mask"):
            batch[k] = sample[k][None].expand(wb, *sample[k].shape)
        batch["pre"] = torch.zeros(wb, dtype=torch.int32, device=dev)
        loss = {k: get_loss(**v) for k, v in wr["model"]["loss"].items()}
        step = make_train_step(model, loss, *make_optimizer(
            model, wr["pipeline"]["optimizer"]), window=ww)
        time_w = np.ones(ww, np.float32)
        return {"waterramps_batch": wb,
                "waterramps_step_s": [timed(lambda: step(batch, time_w))
                                      for _ in range(steps)]}

    out = {"label": args.label or os.path.basename(tree), "card": smi}
    if args.momentum_steps:
        out.update(momentum(args.momentum_steps))
    wr = cfg("WaterRamps.yml")
    model = build_model(wr["model"], device=dev,
                        generator=torch.Generator().manual_seed(0))
    sample = bench_sample(*(build_scene(args.scene_fluid)
                            if args.scene_fluid else build_scene()),
                          device=dev)
    if args.waterramps_steps:
        out.update(waterramps(wr, model, sample, args.waterramps_steps))

    # the bench rollout (phase 5)
    with torch.no_grad():
        model(sample)
        with OpCount() as ops:
            model(sample)
    times, exact = [], True
    for _ in range(args.rollout_reps):
        _, _, gate, dt = timed_rollout(model, sample, args.rollout_steps)
        times.append(1e3 * dt / args.rollout_steps)
        exact = exact and bool(gate["exact"])
    with torch.no_grad():
        report = trace(lambda: model(sample), reps=3, top=5) \
            if dev.type == "cuda" else {}
    out.update(rollout_ms_per_step=times, rollout_exact=exact,
               step_aten_ops=ops.n,
               step_device_ms=report.get("device_ms_per_step"),
               step_launches=report.get("kernel_launches_per_step"))
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
