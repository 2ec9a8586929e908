"""Rollout throughput benchmark of the port (counterpart of the root
``bench.py``, which drives the JAX package):

    python -m dmcf_tpu_torch.bench [--device cuda|cpu] [--steps N]
                                   [--n_fluid N]

Builds the SymNet of ``configs/WaterRamps.yml`` at full width and depth
(weights from a ``torch.Generator`` seeded 0) on the bench scene
(``scene.build_scene()``: 2304 fluid, 350 boundary), runs one warm-up step
and then the 600-step rollout, timed by the host clock and ending in
``torch.cuda.synchronize()``, and prints exactly one JSON line with the
root bench's fields and the precision it ran (``detail.precision``: the
config's, "default", a bf16 trunk).  Exits 1 when the exactness gate fails (a conv dropped an in-radius
neighbour somewhere in the rollout).

Fields that are the TPU bench's own are null here: ``canyon`` (its scene
file is not in the repository), ``flops_per_step`` (XLA's cost analysis
of the compiled step has no counterpart for an eager PyTorch step) and
``mfu_pct`` (computed against a TPU peak).  ``vs_baseline`` keeps the root
bench's documented anchor of 20 steps/s for the reference on this scene
class (an estimate, not a measurement).  ``--device`` defaults to cuda and
raises without a GPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

REFERENCE_STEPS_PER_SEC = 20.0  # the root bench's documented anchor
HORIZON = 600
CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "WaterRamps.yml")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_rollout(model, sample, steps):
    """The timed part of the bench: ``steps`` model steps from ``sample``,
    host clock from a synchronised start to a synchronised end.  Returns
    (pos, vel, gate, seconds)."""
    from .rollout import rollout

    dev = sample["pos"].device
    _sync(dev)
    t0 = time.time()
    pos, vel, gate = rollout(model, sample, steps)
    _sync(dev)
    return pos, vel, gate, time.time() - t0


def card():
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def run(device="cuda", steps=HORIZON, n_fluid=2304):
    """Build, warm up and time the bench rollout; returns the result dict
    (the JSON line's fields)."""
    import yaml

    from . import resolve_device
    from .models import build_model
    from .scene import bench_sample, build_scene

    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    with open(CONFIG) as f:
        cfg = yaml.safe_load(f)["model"]
    model = build_model(cfg, device=device,
                        generator=torch.Generator().manual_seed(0))
    pos, box, nrm = build_scene(n_fluid)
    sample = bench_sample(pos, box, nrm, device=device)
    with torch.no_grad():
        model(sample)                                 # warm-up step
    p, _, gate, dt = timed_rollout(model, sample, steps)
    fm = sample["fluid_mask"]
    steps_per_sec = steps / dt
    return {
        "metric": "WaterRamps_SymNet_rollout_steps_per_sec",
        "value": round(steps_per_sec, 2),
        "unit": "steps/s",
        "vs_baseline": round(steps_per_sec / REFERENCE_STEPS_PER_SEC, 2),
        "detail": {
            "exact": gate["exact"],
            "horizon": steps,
            "n_fluid": int(pos.shape[0]),
            "n_boundary": int(box.shape[0]),
            "ms_per_step": round(1000.0 * dt / steps, 3),
            "precision": model.precision,
            "finite": bool(torch.isfinite(p[fm]).all()),
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "power_limit": (card().split(", ")[-1]
                            if device.type == "cuda" else None),
            "baseline_assumption_steps_per_sec": REFERENCE_STEPS_PER_SEC,
            "flops_per_step": None,
            "mfu_pct": None,
            "max_neighbors": gate["max_neighbors"],
            "neighbor_k": gate["neighbor_k"],
            "pair_overflow": gate["pair_overflow"],
            "canyon": None,
        },
    }


def main(argv):
    device = argv[argv.index("--device") + 1] if "--device" in argv \
        else "cuda"
    steps = int(argv[argv.index("--steps") + 1]) if "--steps" in argv \
        else HORIZON
    n_fluid = int(argv[argv.index("--n_fluid") + 1]) if "--n_fluid" in argv \
        else 2304
    result = run(device, steps, n_fluid)
    print(json.dumps(result), flush=True)
    d = result["detail"]
    if not d["exact"]:
        print(f"EXACTNESS VIOLATION: pair_overflow={d['pair_overflow']} "
              f"max_neighbors={d['max_neighbors']} > K — headline number "
              "dropped neighbors", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
