"""Rollout throughput benchmark of the port (counterpart of the root
``bench.py``, which drives the JAX package):

    python -m dmcf_tpu_torch.bench [--device cuda|cpu] [--steps N]
                                   [--n_fluid N] [--canyon SCENE]

Builds the SymNet of ``configs/WaterRamps.yml`` at full width and depth
(weights from a ``torch.Generator`` seeded 0) on the bench scene
(``scene.build_scene()``: 2304 fluid, 350 boundary), runs one warm-up step
and then the 600-step rollout, timed by the host clock and ending in
``torch.cuda.synchronize()``, and prints exactly one JSON line with the
root bench's fields and the precision it ran (``detail.precision``: the
config's, "default", a bf16 trunk) and the voxel pyramid's fit
(``detail.scale_counts``, ``scale_caps``, ``scales_fit``).  Exits 1 when
the exactness gate fails (a conv dropped an in-radius neighbour somewhere
in the rollout); as in the root bench, that gate alone decides.

``--canyon`` names a canyon scene (msgpack.zst; frame 0 is read): the
root bench's canyon protocol (``bench_canyon``: ``configs/Liquid3d.yml``
with ``CANYON_OVERRIDES`` and a contact crop of 8192, velocity boost
[2, 0, -1.2], a warm-up rollout and a timed one of 5 steps each)
then fills ``detail.canyon`` and its gate (no pair overflow, the
finest-radius count within K, the in-contact boundary within the crop)
is folded into ``exact``; without it ``canyon`` is null (the canyon file
is not in the repository).  Fields that are the TPU bench's own are null
here: ``flops_per_step`` (XLA's cost analysis of the compiled step has no
counterpart for an eager PyTorch step) and ``mfu_pct`` (computed against
a TPU peak).  ``vs_baseline`` keeps the root
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


# the root bench's canyon sizing: crop 8192 and scale capacities / pair
# budgets re-sized to the canyon contact set's measured occupancy (root
# bench.py, CANYON_OVERRIDES); the shipped YAML keeps the inflow regime's
# larger budgets
CANYON_OVERRIDES = {
    "scale_size_factor": [1.0, 1.35, 0.42],
    "neighbor_k_pairs": [[96, 288, 1408], [288, 288, 1312],
                         [320, 320, 288]],
    "conv_k_chunk": 0,
}
CANYON_BOOST = [2.0, 0.0, -1.2]
CANYON_CONFIG = os.path.join(os.path.dirname(CONFIG), "Liquid3d.yml")


def canyon_model(crop=8192, device="cuda"):
    """``configs/Liquid3d.yml`` with the canyon protocol's crop and
    overrides, weights from a ``torch.Generator`` seeded 0."""
    import yaml

    from .models import build_model

    with open(CANYON_CONFIG) as f:
        cfg = yaml.safe_load(f)["model"]
    cfg["boundary_crop_max"] = crop
    cfg.update(CANYON_OVERRIDES)
    return build_model(cfg, device=device,
                       generator=torch.Generator().manual_seed(0))


def bench_canyon(frame0, steps=5, crop=8192, device="cuda", model=None):
    """The root bench's canyon protocol (``bench.py:bench_canyon``) on a
    scene's frame 0 (a dict of numpy ``pos``, ``vel``, ``box``,
    ``box_normals``): ``canyon_model(crop)`` (or ``model``), the fluid
    boosted by CANYON_BOOST in rows rounded up to 128, one untimed rollout
    of ``steps`` steps, then the timed one.  Returns the detail dict, its
    gate over the timed steps included."""
    from . import resolve_device
    from .run_sample import scene_sample

    device = resolve_device(device)
    if model is None:
        model = canyon_model(crop, device)
    sample, pos0, _, box = scene_sample(model, frame0, vel=CANYON_BOOST,
                                        device=device, log=lambda s: None)
    timed_rollout(model, sample, steps)               # warm-up
    p, _, gate, dt = timed_rollout(model, sample, steps)
    fm = sample["fluid_mask"]
    return {
        "ms_per_step": 1000.0 * dt / steps,
        "steps_per_sec": steps / dt,
        "steps": steps,
        "n_fluid": int(pos0.shape[0]),
        "n_boundary": int(box.shape[0]),
        "boundary_crop": int(model.boundary_crop_max),
        # the in-contact boundary (max over the timed steps) must stay
        # within the crop, or the crop dropped coupled boundary
        "boundary_contact_count": gate.get("boundary_crop_count", 0),
        "cell_overflow": gate.get("cell_overflow"),
        "overrides": CANYON_OVERRIDES,
        "finite": bool(torch.isfinite(p[fm]).all()),
        "max_neighbors": gate["max_neighbors"],
        "neighbor_k": gate["neighbor_k"],
        "pair_overflow": gate["pair_overflow"],
        "pair_excess": gate["pair_excess"],
        "scale_counts": gate["scale_counts"],
        "scale_caps": gate["scale_caps"],
    }


def canyon_exact(canyon):
    """The canyon protocol's part of the bench's gate (root
    ``bench.py:308-315``)."""
    return (canyon["pair_overflow"] <= 0
            and canyon["max_neighbors"] <= canyon["neighbor_k"]
            and canyon["boundary_contact_count"] <= canyon["boundary_crop"])


def card():
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def run(device="cuda", steps=HORIZON, n_fluid=2304, canyon=None):
    """Build, warm up and time the bench rollout, and the canyon protocol
    where ``canyon`` (a scene's frame 0) is given; returns the result dict
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
    exact = gate["exact"]
    if canyon is not None:
        canyon = bench_canyon(canyon, device=device)
        exact = exact and canyon_exact(canyon)
    # the ratio of the printed value, so that the line agrees with itself
    # (rounding the rate first can move the ratio's last digit)
    steps_per_sec = round(steps / dt, 2)
    return {
        "metric": "WaterRamps_SymNet_rollout_steps_per_sec",
        "value": steps_per_sec,
        "unit": "steps/s",
        "vs_baseline": round(steps_per_sec / REFERENCE_STEPS_PER_SEC, 2),
        "detail": {
            "exact": exact,
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
            # the largest true voxel count of each pyramid scale over the
            # rollout against its padded capacity: a scale over its cap
            # dropped voxels (reported; only ``exact`` gates, as in the
            # root bench)
            "scale_counts": gate["scale_counts"],
            "scale_caps": gate["scale_caps"],
            "scales_fit": gate["scales_fit"],
            "canyon": canyon,
        },
    }


def main(argv):
    device = argv[argv.index("--device") + 1] if "--device" in argv \
        else "cuda"
    steps = int(argv[argv.index("--steps") + 1]) if "--steps" in argv \
        else HORIZON
    n_fluid = int(argv[argv.index("--n_fluid") + 1]) if "--n_fluid" in argv \
        else 2304
    canyon = None
    if "--canyon" in argv:
        from .data import read_msgpack_zst
        canyon = read_msgpack_zst(argv[argv.index("--canyon") + 1])[0]
    result = run(device, steps, n_fluid, canyon=canyon)
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
