"""Where the canyon protocol first passes a pair budget, in the JAX package
and in the port, on the CPU, with the same weights:

    python -m scripts.canyon_budget [--steps 8] [--threads 4]

The protocol is root ``bench.py``'s ``bench_canyon``: ``configs/Liquid3d.yml``
with ``CANYON_OVERRIDES``, a contact crop of 8192 and the velocity boost
[2, 0, -1.2], here on ``dmcf_tpu_torch.scene.canyon_frame()`` (the
generated scene of the canyon's size; the canyon file is not in the
repository).  Three rollouts of ``--steps`` steps, each from frame 0:

- ``jax``: the JAX package with its random init from ``PRNGKey(0)`` (root
  ``bench_canyon``'s weights);
- ``port/jax-weights``: the port with those weights, converted through
  ``interop.params_from_flax``;
- ``port/seed-0``: the port with its own seed-0 weights
  (``bench.canyon_model``, the weights that ``chip_smoke.py`` phase 19
  runs on the card).

For each step it prints the in-contact boundary count, the largest true
finest-radius count, the largest excess of any pair over its K budget
(and the pair) and the finest-radius cell-search window overflow; then,
for each rollout, the first step at which a pair's true count passed its
budget (the canyon gate's ``pair_overflow > 0``) and the largest position
gap between the two rollouts with JAX's weights.  Imports JAX: this
script is no part of the port.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg():
    from dmcf_tpu_torch.bench import CANYON_OVERRIDES

    with open(os.path.join(ROOT, "configs", "Liquid3d.yml")) as f:
        cfg = yaml.safe_load(f)["model"]
    cfg["boundary_crop_max"] = 8192
    cfg.update(CANYON_OVERRIDES)
    return cfg


def _step_row(aux):
    excess = {k: int(v) for k, v in aux["pair_overflow_detail"].items()}
    worst = max(excess, key=excess.get)
    return {"contact": int(aux["boundary_crop_count"]),
            "max_neighbors": int(aux["neighbor_overflow"]),
            "excess": excess[worst], "pair": worst,
            "cell_overflow": int(aux.get("cell_overflow", 0))}


def jax_rollout(frame, steps):
    """Root ``bench_canyon``'s sample and weights; the model applied one
    step at a time so each step's aux is read.  Returns (rows, positions
    [steps, N, 3], params)."""
    import jax
    import jax.numpy as jnp

    from dmcf_tpu.models import build_model
    from dmcf_tpu_torch.bench import CANYON_BOOST
    from dmcf_tpu_torch.run_sample import scene_sample

    model = build_model(_cfg())
    sample, *_ = scene_sample(model, frame, vel=CANYON_BOOST, device="cpu",
                              log=lambda m: None)
    s = {k: jnp.asarray(v.numpy()) for k, v in sample.items()}
    params = jax.jit(lambda key, x: model.init(key, x, training=False))(
        jax.random.PRNGKey(0), s)
    step = jax.jit(lambda p, x: model.apply(p, x, training=False))
    rows, traj = [], []
    for _ in range(steps):
        pos, vel, aux = step(params, s)
        s = dict(s, pos=pos, vel=vel)
        rows.append(_step_row(jax.tree.map(np.asarray, aux)))
        traj.append(np.asarray(pos))
    return rows, np.stack(traj), jax.tree.map(np.asarray, params)


def port_rollout(frame, steps, state=None):
    """The port on the CPU with ``state`` (a converted parameter dict) or
    its own seed-0 weights."""
    import torch

    from dmcf_tpu_torch.bench import CANYON_BOOST, canyon_model
    from dmcf_tpu_torch.run_sample import scene_sample

    model = canyon_model(8192, "cpu")
    if state is not None:
        model.load_state_dict(state)
    sample, *_ = scene_sample(model, frame, vel=CANYON_BOOST, device="cpu",
                              log=lambda m: None)
    rows, traj = [], []
    s = dict(sample)
    with torch.no_grad():
        for _ in range(steps):
            s["pos"], s["vel"], aux = model(s)
            rows.append(_step_row(aux))
            traj.append(s["pos"].numpy().copy())
    return rows, np.stack(traj)


def first_past(rows):
    return next((t for t, r in enumerate(rows) if r["excess"] > 0), None)


def main(argv):
    steps = int(argv[argv.index("--steps") + 1]) if "--steps" in argv \
        else 8
    threads = int(argv[argv.index("--threads") + 1]) \
        if "--threads" in argv else 4
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(threads)
    from dmcf_tpu_torch.interop import params_from_flax
    from dmcf_tpu_torch.scene import canyon_frame

    frame = canyon_frame()
    print(f"scene: {len(frame['pos'])} fluid, {len(frame['box'])} "
          f"boundary; {steps} steps", flush=True)
    runs = {}
    t0 = time.time()
    rows, traj_j, params = jax_rollout(frame, steps)
    runs["jax"] = rows
    print(f"jax: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    runs["port/jax-weights"], traj_p = port_rollout(
        frame, steps, params_from_flax(params))
    print(f"port/jax-weights: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    runs["port/seed-0"], _ = port_rollout(frame, steps)
    print(f"port/seed-0: {time.time() - t0:.1f} s", flush=True)

    n = len(frame["pos"])
    for name, rows in runs.items():
        print(f"== {name}")
        for t, r in enumerate(rows):
            gap = ""
            if name == "port/jax-weights":
                d = np.abs(traj_p[t, :n] - traj_j[t, :n]).max()
                gap = f"  |port - jax| {d:.3e}"
            print(f"  step {t:2d}: in contact {r['contact']:5d}, max "
                  f"neighbours {r['max_neighbors']:3d}, worst excess "
                  f"{r['excess']:5d} ({r['pair']}), window overflow "
                  f"{r['cell_overflow']}{gap}")
    for name, rows in runs.items():
        print(f"{name}: first step past a pair budget: {first_past(rows)}; "
              f"in contact at step 0: {rows[0]['contact']}, largest "
              f"{max(r['contact'] for r in rows)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
