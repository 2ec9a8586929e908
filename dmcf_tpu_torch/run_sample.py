"""Large-scene inference with particle inflow (port of the root
``run_sample.py``):

    python -m dmcf_tpu_torch.run_sample -c configs/Liquid3d.yml \\
        --data_path scene.msgpack.zst --timesteps 41 --inflow 40 \\
        --inflow_every 10 --boundary_crop_max 65536 --vel 2 0 -1.2 \\
        [--tf_ckpt ref/ckpt | --ckpt_path ckpt.pt] [--chunk N] \\
        [--device cuda|cpu]
    torchrun --nproc_per_node N -m dmcf_tpu_torch.run_sample \\
        -c configs/Liquid3d.yml --data_path scene.msgpack.zst \\
        --spatial halo [--halo_width W] [--chunk N] [--device cpu]

Reads frame 0 of a msgpack.zst scene, rolls the model out for
``--timesteps - 1`` steps and writes the trajectory (frame 0 and every
step's positions, 1000 on rows not yet active) and the boundary to
``<output_dir>/example/0000/0000.hdf5``.

The particle buffer has a fixed capacity, as in the reference: the
initial block plus one block for each inflow event, rounded up to 128
rows, the rows not yet active at sentinel positions.  At step t the
initial block (positions and boosted velocities) is injected into the next
free rows when t < ``--inflow``, t % every == every - 1 and the block
fits; the active count is kept on the host, so the decision needs no
device read.  ``--chunk`` is the number of steps between copies of the
frames to the host (0: one copy at the end).  The report gives the largest
true finest-radius count against K, each pair's excess over its budget,
the cell search's dropped window rows, the in-contact boundary against the
crop's capacity and each pyramid scale's largest count against its
capacity.

``run_sample`` is the in-memory part (a built model and frame 0 in, frames
and report out).  The scene is read through ``libzstd.so.1`` and the
frames written by ``data/hdf5.py``, so neither ``zstandard`` nor ``h5py``
is needed.  ``--tf_ckpt`` loads a reference
TensorFlow checkpoint (``utils/tf_ckpt.py``, read without TensorFlow) and
takes precedence over ``--ckpt_path``, as in the root script.

``--spatial halo`` runs the rollout slab-decomposed over the ranks of a
``torchrun`` job (``parallel/halo_model.halo_rollout_host``: one process
a rank on ``cuda:$LOCAL_RANK`` with NCCL, or on the CPU with gloo under
``--device cpu``), with the full boundary (no crop), ``--chunk`` steps
between re-partition checks (default 10) and ``--halo_width`` (default
1.5 x the model's receptive field); it takes no ``--inflow`` and no
``--boundary_crop_max``, as in the root script.  Every rank rolls out;
rank 0 prints the halo report and writes the frames
(``run_sample_halo`` is its in-memory part).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from .rollout import Gate


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Run a network")
    parser.add_argument("-c", "--cfg_file", help="path to the config file")
    parser.add_argument("--ckpt_path", help="path to a checkpoint of the "
                        "port (a .pt file that run_pipeline saved)")
    parser.add_argument("--tf_ckpt", help="reference TensorFlow checkpoint "
                        "prefix (e.g. checkpoints/Liquid3d/ckpt)")
    parser.add_argument("--data_path", help="path to the scene data (a "
                        "msgpack.zst scene; frame 0 is read)")
    parser.add_argument("--inflow", default=0, type=int,
                        help="inflow timing (steps with re-injection)")
    parser.add_argument("--inflow_every", default=2, type=int,
                        help="re-inject the initial block every N steps")
    parser.add_argument("--timesteps", default=None, type=int)
    parser.add_argument("--vel", default=None, type=float, nargs=3,
                        help="initial/inflow velocity boost (default "
                             "[10, 0, -6], the reference demo's)")
    parser.add_argument("--chunk", default=0, type=int,
                        help="rollout steps between device->host copies "
                             "of the frames (0 = one copy at the end)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--output_dir", default="output")
    parser.add_argument("--boundary_crop_margin", type=float, default=None,
                        help="optional static AABB pre-crop margin for the "
                             "boundary (host-side)")
    parser.add_argument("--boundary_crop_max", type=int, default=0,
                        help="per-step boundary working-set size (the "
                             "model's contact crop)")
    parser.add_argument("--neighbor_k", type=int, default=0,
                        help="override model.neighbor_k")
    parser.add_argument("--spatial", default="none",
                        choices=["none", "halo"],
                        help="'halo': slab decomposition over the ranks of "
                             "a torchrun job (full boundary, no crop)")
    parser.add_argument("--halo_width", type=float, default=0.0)
    parser.add_argument("--override", action="append", default=[],
                        help="model-config override key=yaml_value "
                             "(repeatable)")
    return parser.parse_known_args(argv)[0]


def _round_up(n, m=128):
    return int(-(-n // m) * m)


def scene_sample(model, frame0, vel=None, boundary_crop_margin=None,
                 capacity=None, device="cuda", log=print):
    """Frame 0 of a scene as the rollout's padded sample: the fluid (its
    velocity plus the boost ``vel``, default [10, 0, -6]) in ``capacity``
    rows (default: its own count rounded up to 128), the boundary in
    rows rounded up to 128, sentinels beyond.  Returns (sample, pos0, vel0,
    box) with pos0/vel0 the boosted block and box the boundary kept."""
    from . import resolve_device
    from .data.dataflow import pad_particles, sentinel_rows

    device = resolve_device(device)
    pos0 = np.asarray(frame0["pos"], np.float32)
    boost = vel if vel is not None else [10.0, 0.0, -6.0]
    vel0 = np.asarray(frame0["vel"], np.float32) + np.asarray(boost,
                                                             np.float32)
    box = np.asarray(frame0["box"], np.float32)
    nrm = np.asarray(frame0["box_normals"], np.float32)
    n0 = pos0.shape[0]
    if boundary_crop_margin is not None:
        lo = pos0.min(0) - boundary_crop_margin
        hi = pos0.max(0) + boundary_crop_margin
        keep = np.all((box >= lo) & (box <= hi), axis=-1)
        box, nrm = box[keep], nrm[keep]
        log(f"boundary cropped: {keep.sum()}/{keep.size}")
    capacity = capacity or _round_up(n0)
    pos = np.concatenate([pos0, sentinel_rows(capacity - n0)], 0)
    velp = np.concatenate([vel0, np.zeros((capacity - n0, 3), np.float32)])
    grav = np.zeros((capacity, 3), np.float32)
    grav[:, 1] = float(model.grav)
    b_cap = _round_up(box.shape[0])
    box_p = pad_particles(box, b_cap)
    box_p[box.shape[0]:] = sentinel_rows(b_cap - box.shape[0],
                                         offset=capacity)
    sample = {
        "pos": pos, "vel": velp, "grav": grav, "box": box_p,
        "box_normals": pad_particles(nrm, b_cap),
        "fluid_mask": np.arange(capacity) < n0,
        "box_mask": np.arange(b_cap) < box.shape[0],
    }
    sample = {k: torch.as_tensor(v, device=device) for k, v in
              sample.items()}
    return sample, pos0, vel0, box


def capacity_for(n0, timesteps, inflow=0, inflow_every=2):
    """Rows of the buffer: the initial block and one block an inflow
    event, rounded up to 128."""
    every = max(int(inflow_every), 1)
    n_events = max(min(int(inflow), timesteps) // every, 0)
    return _round_up((1 + n_events) * n0)


@torch.no_grad()
def run_sample(model, frame0, timesteps, *, inflow=0, inflow_every=2,
               chunk=0, vel=None, boundary_crop_margin=None, device="cuda",
               log=print):
    """Roll ``model`` out from ``frame0`` (a dict of numpy ``pos``, ``vel``,
    ``box``, ``box_normals``) for ``timesteps - 1`` steps with inflow.
    Returns (frames [timesteps, capacity, 3] numpy, 1000 on inactive rows;
    report dict, also printed through ``log``)."""
    n0 = np.asarray(frame0["pos"]).shape[0]
    every = max(int(inflow_every), 1)
    capacity = capacity_for(n0, timesteps, inflow, inflow_every)
    sample, pos0, vel0, box = scene_sample(
        model, frame0, vel=vel, boundary_crop_margin=boundary_crop_margin,
        capacity=capacity, device=device, log=log)
    dev = sample["pos"].device
    block_pos = torch.tensor(pos0, device=dev)
    block_vel = torch.tensor(vel0, device=dev)
    log(f"scene: {n0} fluid (capacity {capacity}), "
        f"{int(sample['box_mask'].sum())} boundary; {timesteps} steps")

    n_steps = max(timesteps - 1, 1)
    exe = min(chunk, n_steps) if chunk else n_steps
    pos, velt, mask = sample["pos"], sample["vel"], sample["fluid_mask"]
    n_active = n0
    gate = Gate(dev)
    buf_p = torch.empty((exe, capacity, 3), device=dev)
    buf_m = torch.empty((exe, capacity), dtype=torch.bool, device=dev)
    ps_parts, ms_parts, actives = [], [], []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    for t in range(n_steps):
        s = dict(sample, pos=pos, vel=velt, fluid_mask=mask)
        pos, velt, aux = model(s)
        gate.update(aux)
        if (t < inflow and t % every == every - 1
                and n_active + n0 <= capacity):
            sl = slice(n_active, n_active + n0)
            pos[sl], velt[sl] = block_pos, block_vel   # the step's outputs
            mask = mask.clone()
            mask[sl] = True
            n_active += n0
        actives.append(n_active)
        buf_p[t % exe], buf_m[t % exe] = pos, mask
        if t % exe == exe - 1 or t == n_steps - 1:
            take = t % exe + 1
            # a copy also on the CPU, where .cpu() would alias the buffer
            ps_parts.append(buf_p[:take].to("cpu", copy=True).numpy())
            ms_parts.append(buf_m[:take].to("cpu", copy=True).numpy())
    seconds = time.time() - t0
    log("Average runtime: %.05f s/step (%d steps)" % (seconds / n_steps,
                                                       n_steps))

    g = gate.result(model.neighbor_k, n_steps)
    report = {"n_fluid": n0, "capacity": capacity,
              "n_boundary": int(sample["box_mask"].sum()),
              "steps": n_steps, "seconds": seconds,
              "ms_per_step": 1e3 * seconds / n_steps, "n_active": actives,
              "max_neighbors": g["max_neighbors"],
              "neighbor_k": g["neighbor_k"],
              "pair_overflow": g["pair_overflow"],
              "pair_overflow_detail": g["pair_excess"],
              "scale_counts": g["scale_counts"],
              "scale_caps": g["scale_caps"]}
    k = report["neighbor_k"]
    log(f"max true neighbor count over rollout: {report['max_neighbors']} "
        f"(K={k})" + (" — OVERFLOW, neighbors dropped; raise --neighbor_k"
                      if report["max_neighbors"] > k else ""))
    if report["pair_overflow"] > 0:
        log(f"pair-search overflow: worst true count exceeded its pair K "
            f"budget by {report['pair_overflow']}")
    for key in sorted(report["pair_overflow_detail"]):
        if report["pair_overflow_detail"][key] > 0:
            log(f"  pair {key}: true count exceeded K by "
                f"{report['pair_overflow_detail'][key]}")
    if "cell_overflow" in g:
        report["cell_overflow"] = g["cell_overflow"]
        log(f"max cell-search window overflow over rollout: "
            f"{report['cell_overflow']}" + (
                " — CELL OVERFLOW, candidates dropped; raise cell_occ_cap"
                if report["cell_overflow"] > 0 else ""))
    crop_max = int(model.boundary_crop_max or 0)
    if crop_max:
        cc = g["boundary_crop_count"]
        report["boundary_crop_count"] = cc
        report["boundary_crop_max"] = crop_max
        log(f"max in-contact boundary over rollout: {cc} (crop "
            f"capacity {crop_max})" + (
                " — CROP OVERFLOW, boundary support dropped; raise "
                "--boundary_crop_max" if cc > crop_max else ""))
    if any(report["scale_counts"]):
        over = [c > cap for c, cap in zip(report["scale_counts"],
                                           report["scale_caps"])]
        log(f"max scale occupancy over rollout: {report['scale_counts']} "
            f"(capacities {report['scale_caps']})" + (
                " — SCALE OVERFLOW, voxels dropped; raise "
                "scale_size_factor" if any(over) else ""))

    # frame 0 and the rollout's frames, 1000 on inactive rows
    ps = np.concatenate(ps_parts, 0)
    ms = np.concatenate(ms_parts, 0)
    out = np.full((timesteps, capacity, 3), 1000.0, np.float32)
    out[0, :n0] = pos0
    for i in range(min(ps.shape[0], timesteps - 1)):
        out[i + 1][ms[i]] = ps[i][ms[i]]
    report["box"] = box
    return out, report


def run_sample_halo(model, frame0, timesteps, group, *, chunk=10,
                    halo_width=None, vel=None, boundary_crop_margin=None,
                    log=print):
    """``run_sample``'s slab-decomposed counterpart, run by every rank of
    ``group`` on the same ``frame0`` and weights: ``timesteps - 1`` steps
    of ``halo_rollout_host`` over the full boundary.  Returns (frames
    [timesteps, capacity, 3] numpy, 1000 on inactive rows, on rank 0 and
    None on the others; the halo report with ``seconds``,
    ``ms_per_step``, ``box``, the same on every rank); ``log`` gets the
    re-partitions and the report."""
    from .parallel.halo_model import halo_rollout_host

    sample, pos0, _, box = scene_sample(
        model, frame0, vel=vel, boundary_crop_margin=boundary_crop_margin,
        device="cpu", log=log)
    n0, capacity = pos0.shape[0], sample["pos"].shape[0]
    log(f"scene: {n0} fluid (capacity {capacity}), {box.shape[0]} "
        f"boundary; {timesteps} steps over {group.world_size} ranks "
        f"({group.transport})")
    n_steps = max(timesteps - 1, 1)
    if group.device.type == "cuda":
        torch.cuda.synchronize(group.device)
    t0 = time.time()
    frames, report = halo_rollout_host(
        model, group, sample, n_steps, chunk=chunk or 10,
        halo_width=halo_width or None, log=log)
    seconds = time.time() - t0
    report.update(seconds=seconds, ms_per_step=1e3 * seconds / n_steps)
    log("Average runtime: %.05f s/step (%d steps, %d ranks)"
        % (seconds / n_steps, n_steps, group.world_size))
    log(f"halo report: {report}")
    if report["halo_overflow"] > 0:
        log("HALO OVERFLOW: exchange buffer too small — results dropped "
            "boundary-zone particles; raise halo_cap")
    if report["pair_overflow"] > 0:
        log(f"pair-search overflow: worst true count exceeded its pair K "
            f"budget by {report['pair_overflow']}")
    report["box"] = box
    if frames is None:
        return None, report
    fmask = sample["fluid_mask"].numpy()
    out = np.full((timesteps, capacity, 3), 1000.0, np.float32)
    out[0, :n0] = pos0
    out[1:, fmask] = frames[:timesteps - 1, fmask]
    return out, report


def main(argv=None):
    import yaml

    from .data import read_msgpack_zst, write_results
    from .models import build_model

    args = parse_args(argv)
    group = None
    if args.spatial == "halo":
        if args.inflow:
            raise SystemExit("--spatial halo does not support --inflow")
        if args.boundary_crop_max:
            raise SystemExit("--spatial halo replaces the boundary crop "
                             "(full boundary): drop --boundary_crop_max")
        from .parallel.spatial import make_spatial_mesh
        group = make_spatial_mesh(args.device)
        args.device = group.device
    np.random.seed(42)
    with open(args.cfg_file) as f:
        cfg = yaml.safe_load(f)
    if args.boundary_crop_max:
        cfg["model"]["boundary_crop_max"] = args.boundary_crop_max
    if args.neighbor_k:
        cfg["model"]["neighbor_k"] = args.neighbor_k
    for ov in args.override:
        key, val = ov.split("=", 1)
        cfg["model"][key] = yaml.safe_load(val)
    model = build_model(cfg["model"], device=args.device,
                        generator=torch.Generator().manual_seed(0))
    if args.tf_ckpt:
        from .utils.tf_ckpt import load_tf_reference_checkpoint
        model.load_state_dict(
            load_tf_reference_checkpoint(args.tf_ckpt, model), strict=True)
        print(f"Converted reference TF checkpoint {args.tf_ckpt}")
    elif args.ckpt_path:
        state = torch.load(args.ckpt_path, map_location=model.device,
                           weights_only=True)
        model.load_state_dict(state.get("model", state))
        print(f"Restored from {args.ckpt_path}")
    else:
        print("No checkpoint given: using random init")

    if not args.data_path:
        raise SystemExit("run_sample: give the scene with --data_path")
    data = read_msgpack_zst(args.data_path)
    timesteps = args.timesteps if args.timesteps is not None else len(data)
    if group is not None:
        with group:
            main_rank = group.rank == 0
            out, report = run_sample_halo(
                model, data[0], timesteps, group, chunk=args.chunk,
                halo_width=args.halo_width, vel=args.vel,
                boundary_crop_margin=args.boundary_crop_margin,
                log=print if main_rank else (lambda *a: None))
        if not main_rank:
            return 0
    else:
        out, report = run_sample(
            model, data[0], timesteps, inflow=args.inflow,
            inflow_every=args.inflow_every, chunk=args.chunk, vel=args.vel,
            boundary_crop_margin=args.boundary_crop_margin,
            device=args.device)
    out_dir = os.path.join(args.output_dir, "example", "0000")
    path = os.path.join(out_dir, "0000.hdf5")
    write_results(path, type(model).__name__,
                  [(out, {"name": "pred", "type": "PARTICLE"}),
                   (report["box"], {"name": "bnd", "type": "PARTICLE"})])
    print("wrote", path)
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
