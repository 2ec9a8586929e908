"""The benchmark scene (own copy of ``bench.build_scene``; the port
imports nothing of the JAX package) as a padded model sample, and a
generated scene of the canyon demo's size (``canyon_frame``; ``python -m
dmcf_tpu_torch.scene OUT.msgpack.zst`` writes it as a scene file)."""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .data.dataflow import pad_rollout_state


def build_scene(n_fluid=2304, spacing=0.01, seed=0):
    """Dam-break-like block resting on a ramped floor, GNS WaterRamps scale:
    fluid at rest spacing, boundary = floor + two walls + a ramp.
    Returns (pos [n_fluid, 3], box [B, 3], box_normals [B, 3]) fp32."""
    rng = np.random.RandomState(seed)
    side = int(np.ceil(np.sqrt(n_fluid)))
    xs, ys = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    pos = np.stack([xs.reshape(-1), ys.reshape(-1),
                    np.zeros(side * side)], -1)[:n_fluid] * spacing
    pos[:, 0] -= 0.45
    pos[:, 1] -= 0.45
    pos = pos + rng.normal(scale=spacing * 0.01, size=pos.shape)
    pos[:, 2] = 0.0

    m = int(1.0 / spacing)
    line = np.arange(m) * spacing - 0.5
    floor = np.stack([line, np.full(m, -0.5), np.zeros(m)], -1)
    left = np.stack([np.full(m, -0.5), line, np.zeros(m)], -1)
    right = np.stack([np.full(m, 0.5), line, np.zeros(m)], -1)
    ramp_x = np.arange(m // 2) * spacing
    ramp = np.stack([ramp_x, -0.5 + ramp_x * 0.5, np.zeros(m // 2)], -1)
    box = np.concatenate([floor, left, right, ramp], 0).astype(np.float32)
    nrm = np.zeros_like(box)
    nrm[:m, 1] = 1.0
    nrm[m:2 * m, 0] = 1.0
    nrm[2 * m:3 * m, 0] = -1.0
    nrm[3 * m:, 1] = 1.0
    return pos.astype(np.float32), box, nrm


def bench_sample(pos, box, nrm, grav=-9.81, bucket=128, device="cuda"):
    """The bench's initial state as a model sample on ``device``: fluid at
    rest under gravity, padded with ``pad_rollout_state(bucket=128)``
    (``bench.py`` main)."""
    device = resolve_device(device)
    data = {
        "pos": pos[None], "vel": np.zeros_like(pos)[None],
        "grav": np.broadcast_to(np.array([0, grav, 0], np.float32),
                                pos.shape)[None].copy(),
        "box": box, "box_normals": nrm,
    }
    state = pad_rollout_state(data, bucket=bucket)
    return {
        "pos": torch.as_tensor(state["pos"][0], device=device),
        "vel": torch.as_tensor(state["vel"][0], device=device),
        "grav": torch.as_tensor(state["grav"][0], device=device),
        "box": torch.as_tensor(state["box"], device=device),
        "box_normals": torch.as_tensor(state["box_normals"], device=device),
        "fluid_mask": torch.as_tensor(state["fluid_mask"], device=device),
        "box_mask": torch.as_tensor(state["box_mask"], device=device),
    }


def canyon_frame(block=(16, 5, 16), floor=396, wall_rows=30, height=0.0):
    """A generated scene of the canyon demo's size and contact load (frame
    0 as the msgpack scenes hold it: numpy ``pos``, ``vel``, ``box``,
    ``box_normals``): a block of ``block`` fluid particles at the
    DeepLagrangianFluids spacing 0.05 with a 1 % jitter, its lowest layer
    ``height`` plus one spacing above a square floor of ``floor`` x
    ``floor`` boundary particles at spacing 0.04 (normals up), in a
    channel of walls of ``wall_rows`` rows a spacing and a half from the
    block (normals inwards): two along the canyon protocol's velocity boost
    (2, 0, -1.2) in the x-z plane, so the fluid flows along the channel,
    and one across it behind the block.  The block sits a quarter of the
    way along x and mid-way along z.  The defaults give 1,280 fluid and
    185,436 boundary particles, the block resting on the floor: 6,119
    boundary particles lie within the crop's reach (0.8) of the fluid, near
    the canyon's 6,403 (root ``bench.py``), and the largest finest-radius
    (0.1) count is 39-44 in the first steps, the canyon's static maximum
    44 (``configs/Liquid3d.yml``).  A floor at the fluid's spacing 0.05
    reaches neither (1,948 and 33)."""
    spacing, bspacing = 0.05, 0.04
    rng = np.random.RandomState(0)
    axes = [np.arange(n) * spacing for n in block]
    pos = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    pos = pos + rng.normal(scale=spacing * 0.01, size=pos.shape)
    side = floor * bspacing
    pos[:, 0] += round(0.25 * floor) * bspacing
    pos[:, 2] += round((side - block[2] * spacing) / 2 / bspacing) * bspacing
    pos[:, 1] += height
    g = np.arange(floor) * bspacing
    fx, fz = np.meshgrid(g, g, indexing="ij")
    parts = [np.stack([fx.ravel(), np.full(fx.size, -spacing), fz.ravel()],
                      -1)]
    nrms = [np.tile([0.0, 1.0, 0.0], (fx.size, 1))]
    d = np.array([2.0, -1.2]) / np.hypot(2.0, -1.2)   # along the channel
    n = np.array([-d[1], d[0]])                       # across it
    xz = pos[:, [0, 2]]
    c = xz.mean(0)
    lo = (xz @ n).min() - 1.5 * spacing
    hi = (xz @ n).max() + 1.5 * spacing
    back = (xz @ d).min() - 1.5 * spacing
    ys = np.arange(wall_rows) * bspacing
    # each wall: a point of its line, its direction, its normal
    for start, u, nrm in ((c + (lo - c @ n) * n, d, n),
                          (c + (hi - c @ n) * n, d, -n),
                          (c + (back - c @ d) * d + (lo - c @ n) * n, n, d)):
        line = start + np.arange(-floor, floor)[:, None] * bspacing * u
        keep = (line >= 0).all(1) & (line < side).all(1)
        if u is n:   # the back wall spans the channel only
            keep &= (line @ n >= lo) & (line @ n <= hi)
        line = line[keep]
        wx = np.repeat(line[:, 0], len(ys))
        wz = np.repeat(line[:, 1], len(ys))
        wy = np.tile(ys, len(line))
        parts.append(np.stack([wx, wy, wz], -1))
        nrms.append(np.tile([nrm[0], 0.0, nrm[1]], (len(wx), 1)))
    return {"pos": pos.astype(np.float32),
            "vel": np.zeros((len(pos), 3), np.float32),
            "box": np.concatenate(parts).astype(np.float32),
            "box_normals": np.concatenate(nrms).astype(np.float32)}


def main(argv):
    """``python -m dmcf_tpu_torch.scene OUT.msgpack.zst [--block X Y Z]
    [--floor N]``: write ``canyon_frame``'s scene as a one-frame
    msgpack.zst scene (``data.write_msgpack_zst``: ``msgpack`` and the
    system's ``libzstd.so.1``)."""
    from .data import write_msgpack_zst

    kw = {}
    if "--block" in argv:
        i = argv.index("--block")
        kw["block"] = tuple(int(v) for v in argv[i + 1:i + 4])
    if "--floor" in argv:
        kw["floor"] = int(argv[argv.index("--floor") + 1])
    frame = canyon_frame(**kw)
    n = len(frame["pos"])
    frame.update(frame_id=0, scene_id="generated",
                 grav=np.tile(np.array([0, -9.81, 0], np.float32), (n, 1)))
    write_msgpack_zst(argv[0], [frame])
    print(f"wrote {argv[0]}: {n} fluid, {len(frame['box'])} boundary")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main(sys.argv[1:]))
