"""The voxel pyramid of ``configs/Liquid3d.yml`` on ``chip_smoke.py``'s
Liquid3d scene, built by the JAX package and by the port, on the CPU:

    python -m scripts.liquid_pyramid [--block 22x6x22] [--pairs]

Both build it from the same input, the positions that the model's first
step advects (``integrate_pos_vel``) and the boundary, as the model does.
Prints each scale's stamped voxels (``counts``) against its padded
capacity (``caps``, ``scale_size_factor`` of the rows) for both packages,
and the share of each scale's voxels that the cap drops.  ``--block``
sizes the fluid block (particles an axis; the smoke's by default);
``--pairs`` also runs the port's first model step on the scene (narrow
channels, the config's budgets) and prints the neighbours in range of
each conv pair beyond its budget (``pair_overflow_detail``).  Imports
JAX: this script is no part of the port.
"""

from __future__ import annotations

import os

import numpy as np
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def narrow_model():
    """``configs/Liquid3d.yml``'s model with two channels a layer (the
    pyramid and the searches read no channel width), on the CPU."""
    from dmcf_tpu_torch.models import build_model

    with open(os.path.join(ROOT, "configs", "Liquid3d.yml")) as f:
        cfg = yaml.safe_load(f)["model"]
    cfg.update(layer_channels=[[[2]], [[2], [2], [2]], [[2], [2], [2]],
                               [[2]], [[3]]], precision="highest")
    return build_model(cfg, device="cpu")


def pyramids(block=None):
    """(jax_counts, port_counts, caps) of the smoke's Liquid3d scene (or a
    ``block`` of another shape), one entry a scale."""
    import jax.numpy as jnp
    import torch

    from chip_smoke import LIQUID_BLOCK, liquid_scene
    from dmcf_tpu.ops import get_dilated_pos as jax_dilated
    from dmcf_tpu_torch.ops.sph import get_dilated_pos, masked_positions
    from dmcf_tpu_torch.scene import bench_sample

    m = narrow_model()
    s = bench_sample(*liquid_scene(block or LIQUID_BLOCK), device="cpu")
    # the model's base set (use_bnds): advected fluid and boundary rows
    adv = m.integrate_pos_vel(s["pos"], s["vel"], s["grav"])[0]
    pos = torch.cat([masked_positions(adv, s["fluid_mask"]),
                     masked_positions(s["box"], s["box_mask"])])
    mask = torch.cat([s["fluid_mask"], s["box_mask"]])
    caps = [pos.shape[0] if st == 1 else
            max(8, int(np.ceil(pos.shape[0] * f)))
            for st, f in zip(m.strides, m.scale_size_factor)]
    vox = np.asarray(m.voxel_size, np.float32)
    kw = dict(voxel_size=vox, centralize=m.centralize, pad=m.sample_pad,
              hyst=m.sample_hyst)
    port = get_dilated_pos(pos, mask, list(m.strides), caps, **kw)[2]
    jx = jax_dilated(jnp.asarray(pos.numpy()), jnp.asarray(mask.numpy()),
                     list(m.strides), caps, **kw)[2]
    return ([int(c) for c in jx], [int(c) for c in port], caps)


def main(argv=None):
    import argparse

    import jax

    ap = argparse.ArgumentParser()
    ap.add_argument("--block", default=None)
    ap.add_argument("--pairs", action="store_true")
    args = ap.parse_args(argv)
    block = (tuple(int(v) for v in args.block.split("x")) if args.block
             else None)
    jax.config.update("jax_platforms", "cpu")
    jc, pc, caps = pyramids(block)
    print(f"Liquid3d scene pyramid: JAX counts {jc}, port counts {pc}, "
          f"caps {caps}")
    print("dropped share a scale: " + ", ".join(
        f"{max(0.0, 1 - cap / c):.4f}" for c, cap in zip(jc, caps)))
    if args.pairs:
        import torch

        from chip_smoke import LIQUID_BLOCK, liquid_scene
        from dmcf_tpu_torch.scene import bench_sample

        torch.set_num_threads(2)
        s = bench_sample(*liquid_scene(block or LIQUID_BLOCK),
                         device="cpu")
        with torch.no_grad():
            aux = narrow_model()(s)[2]
        over = {k: int(v) for k, v in aux["pair_overflow_detail"].items()
                if int(v) > 0}
        print(f"rows {s['pos'].shape[0] + s['box'].shape[0]}, "
              f"pair_overflow {int(aux['pair_overflow'])}, beyond budget "
              f"{over}")


if __name__ == "__main__":
    main()
