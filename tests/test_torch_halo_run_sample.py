"""``run_sample --spatial halo`` of the port on 2 gloo ranks
(``parallel.dist.spawn``; rank bodies in ``_torch_ranks.py``) against the
single-process ``run_sample``, on the CPU: ``configs/Liquid3d.yml`` at
narrowed channels and K budgets, roomy scale caps, precision "highest",
on a small scene file.  Rank 0 writes the single-process frames within
5e-5 (JAX's rollout tolerance), the other rank writes nothing, and the
flags the root script refuses with the halo (``--inflow``,
``--boundary_crop_max``) stop it.
"""

import os

import h5py
import numpy as np
import pytest
import torch
import yaml

from dmcf_tpu_torch import run_sample
from dmcf_tpu_torch.data import write_msgpack_zst
from dmcf_tpu_torch.models import build_model
from dmcf_tpu_torch.parallel.dist import spawn

import _torch_ranks

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

LIQUID = os.path.join(os.path.dirname(__file__), "..", "configs",
                      "Liquid3d.yml")
# narrowed channels and K budgets (each above its pair's largest count on
# this scene, 397 the widest); scale caps with room, so that no decomposition drops a voxel
# (a pyramid over its cap keeps other voxels on a slab than on the whole
# scene)
NARROW = {"layer_channels": [[[4]], [[4], [4], [4]], [[4], [4], [4]],
                             [[4]], [[3]]],
          "neighbor_k_pairs": [[96, 256, 256], [256, 256, 448],
                               [160, 160, 160]],
          "precision": "highest", "scale_size_factor": [1.0, 2.0, 1.0]}


def _scene_file(path):
    """A 8 x 3 x 4 block at spacing 0.05 on a 14 x 8 floor, one frame."""
    rng = np.random.RandomState(0)
    axes = [np.arange(n) * 0.05 for n in (8, 3, 4)]
    pos = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    pos = (pos + rng.normal(scale=5e-4, size=pos.shape)).astype(np.float32)
    fx, fz = np.meshgrid(np.arange(-3, 11) * 0.05, np.arange(-2, 6) * 0.05,
                         indexing="ij")
    box = np.stack([fx.ravel(), np.full(fx.size, -0.05), fz.ravel()],
                   -1).astype(np.float32)
    nrm = np.tile(np.float32([0, 1, 0]), (len(box), 1))
    write_msgpack_zst(path, [{"pos": pos, "vel": np.zeros_like(pos),
                              "box": box, "box_normals": nrm}])
    return {"pos": pos, "vel": np.zeros_like(pos), "box": box,
            "box_normals": nrm}


def test_run_sample_spatial_halo(tmp_path):
    frame0 = _scene_file(str(tmp_path / "s.msgpack.zst"))
    over = [f"--override={k}={v}" for k, v in NARROW.items()]
    argv = ["-c", LIQUID, "--device", "cpu", "--data_path",
            str(tmp_path / "s.msgpack.zst"), "--timesteps", "4",
            "--vel", "0.5", "0", "0", "--chunk", "2"] + over
    with pytest.raises(SystemExit, match="inflow"):
        run_sample.main(argv + ["--spatial", "halo", "--inflow", "2"])
    with pytest.raises(SystemExit, match="crop"):
        run_sample.main(argv + ["--spatial", "halo",
                                "--boundary_crop_max", "64"])
    outs = [str(tmp_path / f"out{r}") for r in range(2)]
    ranks = spawn(_torch_ranks.run_sample_rank_dirs, 2,
                  args=(argv + ["--spatial", "halo"], outs))
    assert ranks == [0, 0]
    assert not os.path.exists(outs[1])       # rank 1 writes nothing
    with h5py.File(os.path.join(outs[0], "example", "0000", "0000.hdf5"),
                   "r") as f:
        got = f["SymNet"]["pred"][()]

    with open(LIQUID) as f:
        cfg = dict(yaml.safe_load(f)["model"], **NARROW)
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    want, report = run_sample.run_sample(model, frame0, 4, vel=[0.5, 0, 0],
                                         device="cpu", log=lambda *a: None)
    assert report["pair_overflow"] <= 0
    assert all(c <= k for c, k in zip(report["scale_counts"],
                                      report["scale_caps"]))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)
