"""``halo_rollout_host`` of the port (``dmcf_tpu_torch/parallel/
halo_model.py``) on 2 gloo ranks against the port's single-process
rollout, on the CPU, with the JAX tests' small multi-scale SymNet
(``test_halo_model.CFG`` at K 160, so that no pair drops a neighbour) on
narrower cuts of their scene.  The JAX package's counterpart is
``tests/test_halo_rollout.py``; the port's step itself is held against
JAX's in ``test_torch_halo_model.py``.

Tolerance: 5e-5 absolute on the positions (JAX's rollout tolerance, fp32
sums in another order over a few steps); reports exactly, every rank's
report equal, the frames on rank 0 alone (the others get None), and the
report's voxel counts (each rank's largest of the rollout) within the
pyramid's caps.  The boundary slices are rounded up to 64
rows (``bcap_round``), so each keeps a padded last row, as the
single-process sample does: ``obs_conv``'s clamped gather reads the last
boundary row (ROADMAP §3, a reference behaviour), and a slice that fills
its rows exactly would feed it a real particle there.
"""

import numpy as np
import torch

from dmcf_tpu_torch.models import build_model
from dmcf_tpu_torch.parallel import halo_model as hm
from dmcf_tpu_torch.parallel.dist import spawn
from dmcf_tpu_torch.rollout import rollout

import _torch_ranks
from test_halo_model import CFG, _scene

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

CFG_K = dict(CFG, neighbor_k=160)


def _single_rollout(model, sample, n_steps):
    frames = (torch.empty((n_steps + 1,) + sample["pos"].shape),
              torch.empty((n_steps + 1,) + sample["pos"].shape))
    rollout(model, sample, n_steps, frames=frames)
    return frames[0][1:].numpy()


def _run(sample, n_steps, kw):
    model = build_model(dict(CFG_K), device="cpu")
    want = _single_rollout(model, sample, n_steps)
    ranks = spawn(_torch_ranks.halo_rollout, 2,
                  args=(dict(CFG_K), model.state_dict(), sample, n_steps,
                        dict(kw, bcap_round=64)))
    m = sample["fluid_mask"].numpy()
    traj, report = ranks[0]
    assert report["halo_overflow"] == 0
    assert report["pair_overflow"] <= 0
    np.testing.assert_allclose(traj[:, m], want[:, m], rtol=0, atol=5e-5)
    assert (traj[:, ~m] == 0).all()
    assert ranks[1][0] is None               # the frames gather on rank 0
    assert ranks[1][1] == report
    counts = np.asarray(report["scale_counts"])
    assert counts.shape == (2, len(CFG_K["strides"]))
    assert report["scales_fit"] and (counts <= report["scale_caps"]).all()
    return report


def test_short_rollout_matches_single_process():
    sample = {k: torch.from_numpy(v) for k, v in _scene(nx=40).items()}
    report = _run(sample, 3, {"chunk": 3})
    assert report["repartitions"] == 0
    assert report["halo_width"] == 1.5 * hm.receptive_field(
        build_model(dict(CFG_K), device="cpu"))


def test_forced_repartition_stays_exact():
    """A drift along the slab axis (x, 30 a second: 0.3 a step) against a
    halo of three receptive fields.  Rank 0's right edge starts 0.025 left
    of its plane, so its step inputs pass half the halo (1.5) at step 7
    (drift 1.8), still inside the slack (halo - rf = 2): the first chunk
    (7 steps) is exact and reports the escape, and the rollout
    re-partitions (every rank alike, from all-gathered state) and goes on
    exact."""
    s = _scene(nx=24)
    s["vel"][:, 0] = 30.0
    sample = {k: torch.from_numpy(v) for k, v in s.items()}
    rf = hm.receptive_field(build_model(dict(CFG_K), device="cpu"))
    report = _run(sample, 9, {"chunk": 7, "halo_width": 3 * rf})
    assert report["repartitions"] == 1
    assert report["halo_escaped_max"] > 0
