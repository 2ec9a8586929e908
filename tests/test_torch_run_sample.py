"""The port's ``run_sample`` CLI (``python -m dmcf_tpu_torch.run_sample``)
on the CPU, on the tiny generated scene of ``tests/test_run_sample.py``
(64 fluid, 48 boundary; ``configs/Liquid3d.yml`` at full width and its
precision, a bf16 trunk): the inflow counts, the hdf5 file and the report
lines; its frames against root ``run_sample.py`` (JAX, random init from
``PRNGKey(0)``) with the same weights, which the test rebuilds in process
from ``PRNGKey(0)``, converts through ``interop.params_from_flax`` and
saves as a port checkpoint; and ``--spatial halo``'s refusal of
``--inflow`` (``--tf_ckpt`` has its tests in
``tests/test_torch_tf_ckpt.py``).

Tolerance of the frames: 1e-5 absolute on positions (|x| <= 0.6; four
steps of a bf16 trunk whose sums the two packages take in other orders;
the measured gap is 2.4e-7).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dmcf_tpu.models import build_model as jax_build_model
from dmcf_tpu_torch import run_sample
from dmcf_tpu_torch.data import write_msgpack_zst
from dmcf_tpu_torch.interop import params_from_flax

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIG = "configs/Liquid3d.yml"
STEPS = 5
ARGS = ["-c", CONFIG, "--device", "cpu", "--timesteps", str(STEPS),
        "--inflow", "4", "--inflow_every", "2", "--chunk", "2",
        "--vel", "0", "0", "0"]


def _make_scene(path):
    """``tests/test_run_sample.py``'s scene: an 8 x 8 fluid sheet at
    spacing 0.05 above two boundary lines."""
    n, side = 64, 8
    xs, ys = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    pos = np.stack([xs.reshape(-1) * 0.05, 0.3 + ys.reshape(-1) * 0.05,
                    np.full(n, 0.5)], -1).astype(np.float32)
    m = 24
    line = np.arange(m) * 0.05
    box = np.concatenate([
        np.stack([line, np.zeros(m), np.full(m, 0.5)], -1),
        np.stack([line, np.zeros(m) + 0.05, np.full(m, 0.45)], -1),
    ]).astype(np.float32)
    nrm = np.zeros_like(box)
    nrm[:, 1] = 1.0
    write_msgpack_zst(path, [{
        "frame_id": 0, "scene_id": "t0", "pos": pos,
        "vel": np.zeros_like(pos),
        "grav": np.tile(np.array([0, -9.81, 0], np.float32), (n, 1)),
        "box": box, "box_normals": nrm}])
    return pos, box, nrm


def _jax_weights_as_port_ckpt(path, pos, box, nrm):
    """root run_sample.py's random init (``model.init(PRNGKey(0), ...)``
    on the full-capacity sample; the values depend on the key and the
    parameter tree only) as a port checkpoint."""
    with open(os.path.join(ROOT, CONFIG)) as f:
        cfg = yaml.safe_load(f)["model"]
    jm = jax_build_model(cfg)
    cap = 256  # 64 fluid + 2 inflow blocks, rounded up to 128
    sample = {
        "pos": jnp.full((cap, 3), 1e8).at[:64].set(pos),
        "vel": jnp.zeros((cap, 3)), "grav": jnp.zeros((cap, 3)),
        "box": jnp.full((128, 3), 1e8).at[:48].set(box),
        "box_normals": jnp.zeros((128, 3)).at[:48].set(nrm),
        "fluid_mask": jnp.arange(cap) < 64,
        "box_mask": jnp.arange(128) < 48}
    params = jax.jit(lambda k, s: jm.init(k, s, training=False))(
        jax.random.PRNGKey(0), sample)
    state = params_from_flax(jax.tree.map(np.asarray, params))
    torch.save({"model": state, "epoch": 0}, path)


def _pred(out_dir):
    import h5py
    with h5py.File(os.path.join(out_dir, "example", "0000", "0000.hdf5"),
                   "r") as f:
        grp = f[list(f.keys())[0]]
        return np.asarray(grp["pred"]), np.asarray(grp["bnd"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Root run_sample.py (JAX) and the port's CLI with JAX's weights,
    started side by side."""
    tmp = tmp_path_factory.mktemp("run_sample")
    scene = str(tmp / "scene.msgpack.zst")
    pos, box, nrm = _make_scene(scene)
    ckpt = str(tmp / "jax_init.pt")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    jax_proc = subprocess.Popen(
        [sys.executable, "run_sample.py", *ARGS, "--data_path", scene,
         "--output_dir", str(tmp / "jax")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        _jax_weights_as_port_ckpt(ckpt, pos, box, nrm)
        port = subprocess.run(
            [sys.executable, "-m", "dmcf_tpu_torch.run_sample", *ARGS,
             "--data_path", scene, "--ckpt_path", ckpt, "--output_dir",
             str(tmp / "port")], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=600)
        jax_log, _ = jax_proc.communicate(timeout=600)
    finally:
        jax_proc.kill()
    return {"port": (port.returncode, port.stdout + port.stderr,
                     str(tmp / "port")),
            "jax": (jax_proc.returncode, jax_log, str(tmp / "jax"))}


def test_run_sample_cli(runs):
    rc, log, out = runs["port"]
    assert rc == 0, log
    for line in ("Restored from", "max true neighbor count over rollout",
                 "max scale occupancy over rollout", "Average runtime"):
        assert line in log, (line, log)
    pred, bnd = _pred(out)
    assert pred.shape == (STEPS, 256, 3) and bnd.shape == (48, 3)
    # inflow events at t = 1 and t = 3 add 64 particles each
    active = np.abs(pred[:, :, 0]) < 500.0
    assert active.sum(1).tolist() == [64, 64, 128, 128, 192]
    assert np.isfinite(pred[active]).all()


def test_run_sample_matches_root_run_sample(runs):
    rc, log, out = runs["jax"]
    assert rc == 0, log
    prc, plog, pout = runs["port"]
    assert prc == 0, plog
    want, want_bnd = _pred(out)
    got, got_bnd = _pred(pout)
    np.testing.assert_array_equal(got_bnd, want_bnd)
    active = np.abs(want[:, :, 0]) < 500.0
    np.testing.assert_array_equal(np.abs(got[:, :, 0]) < 500.0, active)
    np.testing.assert_array_equal(got[~active], want[~active])
    np.testing.assert_allclose(got[active], want[active], rtol=0, atol=1e-5)
    # both report the same largest true finest-radius count
    line = [ln for ln in log.splitlines()
            if ln.startswith("max true neighbor count")]
    assert line and line[0] in plog


@pytest.mark.parametrize("extra,what", [
    (["--spatial", "halo", "--inflow", "4"], "inflow"),
])
def test_unported_options_raise(extra, what):
    """What ``--spatial halo`` refuses, as the root script does (the halo
    path itself runs in ``tests/test_torch_halo_run_sample.py``)."""
    with pytest.raises(SystemExit, match=what):
        run_sample.main(["-c", os.path.join(ROOT, CONFIG), "--device",
                         "cpu", *extra])


def test_bench_canyon_protocol_and_its_gate():
    """``bench.bench_canyon`` on a small generated scene (its crop cut from
    8192 to 512 to fit the scene) reports the root protocol's fields, and
    ``canyon_exact`` is root ``bench.py:308-315``'s gate (``bench.run``
    folds it into ``exact``)."""
    from dmcf_tpu_torch import bench
    from dmcf_tpu_torch.scene import canyon_frame

    frame = canyon_frame(block=(4, 3, 4), floor=24, wall_rows=2, height=0.0)
    model = bench.canyon_model(crop=512, device="cpu")
    canyon = bench.bench_canyon(frame, steps=1, device="cpu", model=model)
    assert canyon["boundary_crop"] == 512
    assert canyon["boundary_contact_count"] > 0 and canyon["finite"]
    assert set(canyon["pair_excess"]) >= {"dilated0>dilated0@0.1"}
    broken = dict(canyon, boundary_contact_count=513)
    assert bench.canyon_exact(canyon) == (
        canyon["pair_overflow"] <= 0
        and canyon["max_neighbors"] <= canyon["neighbor_k"]
        and canyon["boundary_contact_count"] <= 512)
    assert not bench.canyon_exact(broken)


def test_canyon_frame_carries_the_canyon_contact_load():
    """``scene.canyon_frame()``, the scene the card runs the canyon
    protocol on: 1,280 fluid resting on 185,436 boundary rows, of which
    6,119 lie within the crop's reach (0.8) of the fluid at frame 0, within
    5 % of the canyon's 6,403 (root ``bench.py``); the port's contact
    counts equal JAX's ``contact_weight_dense`` exactly."""
    from dmcf_tpu.ops.cell_search import contact_weight_dense as jax_weight
    from dmcf_tpu_torch.ops.cell_search import contact_weight_dense
    from dmcf_tpu_torch.scene import canyon_frame

    frame = canyon_frame()
    assert (len(frame["pos"]), len(frame["box"])) == (1280, 185436)
    # the block's lowest layer one fluid spacing above the floor (jitter 1 %)
    gap = frame["pos"][:, 1].min() - frame["box"][:, 1].min()
    assert abs(gap - 0.05) < 0.003
    w = contact_weight_dense(torch.as_tensor(frame["pos"]),
                             torch.as_tensor(frame["box"]), 0.8)
    w_jax = np.asarray(jax_weight(jnp.asarray(frame["pos"]),
                                  jnp.asarray(frame["box"]), 0.8))
    np.testing.assert_array_equal(w.numpy(), w_jax)
    assert int((w > 0).sum()) == 6119 >= 0.95 * 6403
