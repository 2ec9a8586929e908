"""The port's entry points in processes that cannot import ``zstandard``,
``h5py`` or ``matplotlib`` (each set to None in ``sys.modules`` before
the port is imported), as on the GPU machine, on the CPU:

* ``run_pipeline --split test`` on ``configs/column/symnet.yml`` at test
  size, the default ``cache_dir``: it writes the scene's hdf5 and the
  dataset cache, and h5py in this process reads the file bitwise equal
  to the same run in this process (the rollout's positions, the split's
  ground truth and boundary); JAX's reader reads the cache bitwise equal
  to the splits generated here; a second run whose generators raise
  reads the cache back and writes the same file;
* ``python -m dmcf_tpu_torch.scene`` writes a scene that JAX's reader
  reads bitwise equal to ``scene.canyon_frame``'s, and
  ``bench.read_canyon`` (``bench --canyon``'s read) reads it too;
* the ``run_sample`` CLI runs 2 steps of ``configs/Liquid3d.yml`` with
  the reference-format fixture checkpoint on
  ``tests/data/liquid_block.msgpack.zst`` and writes its hdf5.

Both children run side by side.  Every comparison is bitwise (no
tolerance): the same code on the same inputs and thread count.
"""

import glob
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from dmcf_tpu.data.dataset import read_msgpack_zst as jax_read
from dmcf_tpu_torch import run_pipeline
from dmcf_tpu_torch.pipelines.simulator import Simulator
from dmcf_tpu_torch.scene import canyon_frame

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
BLOCK = ("zstandard", "h5py", "matplotlib")
SIZES = [f"--dataset.{s}.{k}" for s in ("train", "valid", "test")
         for k in ("data_cnt", "timesteps", "max_iter")]
TEST_ARGS = ["--cfg_file", os.path.join(ROOT, "configs", "column",
                                        "symnet.yml"),
             "--split", "test", "--device", "cpu",
             "--pipeline.strict_overflow", "true"] + [
    a for flag, v in zip(SIZES, ["1", "2", "20", "1", "2", "20",
                                 "1", "6", "20"]) for a in (flag, v)]
CANYON = ["--block", "4", "3", "4", "--floor", "20"]
LIQUID = ["-c", os.path.join(ROOT, "configs", "Liquid3d.yml"),
          "--tf_ckpt", os.path.join(ROOT, "tests", "data", "tf_ckpt_liquid3d",
                                    "ckpt"),
          "--data_path", os.path.join(ROOT, "tests", "data",
                                      "liquid_block.msgpack.zst"),
          "--timesteps", "3", "--vel", "0", "0", "0", "--device", "cpu"]

# the children: the three modules blocked, then the port
PRELUDE = f"""
import sys
for m in {BLOCK!r}:
    sys.modules[m] = None
for m in {BLOCK!r}:
    try:
        __import__(m)
    except ImportError:
        continue
    raise SystemExit(m + " importable")
sys.path.insert(0, {ROOT!r})
"""
PIPELINE = PRELUDE + f"""
from dmcf_tpu_torch import run_pipeline, scene
from dmcf_tpu_torch.bench import read_canyon
from dmcf_tpu_torch.data import dataset
run_pipeline.main({TEST_ARGS!r})

def refuse(**kw):
    raise RuntimeError("generated, not read from the cache")

for k in dataset.GENERATORS:
    dataset.GENERATORS[k] = refuse
run_pipeline.main({TEST_ARGS!r} + ["--output_dir", "again"])
assert scene.main(["canyon.msgpack.zst"] + {CANYON!r}) == 0
frame = read_canyon("canyon.msgpack.zst")
print("canyon", len(frame["pos"]), len(frame["box"]))
"""
SAMPLE = PRELUDE + f"""
from dmcf_tpu_torch import run_sample
sys.exit(run_sample.main({LIQUID!r} + ["--output_dir", "out"]))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both children side by side (their working directories under a
    temporary one), and the test split's run in this process with no
    cache, its rollout and splits kept."""
    tmp = tmp_path_factory.mktemp("installed")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = {}
    for name, code, threads in (("pipeline", PIPELINE, "2"),
                                ("sample", SAMPLE, "4")):
        os.makedirs(tmp / name)
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", code], cwd=tmp / name,
            env=dict(env, OMP_NUM_THREADS=threads), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    try:
        rec = {}
        run_rollout = Simulator.run_rollout

        def recording(self, data, timesteps=2, bucket=64):
            results = run_rollout(self, data, timesteps, bucket)
            rec.update(data=data, results=results, dataset=self.dataset)
            return results

        Simulator.run_rollout = recording
        try:
            here = tmp / "here"
            run_pipeline.main(TEST_ARGS + [
                "--dataset.cache_dir", "none",
                "--output_dir", str(here / "output"),
                "--main_log_dir", str(here / "logs"),
                "--pipeline.train_sum_dir", str(here / "train_log")])
        finally:
            Simulator.run_rollout = run_rollout
        logs = {k: p.communicate(timeout=600)[0] for k, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
    return {"tmp": tmp, "rc": {k: p.returncode for k, p in procs.items()},
            "logs": logs, **rec}


def read_h5(path):
    with h5py.File(path, "r") as f:
        (group,) = list(f)
        return group, {k: (d[()], dict(d.attrs)) for k, d in f[group].items()}


def test_test_split_hdf5_and_cache(runs):
    assert runs["rc"]["pipeline"] == 0, runs["logs"]["pipeline"]
    work = runs["tmp"] / "pipeline"
    (path,) = glob.glob(str(work / "output" / "*" / "visual" / "0000"
                            / "*.hdf5"))
    group, series = read_h5(path)
    assert group == "SymNet"
    (ps, _), data = runs["results"][0], runs["data"][0]
    for key, want in (("pred", ps), ("gt", data["pos"]),
                      ("bnd", data["box"])):
        got, attrs = series[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        assert got.tobytes() == want.tobytes(), key
        assert attrs["type"] == "PARTICLE", key
        assert attrs["dim"].tolist() == list(want.shape), key
    # the second run read the cache (its generators raise) and wrote the
    # same file
    (again,) = glob.glob(str(work / "again" / "*" / "visual" / "0000"
                             / "*.hdf5"))
    assert open(again, "rb").read() == open(path, "rb").read()
    cached = [jax_read(p) for p in sorted(glob.glob(
        str(work / "cache" / "*" / "data.msgpack.zst")))]
    assert len(cached) == 3
    # a file a split (at this size the train and valid splits may hold the
    # same scene)
    splits = [getattr(runs["dataset"], s).data
              for s in ("train", "valid", "test")]
    assert all(any(same_scenes(c, s) for c in cached) for s in splits)
    assert all(any(same_scenes(c, s) for s in splits) for c in cached)


def same_scenes(got, want):
    if len(got) != len(want):
        return False
    for gs, ws in zip(got, want):
        if len(gs) != len(ws):
            return False
        for g, w in zip(gs, ws):
            if sorted(g) != sorted(w):
                return False
            for k, v in w.items():
                if isinstance(v, np.ndarray):
                    if not (g[k].dtype == v.dtype and g[k].shape == v.shape
                            and g[k].tobytes() == v.tobytes()):
                        return False
                elif g[k] != v:
                    return False
    return True


def test_scene_writer_and_canyon_read(runs):
    assert runs["rc"]["pipeline"] == 0, runs["logs"]["pipeline"]
    want = canyon_frame(block=(4, 3, 4), floor=20)
    assert f"canyon {len(want['pos'])} {len(want['box'])}" in \
        runs["logs"]["pipeline"]
    (got,) = jax_read(str(runs["tmp"] / "pipeline" / "canyon.msgpack.zst"))
    n = len(want["pos"])
    want.update(frame_id=0, scene_id="generated",
                grav=np.tile(np.array([0, -9.81, 0], np.float32), (n, 1)))
    assert same_scenes([[got]], [[want]])


def test_run_sample_cli(runs):
    assert runs["rc"]["sample"] == 0, runs["logs"]["sample"]
    group, series = read_h5(runs["tmp"] / "sample" / "out" / "example"
                            / "0000" / "0000.hdf5")
    assert group == "SymNet" and sorted(series) == ["bnd", "pred"]
    (scene,) = jax_read(os.path.join(ROOT, "tests", "data",
                                     "liquid_block.msgpack.zst"))
    pred, attrs = series["pred"]
    n = len(scene["pos"])
    assert pred.dtype == np.float32 and pred.shape[:1] == (3,)
    assert attrs["type"] == "PARTICLE"
    assert attrs["dim"].tolist() == list(pred.shape)
    assert pred[0, :n].tobytes() == scene["pos"].tobytes()
    assert np.isfinite(pred).all() and not np.array_equal(pred[2], pred[0])
    assert series["bnd"][0].tobytes() == scene["box"].tobytes()
