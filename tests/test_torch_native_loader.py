"""The port's native scene loader (``native/scene_loader.cpp`` through
``data/native_loader.py``), built here with g++ against the system's
``libzstd.so.1``, against the Python reader (``read_msgpack_zst``: the
``msgpack`` and ``zstandard`` packages), entry for entry: the committed
fixture scene (``tests/data/liquid_block.msgpack.zst``, whose arrays
must keep the sha256 values of ``tests/data/fixtures.json``), the
generators' scenes and a scene of every value kind the writers produce.
``Dataset`` under ``DMCF_NATIVE_LOADER=1`` returns what it returns
without; asked for and unbuildable, it raises instead of falling back.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from dmcf_tpu.data.dataset import read_msgpack_zst as jax_read
from dmcf_tpu_torch.data import (Dataset, gen_free_fall_data,
                                 gen_momentum_data, native_loader,
                                 read_msgpack_zst, write_msgpack_zst)
from dmcf_tpu_torch.data.generators import gen_column_data

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SCENE = os.path.join(ROOT, "tests", "data", "liquid_block.msgpack.zst")
FIXTURES = os.path.join(ROOT, "tests", "data", "fixtures.json")


def same_frames(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k, v in w.items():
            assert type(g[k]) is type(v), (k, type(g[k]), type(v))
            if isinstance(v, (np.ndarray, np.generic)):
                assert g[k].dtype == v.dtype and g[k].shape == v.shape, k
                assert g[k].tobytes() == v.tobytes(), k
            else:
                assert g[k] == v, k


def every_kind():
    """Frames of every value kind: numpy arrays of several dtypes and
    ranks (empty too), numpy scalars, ints of each msgpack width, floats,
    bools, None, str, bytes; 20 frames (an array16 header) of 17 keys (a
    map16 header)."""
    rng = np.random.RandomState(0)
    frames = []
    for t in range(20):
        frames.append({
            "pos": rng.randn(5 + t, 3).astype(np.float32),
            "vel": rng.randn(5 + t, 3),
            "box": np.zeros((0, 3), np.float32),
            "ids": rng.randint(-2 ** 40, 2 ** 40, (2, 3, 4)),
            "flags": rng.rand(7) > 0.5,
            "small": np.arange(4, dtype=np.uint8),
            "m": np.float32(0.125 * t), "count": np.int64(-t),
            "frame_id": t, "neg": -1 - t * 1000, "big": 2 ** 33 + t,
            "u16": 300 + t, "dt": 0.0025 * t, "on": t % 2 == 0,
            "none": None, "scene_id": f"scene_{t:03d}",
            "raw": bytes(range(t)),
        })
    return frames


@pytest.fixture(scope="module")
def built():
    native_loader.build()
    return native_loader.target()


def test_fixture_scene(built):
    got = native_loader.load_scene(SCENE)
    same_frames(got, read_msgpack_zst(SCENE))
    same_frames(got, jax_read(SCENE))
    with open(FIXTURES) as f:
        want = json.load(f)["liquid_block"]
    for k, digest in want["sha256"].items():
        assert hashlib.sha256(np.ascontiguousarray(
            got[0][k]).tobytes()).hexdigest() == digest
    assert got[0]["pos"].shape == (want["n_fluid"], 3)
    assert got[0]["box"].shape == (want["n_boundary"], 3)


@pytest.mark.parametrize("which", ["momentum", "free_fall", "column",
                                   "every_kind"])
def test_generated_scenes(which, built, tmp_path):
    scene = {
        "momentum": lambda: gen_momentum_data(data_cnt=1, timesteps=4)[0],
        "free_fall": lambda: gen_free_fall_data(data_cnt=1, timesteps=4)[0],
        "column": lambda: gen_column_data(data_cnt=1, timesteps=3,
                                          max_iter=20, device="cpu")[0],
        "every_kind": every_kind}[which]()
    path = str(tmp_path / "scene.msgpack.zst")
    write_msgpack_zst(path, scene)
    same_frames(native_loader.load_scene(path), read_msgpack_zst(path))


def test_dataset_under_the_variable(built, tmp_path, monkeypatch):
    for i, frames in enumerate((every_kind()[:3],
                                gen_momentum_data(data_cnt=1,
                                                  timesteps=3)[0])):
        write_msgpack_zst(str(tmp_path / f"s{i}.msgpack.zst"), frames)
    ds = Dataset(dataset_path=str(tmp_path))
    monkeypatch.delenv("DMCF_NATIVE_LOADER", raising=False)
    plain = [ds[i] for i in range(len(ds))]
    monkeypatch.setenv("DMCF_NATIVE_LOADER", "1")
    native = [ds[i] for i in range(len(ds))]
    for a, b in zip(native, plain):
        same_frames(a, b)


def test_unreadable_values_raise(built, tmp_path):
    path = str(tmp_path / "list.msgpack.zst")
    write_msgpack_zst(path, [{"pos": np.zeros((2, 3)), "ids": [1, 2]}])
    with pytest.raises(ValueError, match="list or a plain map"):
        native_loader.load_scene(path)
    bad = tmp_path / "bad.msgpack.zst"
    bad.write_bytes(b"not zstd at all")
    with pytest.raises(RuntimeError, match="zstd cannot decompress"):
        native_loader.load_scene(str(bad))


@pytest.mark.parametrize("cxx,message", [
    ("/nonexistent/g++", "cannot run the compiler"),
    ("false", "failed for scene_loader.cpp"),
])
def test_asked_for_and_unbuildable_raises(cxx, message, tmp_path,
                                          monkeypatch):
    write_msgpack_zst(str(tmp_path / "s.msgpack.zst"),
                      gen_momentum_data(data_cnt=1, timesteps=2)[0])
    monkeypatch.setattr(native_loader, "CXX", cxx)
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setenv("DMCF_NATIVE_LOADER", "1")
    assert not native_loader.target().exists()
    with pytest.raises(RuntimeError, match=message):
        Dataset(dataset_path=str(tmp_path))[0]
