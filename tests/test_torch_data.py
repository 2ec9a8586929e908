"""The port's host-side data path (``dmcf_tpu_torch.utils.config``,
``dmcf_tpu_torch.data``) against the JAX package's on the same inputs:
config merging, the analytic generators, generator-mode datasets and their
cache, evaluation sequences and padding.  All of it is numpy, so every
comparison is exact (equal dicts, bitwise-equal arrays and dtypes).
"""

import argparse
import os

import numpy as np
import pytest
import torch

from dmcf_tpu.data import dataflow as jflow
from dmcf_tpu.data import dataset as jdataset
from dmcf_tpu.data import generators as jgen
from dmcf_tpu.utils.config import Config as JConfig
from dmcf_tpu_torch.data import dataflow, dataset, generators
from dmcf_tpu_torch.utils.config import Config

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

MOMENTUM = os.path.join(os.path.dirname(__file__), "..", "configs", "other",
                        "momentum.yml")


def assert_same_tree(got, want, path="root"):
    """Equal nested dicts/lists, arrays bitwise equal with equal dtypes."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize("args,extra", [
    ({}, {}),
    ({"device": "cpu", "split": "valid", "main_log_dir": "L",
      "output_dir": "O", "ckpt_path": "c.pt"},
     {"--model.neighbor_k": "64", "--pipeline.data_generator.valid.time_end":
      "10", "--dataset.valid.seed": "7", "--model.kernel_size": "[1, 4, 4]",
      "--batch_size": "4", "--window_bnds": "[]", "--model.window": "none",
      "--new_key": "1.5e-3"}),
], ids=["plain", "overrides"])
def test_config_merge_matches_jax(args, extra):
    ns = argparse.Namespace(**args)
    got = Config.merge_cfg_file(Config.load_from_file(MOMENTUM), ns, extra)
    want = JConfig.merge_cfg_file(JConfig.load_from_file(MOMENTUM), ns,
                                  extra)
    for g, w in zip(got, want):
        assert g.to_dict() == w.to_dict()
    assert got[2].neighbor_k == (64 if extra else 48)


@pytest.mark.parametrize("name,kwargs", [
    ("gen_momentum_data", dict(data_cnt=2, timesteps=6, res=100, radius=12,
                               dt=0.0025, gravity=0.0, speed=30.0)),
    ("gen_momentum_data", dict(data_cnt=1, timesteps=4, res=60, radius=9,
                               dim=3, gravity=-9.81, speed=10.0)),
    ("gen_free_fall_data", dict(data_cnt=2, timesteps=5, radius=15)),
    ("gen_free_fall_data", dict(data_cnt=1, timesteps=5, radius=8, mode=1,
                                dim=3)),
])
def test_generators_match_jax(name, kwargs):
    got = getattr(generators, name)(**kwargs)
    want = getattr(jgen, name)(**kwargs)
    assert_same_tree(got, want)


def test_column_generator_raises_naming_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        generators.gen_column_data(data_cnt=1)


def test_dataset_group_and_cache_match_jax(tmp_path):
    """Generator mode under the split seeds gives JAX's arrays, under the
    same cache key; each package reads the other's cache file."""
    cfg = dict(name="Momentum", type="momentum", res=100, gravity=0.0,
               dt=0.0025,
               train={"seed": 42, "data_cnt": 1, "timesteps": 3},
               valid={"seed": 43, "data_cnt": 2, "timesteps": 4},
               test={"seed": 44, "data_cnt": 1, "timesteps": 3})
    got = dataset.DatasetGroup(cache_dir=str(tmp_path / "port"),
                               **{k: dict(v) if isinstance(v, dict) else v
                                  for k, v in cfg.items()})
    want = jdataset.DatasetGroup(cache_dir=str(tmp_path / "jax"),
                                 **{k: dict(v) if isinstance(v, dict) else v
                                    for k, v in cfg.items()})
    for split in ("train", "valid", "test"):
        assert_same_tree(getattr(got, split).data,
                         getattr(want, split).data)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))
    key = dataset.dict_hash({**cfg["valid"], "res": 100, "gravity": 0.0,
                             "dt": 0.0025})
    assert key == jdataset.dict_hash({**cfg["valid"], "res": 100,
                                      "gravity": 0.0, "dt": 0.0025})
    jax_file = tmp_path / "jax" / key / "data.msgpack.zst"
    port_file = tmp_path / "port" / key / "data.msgpack.zst"
    assert_same_tree(dataset.read_msgpack_zst(jax_file),
                     jdataset.read_msgpack_zst(port_file))


def test_dataset_group_without_cache(tmp_path, monkeypatch):
    """``cache_dir=None`` (for a machine without zstandard) generates JAX's
    arrays under the same seeds and writes no file."""
    monkeypatch.chdir(tmp_path)
    cfg = dict(type="momentum", res=100, train={"seed": 1, "data_cnt": 1},
               valid={"seed": 43, "data_cnt": 2, "timesteps": 3},
               test={"seed": 2, "timesteps": 2})
    got = dataset.DatasetGroup(split="valid", cache_dir=None, **cfg)
    want = jdataset.DatasetGroup(split="valid", cache_dir=str(tmp_path / "j"),
                                 **cfg)
    for split in ("train", "valid", "test"):
        assert_same_tree(getattr(got, split).data,
                         getattr(want, split).data)
    assert os.listdir(tmp_path) == ["j"]


def test_path_mode_reads_the_split_directories(tmp_path):
    scenes = jgen.gen_momentum_data(data_cnt=2, timesteps=3)
    for split in ("train", "valid", "test"):
        (tmp_path / split).mkdir()
        for i, scene in enumerate(scenes):
            jdataset.write_msgpack_zst(
                tmp_path / split / f"{i}.msgpack.zst", scene)
    got = dataset.DatasetGroup(dataset_path=str(tmp_path), split="train")
    want = jdataset.DatasetGroup(dataset_path=str(tmp_path), split="train")
    for split in ("train", "valid", "test"):
        g, w = getattr(got, split), getattr(want, split)
        assert len(g) == len(w) == 2
        for i in range(2):
            assert_same_tree(g[i], w[i])


@pytest.mark.parametrize("kw", [
    dict(),
    dict(stride=1, time_end=5, random_start=1, scale=[1.0, 1.0, 0.0]),
    dict(stride=2, time_start=1, time_end=4, random_start=3, seed=5,
         translate=[0.1, -0.2, 0.0], scale=[2.0, 0.5, 1.0], cnt=2),
    dict(random_start=4, seed=11, time_end=6),
], ids=["default", "momentum-valid", "stride-translate-scale", "random"])
def test_get_rollout_and_padding_match_jax(kw):
    rng = np.random.RandomState(0)
    scenes = jgen.gen_free_fall_data(data_cnt=3, timesteps=12, radius=6)
    for scene in scenes:  # a per-particle gravity field on one scene
        for f in scene:
            f["grav"] = np.asarray(f["grav"], np.float32)
    scenes[1] = [dict(f, grav=np.tile(f["grav"], (len(f["pos"]), 1)),
                      box=rng.randn(5, 3).astype(np.float32))
                 for f in scenes[1]]
    ds = dataset.Dataset(scenes)
    got = dataflow.get_rollout(ds, **kw)
    want = jflow.get_rollout(jdataset.Dataset(scenes), **kw)
    assert_same_tree(got, want)
    for g, w in zip(got, want):
        for bucket in (64, 128):
            assert_same_tree(dataflow.pad_rollout_state(g, bucket),
                             jflow.pad_rollout_state(w, bucket))


def test_grav_eqvar_raises():
    ds = dataset.Dataset(jgen.gen_free_fall_data(timesteps=2, radius=4))
    with pytest.raises(NotImplementedError, match="grav_eqvar"):
        dataflow.get_rollout(ds, grav_eqvar=[0, -1, 0])
