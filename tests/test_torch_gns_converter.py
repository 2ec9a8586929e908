"""The port's GNS converter (``dmcf_tpu_torch/data/gns_converter.py``)
against the JAX package's, on the CPU, on the synthetic tfrecords of
``tests/test_gns_converter.py``: the codec (the port's encoder against
the JAX package's parser and the other way round), the boundary helpers,
``convert`` (the same scene files, array for array, their msgpack
payloads byte for byte: the port compresses with the system's libzstd,
the JAX package with python-zstandard's own, so the compressed bytes may
differ) and the CLI (``python -m dmcf_tpu_torch.data.gns_converter``).
The port's ``write_tfrecord`` frames each record with masked CRC32C values, which
``utils.tb_writer.read_records`` verifies.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dmcf_tpu.data import gns_converter as jgns
from dmcf_tpu_torch.data import gns_converter as tgns
from dmcf_tpu_torch.data import read_msgpack_zst, zstd
from dmcf_tpu_torch.utils.tb_writer import read_records
from test_gns_converter import make_sequence_example, write_tfrecord

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")


def trajectory(seed=1, t=101, n=8, dim=2, n_bnd=2):
    rng = np.random.RandomState(seed)
    pos = rng.rand(t, n, dim).astype(np.float32)
    ptype = np.array([5] * (n - n_bnd) + [3] * n_bnd, np.int64)
    return pos, ptype


@pytest.mark.parametrize("encode", ["jax", "port", "test_oracle"])
def test_codec_matches_jax(encode):
    pos, ptype = trajectory(seed=3, t=5, n=7)
    ctx = np.arange(10, dtype=np.float32).reshape(5, 2)
    rec = {"jax": lambda: jgns.encode_sequence_example(pos, ptype, ctx),
           "port": lambda: tgns.encode_sequence_example(pos, ptype, ctx),
           "test_oracle": lambda: make_sequence_example(pos, ptype)}[
               encode]()
    meta = {"dim": 2, "sequence_length": 4}
    assert tgns.parse_sequence_example(rec) == \
        jgns.parse_sequence_example(rec)
    got = tgns.parse_gns_trajectory(rec, meta)
    want = jgns.parse_gns_trajectory(rec, meta)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    if encode != "test_oracle":
        assert tgns.encode_sequence_example(pos, ptype, ctx) == \
            jgns.encode_sequence_example(pos, ptype, ctx)


def test_boundary_helpers_match_jax():
    xs = np.linspace(0.1, 0.9, 20)
    bnds = np.stack([xs, 0.2 + 0.1 * np.sin(6 * xs), np.zeros_like(xs)],
                    -1)
    np.testing.assert_array_equal(tgns.estimate_normals(bnds, res=16),
                                  jgns.estimate_normals(bnds, res=16))
    for got, want in zip(tgns.sample_boundary_walls(2, [16, 16, 1]),
                         jgns.sample_boundary_walls(2, [16, 16, 1])):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tgns._box_points(0, 2, 1, 3, 0, 1),
                                  jgns._box_points(0, 2, 1, 3, 0, 1))


def gns_dir(path, records):
    os.makedirs(path, exist_ok=True)
    write_tfrecord(os.path.join(path, "train.tfrecord"), records)
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump({"dim": 2, "sequence_length": 100}, f)
    return str(path)


def same_scene_files(got_dir, want_dir):
    names = sorted(os.listdir(want_dir))
    assert names and sorted(os.listdir(got_dir)) == names
    for name in names:
        got = read_msgpack_zst(os.path.join(got_dir, name))
        want = read_msgpack_zst(os.path.join(want_dir, name))
        assert len(got) == len(want)
        for fg, fw in zip(got, want):
            assert list(fg) == list(fw)
            for k in fw:
                if isinstance(fw[k], np.ndarray):
                    assert fg[k].dtype == fw[k].dtype
                np.testing.assert_array_equal(fg[k], fw[k])
        with open(os.path.join(got_dir, name), "rb") as a, \
                open(os.path.join(want_dir, name), "rb") as b:
            assert zstd.decompress(a.read()) == zstd.decompress(b.read())
    return names


def test_convert_matches_jax(tmp_path):
    records = [make_sequence_example(*trajectory(seed=s)) for s in (1, 2)]
    src = gns_dir(tmp_path / "gns", records)
    n_got = tgns.convert(src, str(tmp_path / "port"), split="train",
                         block_size=50, res=16)
    n_want = jgns.convert(src, str(tmp_path / "jax"), split="train",
                          block_size=50, res=16)
    assert n_got == n_want == 4
    names = same_scene_files(str(tmp_path / "port" / "train"),
                             str(tmp_path / "jax" / "train"))
    assert names[0] == "sim_0000_00.msgpack.zst"


def test_cli_and_crc_framed_records(tmp_path):
    pos, ptype = trajectory(seed=4)
    rec = tgns.encode_sequence_example(pos, ptype)
    path = tmp_path / "gns" / "train.tfrecord"
    os.makedirs(path.parent)
    tgns.write_tfrecord(str(path), [rec, rec[:-3]])
    assert read_records(str(path)) == [rec, rec[:-3]]
    assert list(tgns.read_tfrecord(str(path))) == [rec, rec[:-3]]
    src = gns_dir(tmp_path / "gns", [rec])
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "dmcf_tpu_torch.data.gns_converter",
         "--data_path", src, "--out_path", str(tmp_path / "port"),
         "--split", "train", "--res", "16"],
        capture_output=True, text=True, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "wrote 2 scene blocks" in proc.stdout
    jgns.convert(src, str(tmp_path / "jax"), split="train", res=16)
    same_scene_files(str(tmp_path / "port" / "train"),
                     str(tmp_path / "jax" / "train"))
