"""The port's HDF5 result writer (``dmcf_tpu_torch/data/hdf5.py``, no
``h5py``) against the JAX package's (``dmcf_tpu.data.writers``, h5py):
the same arrays written by both, opened with h5py, give the same groups,
dataset names, dtypes, shapes and attributes (``type`` a ``str``, ``dim``
an int64 array) and bitwise equal values; ``read_results`` reads the
port's file as h5py does, bitwise; the lookup3 checksum gives its
published test vectors and the checksums the HDF5 library writes.  Every
comparison here is bitwise (no tolerance): both writers store the arrays'
bytes as they are.
"""

import struct

import h5py
import numpy as np
import pytest
import torch

from dmcf_tpu.data.writers import write_results as jax_write_results
from dmcf_tpu_torch.data import read_results, write_results
from dmcf_tpu_torch.data.hdf5 import lookup3

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)


def rollout_series(seed=0, t=7, n=11, m=5):
    """A test split's series as the pipeline writes them: float32 pred
    [T, N, 3], float64 gt, a float32 [M, 3] bnd with the default type."""
    rng = np.random.RandomState(seed)
    return [(rng.randn(t, n, 3).astype(np.float32),
             {"name": "pred", "type": "PARTICLE"}),
            (rng.randn(t, n, 3), {"name": "gt", "type": "PARTICLE"}),
            (rng.randn(m, 3).astype(np.float32), {"name": "bnd"})]


def h5_contents(path):
    """{group: {name: (dtype, shape, bytes, {attr: value})}} by h5py."""
    out = {}
    with h5py.File(path, "r") as f:
        for g in f:
            out[g] = {}
            for name, d in f[g].items():
                out[g][name] = (d.dtype, d.shape, d[()].tobytes(),
                                dict(d.attrs))
    return out


def same_attrs(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert type(g) is type(w), (k, type(g), type(w))
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.tolist() == w.tolist(), k
        else:
            assert g == w, k


@pytest.mark.parametrize("series", [
    rollout_series(),
    rollout_series(1, t=1, n=1, m=0),      # one frame, an empty boundary
    rollout_series(5, t=3, n=0, m=4),      # empty series last in the file
], ids=["rollout", "one_frame_no_boundary", "no_fluid"])
def test_file_reads_in_h5py_as_jax_file(series, tmp_path):
    jax_write_results(str(tmp_path / "jax.hdf5"), "SymNet", series)
    write_results(str(tmp_path / "port" / "0000.hdf5"), "SymNet", series)
    want = h5_contents(tmp_path / "jax.hdf5")
    got = h5_contents(tmp_path / "port" / "0000.hdf5")
    assert list(got) == list(want) == ["SymNet"]
    assert list(got["SymNet"]) == list(want["SymNet"])
    for name, (dtype, shape, raw, attrs) in want["SymNet"].items():
        g = got["SymNet"][name]
        assert g[:3] == (dtype, shape, raw), name
        same_attrs(g[3], attrs)
        assert isinstance(g[3]["type"], str)
        assert g[3]["dim"].dtype == np.int64


def test_read_results_reads_its_file_as_h5py(tmp_path):
    path = str(tmp_path / "out.hdf5")
    series = rollout_series(2)
    write_results(path, "HRNet", series)
    got = read_results(path)
    want = h5_contents(path)
    assert list(got) == ["HRNet"]
    assert list(got["HRNet"]) == list(want["HRNet"]) == ["bnd", "gt", "pred"]
    for name, (dtype, shape, raw, attrs) in want["HRNet"].items():
        s = got["HRNet"][name]
        assert (s.data.dtype, s.data.shape, s.data.tobytes()) == (
            dtype, shape, raw)
        same_attrs(s.attrs, attrs)
    for arr, props in series:
        np.testing.assert_array_equal(got["HRNet"][props["name"]].data, arr)


@pytest.mark.parametrize("dtype", ["<f2", "<f4", ">f4", "<f8", ">f8", "u1",
                                   "<i4", "<i8", ">u8"])
def test_every_dtype_reads_back(dtype, tmp_path):
    """h5py and ``read_results`` give the array of each numeric dtype the
    writer takes, byte order included, bitwise."""
    rng = np.random.RandomState(3)
    arr = (rng.randn(4, 5, 3) * 100).astype(dtype)
    path = str(tmp_path / "d.hdf5")
    write_results(path, "M", [(arr, {"name": "pred", "type": "PARTICLE"})])
    with h5py.File(path, "r") as f:
        got = f["M"]["pred"][()]
    assert got.dtype == arr.dtype and got.tobytes() == arr.tobytes()
    back = read_results(path)["M"]["pred"].data
    assert back.dtype == arr.dtype and back.tobytes() == arr.tobytes()


def test_many_series_and_long_names(tmp_path):
    """Headers past 255 and 65,535 bytes (a two- and a four-byte size
    field) and names of 1-255 bytes, non-ASCII ones too, in h5py's
    order."""
    rng = np.random.RandomState(4)
    series = [(rng.randn(2, 3).astype(np.float32),
               {"name": f"s{i:04d}" + "x" * (i % 250), "type": f"T{i}é"})
              for i in range(700)]
    path = str(tmp_path / "many.hdf5")
    write_results(path, "Grüppe", series)
    with h5py.File(path, "r") as f:
        g = f["Grüppe"]
        assert list(g) == sorted(p["name"] for _, p in series)
        for arr, props in series:
            d = g[props["name"]]
            assert d[()].tobytes() == arr.tobytes()
            assert d.attrs["type"] == props["type"]
    got = read_results(path)["Grüppe"]
    assert [s.attrs["type"] for s in got.values()] == [
        p["type"] for _, p in sorted(series, key=lambda s: s[1]["name"])]


@pytest.mark.parametrize("data, error", [
    ([(np.zeros(3), {"name": "a"}), (np.ones(3), {"name": "a"})],
     ValueError),
    ([(np.zeros(3), {"name": "a/b"})], ValueError),
    ([(np.float32(1.0), {"name": "a"})], ValueError),
    ([(np.array(["x"]), {"name": "a"})], TypeError),
    ([(np.zeros(3), {"name": "a", "type": b"PARTICLE"})], TypeError),
], ids=["duplicate", "slash", "scalar", "str_array", "bytes_type"])
def test_writer_refuses_what_it_cannot_write(data, error, tmp_path):
    with pytest.raises(error):
        write_results(str(tmp_path / "x.hdf5"), "M", data)


@pytest.mark.parametrize("data, initval, want", [
    (b"", 0, 0xDEADBEEF),
    (b"", 0xDEADBEEF, 0xBD5B7DDE),
    (b"Four score and seven years ago", 0, 0x17770551),
    (b"Four score and seven years ago", 1, 0xCD628161),
])
def test_lookup3_published_vectors(data, initval, want):
    """Bob Jenkins' lookup3.c driver5 values of ``hashlittle``."""
    assert lookup3(data, initval) == want


def test_lookup3_gives_the_hdf5_librarys_checksums(tmp_path):
    """Every checksum of a file the HDF5 library writes at its newest
    format (h5py, ``libver="latest"``: a version-3 superblock, version-2
    object headers of every length here) equals ``lookup3`` of the bytes
    it covers."""
    path = str(tmp_path / "lib.hdf5")
    with h5py.File(path, "w", libver="latest") as f:
        g = f.create_group("g")
        for i in range(12):
            d = g.create_dataset("d" * (i + 1), data=np.arange(i + 1.0))
            d.attrs["type"] = "x" * i
    buf = open(path, "rb").read()
    assert buf[8] == 3
    assert lookup3(buf[:44]) == struct.unpack_from("<I", buf, 44)[0]
    at, checked = buf.find(b"OHDR"), 0
    while at >= 0:
        flags = buf[at + 5]
        p = at + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        width = 1 << (flags & 0x03)
        end = p + width + int.from_bytes(buf[p:p + width], "little")
        assert lookup3(buf[at:end]) == struct.unpack_from("<I", buf, end)[0]
        checked += 1
        at = buf.find(b"OHDR", end)
    assert checked == 14   # the root, the group, 12 datasets
