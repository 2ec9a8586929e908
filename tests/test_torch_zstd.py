"""The port's zstd route (``dmcf_tpu_torch/data/zstd.py``: ctypes over the
system's ``libzstd.so.1``, no Python ``zstandard``) against the JAX
package's (``zstandard``): each package reads the other's
``*.msgpack.zst`` files; the committed scene
``tests/data/liquid_block.msgpack.zst`` gives the same frames through the
port's route, the native loader and JAX; a frame whose header gives no
content size fails in both (the port's ``ValueError``, python-zstandard's
``ZstdError``); a missing library raises an error naming it.  Every
comparison is bitwise (no tolerance): the frames are the files' bytes.
"""

import os

import numpy as np
import pytest
import torch
import zstandard

from dmcf_tpu.data.dataset import read_msgpack_zst as jax_read
from dmcf_tpu.data.dataset import write_msgpack_zst as jax_write
from dmcf_tpu_torch.data import (Dataset, native_loader, read_msgpack_zst,
                                 write_msgpack_zst, zstd)

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SCENE = os.path.join(ROOT, "tests", "data", "liquid_block.msgpack.zst")


def scene(seed=0, frames=4):
    """A scene of seeded frames: arrays of several dtypes and ranks (an
    empty one too), numpy scalars, ints, floats, str, bool, None."""
    rng = np.random.RandomState(seed)
    return [{"frame_id": t, "scene_id": f"sim_{seed:04d}",
             "pos": rng.randn(9, 3).astype(np.float32),
             "vel": rng.randn(9, 3),
             "grav": np.float32(-9.81),
             "box": np.zeros((0, 3), np.float32),
             "ids": rng.randint(-2 ** 40, 2 ** 40, (2, 3)),
             "flag": bool(t % 2), "none": None, "dt": 0.0025}
            for t in range(frames)]


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


@pytest.mark.parametrize("level", [1, 3, 22])
def test_packages_read_each_others_files(level, tmp_path):
    frames = scene(level)
    write_msgpack_zst(str(tmp_path / "port.msgpack.zst"), frames, level)
    jax_write(str(tmp_path / "jax.msgpack.zst"), frames, level)
    same_frames(jax_read(str(tmp_path / "port.msgpack.zst")), frames)
    same_frames(read_msgpack_zst(str(tmp_path / "jax.msgpack.zst")), frames)
    same_frames(read_msgpack_zst(str(tmp_path / "port.msgpack.zst")), frames)


@pytest.mark.parametrize("n", [0, 1, 1000, 1 << 20])
def test_frames_cross_python_zstandard(n):
    """Bytes compressed by one library decompress in the other."""
    raw = np.random.RandomState(n).randint(0, 7, n).astype(np.uint8).tobytes()
    assert zstandard.ZstdDecompressor().decompress(zstd.compress(raw)) == raw
    assert zstd.decompress(zstandard.ZstdCompressor(level=9).compress(
        raw)) == raw
    assert zstd.decompress(zstd.compress(raw, level=22)) == raw


def test_committed_scene_through_every_route(monkeypatch):
    """``tests/data/liquid_block.msgpack.zst``: the port's route (also as
    ``Dataset``'s default), the native loader and JAX give equal
    frames."""
    want = jax_read(SCENE)
    same_frames(read_msgpack_zst(SCENE), want)
    monkeypatch.delenv("DMCF_NATIVE_LOADER", raising=False)
    ds = Dataset(dataset_path=os.path.dirname(SCENE))
    assert len(ds.files) == 1 and os.path.samefile(ds.files[0], SCENE)
    same_frames(ds[0], want)
    native_loader.build()
    same_frames(native_loader.load_scene(SCENE), want)


def test_frame_without_content_size_fails_in_both(tmp_path):
    """A streaming frame (no content size in its header) is refused by the
    port (ValueError) as python-zstandard's one-shot reader, which JAX
    uses, refuses it (ZstdError)."""
    import msgpack
    payload = msgpack.packb([{"frame_id": 0}])
    path = str(tmp_path / "stream.msgpack.zst")
    with open(path, "wb") as f:
        f.write(zstandard.ZstdCompressor(write_content_size=False).compress(
            payload))
    with pytest.raises(ValueError, match="no content size"):
        read_msgpack_zst(path)
    with pytest.raises(zstandard.ZstdError, match="content size"):
        jax_read(path)


def test_not_a_frame_raises():
    with pytest.raises(ValueError, match="not a zstd frame"):
        zstd.decompress(b"not zstd at all")
    with pytest.raises(ValueError, match="decompress"):
        zstd.decompress(zstd.compress(b"abc" * 1000)[:-8])   # truncated


def test_missing_library_raises_naming_it(monkeypatch):
    monkeypatch.setattr(zstd, "LIBRARY", "libzstd-not-here.so.9")
    monkeypatch.setattr(zstd, "_lib", None)
    with pytest.raises(OSError, match="libzstd-not-here.so.9"):
        zstd.compress(b"x")


def test_compress_beside_a_library_with_its_own_zstd(tmp_path):
    """TensorFlow's ``libtensorflow_framework`` (loaded with global
    symbols) carries a zstd of its own; the system library's calls into
    itself must still bind to its own functions (a free-fall scene at
    level 22 crashes otherwise), also when the native scene loader, which
    links the library, is loaded first.  In a child process, so the
    suite's other processes are not touched."""
    import subprocess
    import sys
    code = ("import tensorflow\n"
            "import numpy as np\n"
            "from dmcf_tpu_torch.data import gen_free_fall_data, "
            "native_loader\n"
            "from dmcf_tpu_torch.data import read_msgpack_zst, "
            "write_msgpack_zst\n"
            f"native_loader.load_scene({os.path.abspath(SCENE)!r})\n"
            "np.random.seed(0)\n"
            "scene = gen_free_fall_data(data_cnt=1, timesteps=4)[0]\n"
            "write_msgpack_zst('scene.msgpack.zst', scene)\n"
            "back = read_msgpack_zst('scene.msgpack.zst')\n"
            "assert all(np.array_equal(a['pos'], b['pos']) "
            "for a, b in zip(back, scene))\n"
            "print('round trip ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=dict(os.environ, PYTHONPATH=os.path.abspath(
                              ROOT)), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and "round trip ok" in proc.stdout, (
        proc.returncode, proc.stderr[-3000:])
