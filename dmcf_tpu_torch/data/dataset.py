"""Dataset storage: msgpack.zst scene files and the generator-mode cache
(the port's copy of dmcf_tpu/data/dataset.py: same file format, same cache
key ``dict_hash``, same seeding).

A dataset is a directory of ``*.msgpack.zst`` files (one compressed list of
frame dicts per scene) or an in-memory list made by a generator, cached to
zstd-msgpack under the md5 of the generator config.  A file is read and
written through ``msgpack`` and the system's ``libzstd.so.1`` (``zstd``:
ctypes, no Python ``zstandard``); ``msgpack`` is imported where a file is
read or written.  Under ``DMCF_NATIVE_LOADER=1`` a scene file is read by
the native loader instead (``native_loader``: C++ and ``libzstd.so.1``),
which gives the same frames.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import shutil
from glob import glob

import numpy as np

from . import generators, zstd


def _mp_encode(obj):
    """msgpack-numpy wire format, so files interoperate with the JAX
    package's and the reference's datasets."""
    if isinstance(obj, np.ndarray):
        if obj.dtype.kind == "O":
            raise TypeError("object arrays not supported")
        return {b"nd": True, b"type": obj.dtype.str,
                b"kind": b"", b"shape": list(obj.shape),
                b"data": obj.tobytes()}
    if isinstance(obj, (np.bool_, np.number)):
        return {b"nd": False, b"type": obj.dtype.str,
                b"data": obj.tobytes()}
    return obj


def _mp_decode(obj):
    if b"nd" in obj:
        if obj[b"nd"]:
            return np.frombuffer(obj[b"data"],
                                 dtype=np.dtype(obj[b"type"])).reshape(
                                     obj[b"shape"])
        return np.frombuffer(obj[b"data"],
                             dtype=np.dtype(obj[b"type"]))[0]
    return obj


GENERATORS = {
    "column": generators.gen_column_data,
    "free_fall": generators.gen_free_fall_data,
    "momentum": generators.gen_momentum_data,
}


def dict_hash(d) -> str:
    return hashlib.md5(json.dumps(d, sort_keys=True).encode()).hexdigest()


def read_msgpack_zst(path):
    import msgpack

    with open(path, "rb") as f:
        return msgpack.unpackb(zstd.decompress(f.read()), raw=False,
                               object_hook=_mp_decode)


def write_msgpack_zst(path, data, level=22):
    import msgpack

    payload = zstd.compress(
        msgpack.packb(data, use_bin_type=True, default=_mp_encode), level)
    with open(path, "wb") as f:
        f.write(payload)


class Dataset:
    """A split: list of scenes, each a list of frame dicts."""

    def __init__(self, data=None, dataset_path=None):
        self.data = None
        self.files = None
        if dataset_path is not None:
            self.files = sorted(glob(os.path.join(dataset_path,
                                                  "*.msgpack.zst")))
            if not self.files:
                raise FileNotFoundError(
                    f"no *.msgpack.zst files under {dataset_path}")
        elif data is not None:
            self.data = data
        else:
            raise ValueError("need data or dataset_path")

    def __len__(self):
        return len(self.data) if self.data is not None else len(self.files)

    def __getitem__(self, idx):
        if self.data is not None:
            return self.data[idx]
        if os.environ.get("DMCF_NATIVE_LOADER") == "1":
            # no fallback: a loader that cannot be built or loaded raises
            from . import native_loader
            return native_loader.load_scene(self.files[idx])
        return read_msgpack_zst(self.files[idx])


class DatasetGroup:
    """train/valid/test split container.

    Path mode: ``dataset_path`` with train/valid/test subdirectories.
    Generator mode: ``type`` (column | free_fall | momentum) + per-split
    configs; each split is generated under its seed (the global
    ``np.random`` seeded first, as the JAX package does) and cached in
    ``<cache_dir>/<md5(cfg)>`` (written and read through ``libzstd.so.1``).
    ``cache_dir=None`` (on the command line ``--dataset.cache_dir none``)
    generates the same data with no cache file.  ``device`` goes to every
    generator: the column generator solves there
    (``generators.gen_column_data``: the CUDA kernel, or the plain version
    on the CPU), the others make their data with numpy and ignore it; it
    is no part of the cache key.
    """

    def __init__(self, train=None, valid=None, test=None, split="train",
                 regen=False, cache_dir="cache", device="cuda",
                 **dataset_cfg):
        self.name = dataset_cfg.pop("name", "dataset")
        self.train = self.valid = self.test = None

        if not dataset_cfg.get("dataset_path"):
            dataset_cfg.pop("dataset_path", None)
            gen_type = dataset_cfg.pop("type", "column")
            if gen_type not in GENERATORS:
                raise NotImplementedError(f"generator type: {gen_type}")
            fn = functools.partial(GENERATORS[gen_type], device=device)
            self.train = self._gen(fn, regen, cache_dir,
                                   {**(train or {}), **dataset_cfg})
            self.valid = self._gen(fn, regen, cache_dir,
                                   {**(valid or {}), **dataset_cfg})
            self.test = self._gen(fn, regen, cache_dir,
                                  {**(test or {}), **dataset_cfg})
        else:
            path = dataset_cfg.pop("dataset_path")
            if split == "train":
                if not os.path.exists(os.path.join(path, "train")):
                    raise FileNotFoundError(os.path.join(path, "train"))
                self.train = Dataset(
                    dataset_path=os.path.join(path, "train"))
            if split != "test":
                sub = os.path.join(path, "valid")
                self.valid = Dataset(dataset_path=sub
                                     if os.path.exists(sub) else path)
            if split != "valid":
                sub = os.path.join(path, "test")
                self.test = Dataset(dataset_path=sub
                                    if os.path.exists(sub) else path)
                if split == "test":
                    self.valid = self.test

    @staticmethod
    def _gen(fn, regen, cache_root, cfg):
        if cache_root is None:
            seed = cfg.pop("seed", None)
            if seed is not None:
                np.random.seed(seed)
            return Dataset(fn(**cfg))
        cache_dir = os.path.join(cache_root, dict_hash(cfg))
        cache_file = os.path.join(cache_dir, "data.msgpack.zst")
        seed = cfg.pop("seed", None)
        if seed is not None:
            np.random.seed(seed)
            if regen and os.path.exists(cache_dir):
                shutil.rmtree(cache_dir)
            if os.path.exists(cache_file):
                return Dataset(read_msgpack_zst(cache_file))
        data = fn(**cfg)
        ds = Dataset(data)
        if seed is not None:
            os.makedirs(cache_dir, exist_ok=True)
            write_msgpack_zst(cache_file, data)
        return ds
