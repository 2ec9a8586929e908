"""Read a TensorFlow checkpoint (a tensor bundle) with numpy and
``struct``: no TensorFlow.

A bundle ``<prefix>`` is two kinds of file:

* ``<prefix>.index``: a LevelDB table.  Its 48-byte footer holds the
  handles (offset, size; varints) of the meta-index and index blocks and
  the magic ``0xdb4775248b80fb57``; the index block's values are the
  handles of the data blocks.  A block is a run of prefix-compressed
  entries (shared key length, unshared length, value length; varints),
  a restart array and its count (fixed32), followed by a 5-byte trailer:
  the compression byte (0, none; anything else raises) and the masked
  CRC32C of the block and that byte.  Key ``""`` holds the
  ``BundleHeaderProto`` (num_shards 1, endianness 2, version 3); every
  other key a tensor's ``BundleEntryProto`` (dtype 1, shape 2, shard_id
  3, offset 4, size 5, crc32c 6 as a fixed32, slices 7).
* ``<prefix>.data-%05d-of-%05d``: the tensors' bytes, little-endian, at
  each entry's offset in its shard, checked against the entry's masked
  CRC32C as TensorFlow's reader checks them.

``BundleReader`` mirrors the part of ``tf.train.load_checkpoint`` that
``utils.tf_ckpt`` uses: ``get_variable_to_shape_map()`` and
``get_tensor(key)``.  String tensors (the object graph,
``_CHECKPOINTABLE_OBJECT_GRAPH``) are skipped; sliced (partitioned)
entries raise.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from .crc32c import crc32c, unmask
from .protowire import fields as _fields
from .protowire import varint as _varint

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_BYTES = 48
TRAILER_BYTES = 5

DT_STRING = 7
# DataType enum (tensorflow/core/framework/types.proto) -> numpy dtype;
# 14 (bfloat16) is resolved through ml_dtypes where it is read
_DTYPES = {
    1: "<f4", 2: "<f8", 3: "<i4", 4: "u1", 5: "<i2", 6: "i1", 9: "<i8",
    10: "?", 17: "<u2", 19: "<f2", 22: "<u4", 23: "<u8",
}
DT_BFLOAT16 = 14


def _int64(v):
    return v - (1 << 64) if v >= 1 << 63 else v


def _block_handle(buf, pos=0):
    offset, pos = _varint(buf, pos)
    size, pos = _varint(buf, pos)
    return (offset, size), pos


def _read_block(data, handle, path):
    """A block's contents, its trailer checked."""
    offset, size = handle
    end = offset + size
    if end + TRAILER_BYTES > len(data):
        raise ValueError(f"{path}: block {handle} runs past the file")
    kind = data[end]
    if kind != 0:
        raise ValueError(f"{path}: block {handle} has compression type "
                         f"{kind}; only uncompressed tables are read")
    (stored,) = struct.unpack_from("<I", data, end + 1)
    if unmask(stored) != crc32c(data[offset:end + 1]):
        raise ValueError(f"{path}: block {handle} fails its CRC32C")
    return data[offset:end]


def _block_entries(block, path):
    """(key, value) over a block's prefix-compressed entries."""
    if len(block) < 4:
        raise ValueError(f"{path}: block too short")
    (n_restarts,) = struct.unpack_from("<I", block, len(block) - 4)
    limit = len(block) - 4 * (n_restarts + 1)
    if limit < 0:
        raise ValueError(f"{path}: bad restart count {n_restarts}")
    pos, key = 0, b""
    while pos < limit:
        shared, pos = _varint(block, pos)
        unshared, pos = _varint(block, pos)
        n_value, pos = _varint(block, pos)
        key = key[:shared] + bytes(block[pos:pos + unshared])
        pos += unshared
        yield key, block[pos:pos + n_value]
        pos += n_value


def read_table(path):
    """Every (key, value) of a LevelDB table file, in key order."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < FOOTER_BYTES:
        raise ValueError(f"{path}: too short for a table footer")
    footer = data[-FOOTER_BYTES:]
    (magic,) = struct.unpack_from("<Q", footer, FOOTER_BYTES - 8)
    if magic != TABLE_MAGIC:
        raise ValueError(f"{path}: not a table (magic {magic:#x})")
    _, pos = _block_handle(footer)                  # the meta-index block
    index_handle, _ = _block_handle(footer, pos)
    out = []
    for _, handle in _block_entries(_read_block(data, index_handle, path),
                                    path):
        block = _read_block(data, _block_handle(handle)[0], path)
        out.extend((k, bytes(v)) for k, v in _block_entries(block, path))
    return out


def _header(buf):
    out = {"num_shards": 0, "endianness": 0}
    for field, _, val in _fields(buf):
        if field == 1:
            out["num_shards"] = val
        elif field == 2:
            out["endianness"] = val
    return out


def _shape(buf):
    dims = []
    for field, _, val in _fields(buf):
        if field == 2:                              # TensorShapeProto.dim
            size = 0
            for f, _, v in _fields(val):
                if f == 1:
                    size = _int64(v)
            dims.append(size)
        elif field == 3 and val:
            raise ValueError("tensor of unknown rank")
    return dims


def _entry(buf):
    out = {"dtype": 0, "shape": [], "shard_id": 0, "offset": 0, "size": 0,
           "crc32c": None, "sliced": False}
    for field, _, val in _fields(buf):
        if field == 1:
            out["dtype"] = val
        elif field == 2:
            out["shape"] = _shape(val)
        elif field == 3:
            out["shard_id"] = val
        elif field == 4:
            out["offset"] = _int64(val)
        elif field == 5:
            out["size"] = _int64(val)
        elif field == 6:
            out["crc32c"] = struct.unpack("<I", val)[0]
        elif field == 7:
            out["sliced"] = True
    return out


def _numpy_dtype(code, key):
    if code in _DTYPES:
        return np.dtype(_DTYPES[code])
    if code == DT_BFLOAT16:
        try:
            import ml_dtypes
        except ImportError as e:
            raise ValueError(f"{key}: a bfloat16 tensor needs the ml_dtypes "
                             f"package to become a numpy array") from e
        return np.dtype(ml_dtypes.bfloat16)
    raise ValueError(f"{key}: unsupported tensor dtype {code}")


class BundleReader:
    """A TensorFlow checkpoint ``prefix`` (``<prefix>.index`` and its data
    shards), read without TensorFlow."""

    def __init__(self, prefix):
        self.prefix = str(prefix)
        entries = read_table(self.prefix + ".index")
        if not entries or entries[0][0] != b"":
            raise ValueError(f"{self.prefix}.index: no bundle header")
        header = _header(entries[0][1])
        if header["endianness"] != 0:
            raise ValueError(f"{self.prefix}: big-endian bundles are not "
                             f"read")
        self.num_shards = header["num_shards"]
        self._entries = {}
        for key, value in entries[1:]:
            entry = _entry(value)
            name = key.decode()
            if entry["dtype"] == DT_STRING:
                continue
            if entry["sliced"]:
                raise ValueError(f"{self.prefix}: {name} is a sliced "
                                 f"(partitioned) entry; not supported")
            self._entries[name] = entry

    def _shard_path(self, shard):
        return "%s.data-%05d-of-%05d" % (self.prefix, shard,
                                         self.num_shards)

    def get_variable_to_shape_map(self):
        return {k: list(e["shape"]) for k, e in self._entries.items()}

    def get_tensor(self, key):
        """The tensor ``key`` as a numpy array, its CRC32C checked."""
        if key not in self._entries:
            raise KeyError(f"{key} not in checkpoint {self.prefix}")
        e = self._entries[key]
        dtype = _numpy_dtype(e["dtype"], key)
        n = int(np.prod(e["shape"], dtype=np.int64))
        if n * dtype.itemsize != e["size"]:
            raise ValueError(f"{key}: {e['size']} bytes for shape "
                             f"{e['shape']} of {dtype}")
        path = self._shard_path(e["shard_id"])
        with open(path, "rb") as f:
            f.seek(e["offset"])
            raw = f.read(e["size"])
        if len(raw) != e["size"]:
            raise ValueError(f"{key}: {path} ends before the tensor's "
                             f"{e['size']} bytes")
        if e["crc32c"] is not None and unmask(e["crc32c"]) != crc32c(raw):
            raise ValueError(f"{key}: tensor bytes fail their CRC32C "
                             f"(checkpoint {self.prefix} is corrupt)")
        return np.frombuffer(raw, dtype).reshape(e["shape"]).copy()


def load_checkpoint(prefix):
    """``tf.train.load_checkpoint``'s reader for a checkpoint prefix."""
    if os.path.isdir(str(prefix)):
        raise ValueError(f"{prefix} is a directory; give the checkpoint "
                         f"prefix (the path without .index)")
    return BundleReader(prefix)
