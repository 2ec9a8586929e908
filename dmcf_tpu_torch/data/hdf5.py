"""HDF5 result files without ``h5py`` (``struct`` and numpy).

``write_results(path, name, data)`` writes what the JAX package's writer
(``dmcf_tpu/data/writers.py``, through h5py) writes: one group named
``name`` and in it one dataset per ``(array, props)`` of ``data``, named
``props["name"]``, with the attributes ``type`` (``props.get("type",
"DENSITY")``, a variable-length UTF-8 string, so h5py reads a ``str``) and
``dim`` (the shape, an int64 array).  h5py reads the file as it reads the
JAX writer's: the same group, dataset names, dtypes, shapes, values and
attributes.  ``read_results(path)`` reads back the files this writer
writes.

The file is HDF5's format at its newer versions (the layout of h5py's
``libver="latest"``): a version-2 superblock and version-2 object headers
(each with its Jenkins lookup3 checksum, ``lookup3``), groups with their
links in the header (Link Info, Group Info and one Link message a child),
datasets contiguous, little-endian as numpy gives them, uncompressed, the
attribute strings in one global heap collection.  Addresses and lengths
are 8 bytes.
"""

from __future__ import annotations

import os
import struct
from typing import NamedTuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF           # the undefined address
SUPERBLOCK_SIZE = 48
HEAP_MIN_SIZE = 4096                 # a global heap collection's least size
# object header message types
DATASPACE, LINK_INFO, DATATYPE, FILL_VALUE, LINK, LAYOUT, GROUP_INFO, \
    ATTRIBUTE = 0x01, 0x02, 0x03, 0x05, 0x06, 0x08, 0x0A, 0x0C
CONSTANT = 0x01                      # message flag: the message never changes
UTF8 = 1                             # character set of names and strings
# IEEE float layouts: size -> (sign bit, exponent bit, exponent bits,
# mantissa bits, exponent bias)
FLOATS = {2: (15, 10, 5, 10, 15), 4: (31, 23, 8, 23, 127),
          8: (63, 52, 11, 52, 1023)}


class Series(NamedTuple):
    """A dataset read back: its array and its attributes."""
    data: np.ndarray
    attrs: dict


# ---------------------------------------------------------------------------
# Jenkins lookup3 (hashlittle), HDF5's metadata checksum
# ---------------------------------------------------------------------------

_M = 0xFFFFFFFF


def _rot(x, k):
    return ((x << k) | (x >> (32 - k))) & _M


def lookup3(data, initval=0):
    """Bob Jenkins' lookup3 ``hashlittle`` of ``data`` (bytes-like) with
    ``initval``, as HDF5's ``H5_checksum_lookup3`` takes it."""
    k = bytes(data)
    n = len(k)
    a = b = c = (0xDEADBEEF + n + initval) & _M
    if n == 0:
        return c
    # the last block (1-12 bytes) is zero-padded; the loop takes the others
    tail = n - ((n - 1) % 12 + 1)
    words = struct.unpack(f"<{(tail + 12) // 4}I",
                          k + bytes(tail + 12 - n))
    for i in range(0, len(words), 3):
        a = (a + words[i]) & _M
        b = (b + words[i + 1]) & _M
        c = (c + words[i + 2]) & _M
        if i + 3 == len(words):
            break
        a = (a - c) & _M; a ^= _rot(c, 4); c = (c + b) & _M
        b = (b - a) & _M; b ^= _rot(a, 6); a = (a + c) & _M
        c = (c - b) & _M; c ^= _rot(b, 8); b = (b + a) & _M
        a = (a - c) & _M; a ^= _rot(c, 16); c = (c + b) & _M
        b = (b - a) & _M; b ^= _rot(a, 19); a = (a + c) & _M
        c = (c - b) & _M; c ^= _rot(b, 4); b = (b + a) & _M
    c ^= b; c = (c - _rot(b, 14)) & _M
    a ^= c; a = (a - _rot(c, 11)) & _M
    b ^= a; b = (b - _rot(a, 25)) & _M
    c ^= b; c = (c - _rot(b, 16)) & _M
    a ^= c; a = (a - _rot(c, 4)) & _M
    b ^= a; b = (b - _rot(a, 14)) & _M
    c ^= b; c = (c - _rot(b, 24)) & _M
    return c


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def _message(mtype, body, flags=0):
    return struct.pack("<BHB", mtype, len(body), flags) + body


def _object_header(messages):
    """A version-2 object header holding ``messages``, its checksum last."""
    body = b"".join(messages)
    for flags, fmt in ((0, "<B"), (1, "<H"), (2, "<I")):
        if len(body) < 1 << (8 * struct.calcsize(fmt)):
            break
    head = b"OHDR" + bytes([2, flags]) + struct.pack(fmt, len(body)) + body
    return head + struct.pack("<I", lookup3(head))


def _group_header(links):
    """A new-style group's header: Link Info (no fractal heap, no name
    index), Group Info, and a hard Link a child ``(name, address)``."""
    msgs = [_message(LINK_INFO, struct.pack("<BBQQ", 0, 0, UNDEF, UNDEF)),
            _message(GROUP_INFO, bytes([0, 0]))]
    for name, addr in links:
        raw = name.encode()
        if len(raw) > 255:
            raise ValueError(f"hdf5: a link name of {len(raw)} bytes")
        # version 1, flags: the character set field present (bit 4), a
        # one-byte name length; then the hard link's address
        msgs.append(_message(LINK, bytes([1, 0x10, UTF8, len(raw)]) + raw
                             + struct.pack("<Q", addr)))
    return _object_header(msgs)


def _dataspace(shape):
    """A version-2 dataspace: scalar for ``()``, else simple, no maximum
    dimensions (they equal the dimensions)."""
    return bytes([2, len(shape), 0, 1 if shape else 0]) + struct.pack(
        f"<{len(shape)}Q", *shape)


def _datatype(dtype):
    """A version-1 datatype message body for a numpy int, uint or float
    dtype."""
    dtype = np.dtype(dtype)
    order = 1 if dtype.byteorder == ">" else 0
    size = dtype.itemsize
    if dtype.kind in "iu":
        bits = order | (0x08 if dtype.kind == "i" else 0)
        return (bytes([0x10, bits, 0, 0]) + struct.pack("<I", size)
                + struct.pack("<HH", 0, 8 * size))
    if dtype.kind == "f" and size in FLOATS:
        sign, exp_at, exp_bits, man_bits, bias = FLOATS[size]
        # mantissa normalisation 2 (the msb implied), no padding bits
        return (bytes([0x11, order | 0x20, sign, 0])
                + struct.pack("<I", size)
                + struct.pack("<HHBBBBI", 0, 8 * size, exp_at, exp_bits, 0,
                              man_bits, bias))
    raise TypeError(f"hdf5: no datatype for {dtype}")


# a variable-length UTF-8 string (null-padded), its elements unsigned
# bytes; 16 bytes in a record: length, heap collection address, index
_VLEN_STRING = (bytes([0x19, 0x01, UTF8, 0]) + struct.pack("<I", 16)
                + _datatype(np.uint8))


def _attribute(name, dtype_msg, space, value):
    raw = name.encode() + b"\0"
    return _message(ATTRIBUTE, struct.pack(
        "<BBHHHB", 3, 0, len(raw), len(dtype_msg), len(space), UTF8)
        + raw + dtype_msg + space + value)


def _heap_collection(strings):
    """A global heap collection holding ``strings`` (bytes) as objects
    1..n, then its free space.  Returns the collection's bytes."""
    objs = b""
    for i, s in enumerate(strings, 1):
        pad = -len(s) % 8
        objs += struct.pack("<HHIQ", i, 0, 0, len(s)) + s + bytes(pad)
    size = max(HEAP_MIN_SIZE, 16 + len(objs) + 16)
    size += -size % 8
    free = size - 16 - len(objs)
    # the free space object (index 0): its size counts its own header
    objs += struct.pack("<HHIQ", 0, 0, 0, free) + bytes(free - 16)
    return b"GCOL" + bytes([1, 0, 0, 0]) + struct.pack("<Q", size) + objs


def _dataset_header(arr, kind, data_addr, heap_addr, heap_index):
    space = _dataspace(arr.shape)
    dim = np.asarray(arr.shape, np.int64)
    msgs = [
        _message(DATASPACE, space),
        _message(DATATYPE, _datatype(arr.dtype), CONSTANT),
        # fill value version 3: allocated late, written if set, default
        _message(FILL_VALUE, bytes([3, 0x0A]), CONSTANT),
        # layout version 3, contiguous
        _message(LAYOUT, struct.pack("<BBQQ", 3, 1, data_addr, arr.nbytes)),
        _attribute("type", _VLEN_STRING, _dataspace(()),
                   struct.pack("<IQI", len(kind), heap_addr, heap_index)),
        _attribute("dim", _datatype(dim.dtype), _dataspace(dim.shape),
                   dim.tobytes()),
    ]
    return _object_header(msgs)


def write_results(path, name, data):
    """Write rollout arrays to hdf5: one group per model, one dataset per
    series (pred/gt/bnd) with type/dim attributes.  ``data`` is a list
    of ``(array, props)``: ``props["name"]`` the dataset's name,
    ``props.get("type", "DENSITY")`` its ``type`` attribute."""
    if "/" in name or not name:
        raise ValueError(f"hdf5: group name {name!r}")
    series, seen = [], set()
    for d, props in data:
        arr = np.asarray(d)
        if arr.ndim == 0:
            raise ValueError("hdf5: a result is an array of one dimension "
                             "or more")
        arr = np.ascontiguousarray(arr)
        _datatype(arr.dtype)          # raises on a dtype it cannot write
        dname = props["name"]
        if "/" in dname or not dname or dname in seen:
            raise ValueError(f"hdf5: dataset name {dname!r}")
        seen.add(dname)
        kind = props.get("type", "DENSITY")
        if not isinstance(kind, str):
            raise TypeError(f"hdf5: the type attribute {kind!r} is not a "
                            f"str")
        series.append((arr, kind, dname))
    ordered = sorted(series, key=lambda s: s[2].encode())   # h5py's order
    heap = _heap_collection([kind.encode() for _, kind, _ in ordered])
    # a header's length does not depend on the addresses in it: the root's
    # and the group's headers, each dataset's, the heap, then each
    # dataset's data, 8-byte aligned
    group_addr = SUPERBLOCK_SIZE + len(_group_header([(name, 0)]))
    at = group_addr + len(_group_header([(n, 0) for _, _, n in ordered]))
    header_addr = []
    for arr, kind, _ in ordered:
        header_addr.append(at)
        at += len(_dataset_header(arr, kind.encode(), 0, 0, 0))
    heap_addr = at
    at += len(heap)
    data_addr = []
    for arr, _, _ in ordered:
        if arr.nbytes:
            at += -at % 8
        data_addr.append(at if arr.nbytes else UNDEF)
        at += arr.nbytes
    sb = SIGNATURE + struct.pack("<BBBBQQQQ", 2, 8, 8, 0, 0, UNDEF, at,
                                 SUPERBLOCK_SIZE)
    headers = [sb + struct.pack("<I", lookup3(sb)),
               _group_header([(name, group_addr)]),
               _group_header([(n, a) for (_, _, n), a in zip(ordered,
                                                             header_addr)])]
    headers += [_dataset_header(arr, kind.encode(), d, heap_addr, i + 1)
                for i, ((arr, kind, _), d) in enumerate(zip(ordered,
                                                            data_addr))]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pos = f.write(b"".join(headers) + heap)
        for (arr, _, _), d in zip(ordered, data_addr):
            if arr.nbytes:
                pos += f.write(bytes(d - pos))
                pos += f.write(memoryview(arr).cast("B"))
    if pos != at:
        raise RuntimeError(f"hdf5: wrote {pos} bytes of {at}")


# ---------------------------------------------------------------------------
# reading (the files write_results writes)
# ---------------------------------------------------------------------------


def _checked_header(buf, addr):
    """The messages [(type, body)] of the version-2 object header at
    ``addr``, its checksum verified."""
    if buf[addr:addr + 4] != b"OHDR" or buf[addr + 4] != 2:
        raise ValueError(f"hdf5: no version-2 object header at {addr}")
    flags = buf[addr + 5]
    if flags & ~0x03:
        raise ValueError(f"hdf5: object header flags {flags:#x} not read")
    width = 1 << (flags & 0x03)
    size = int.from_bytes(buf[addr + 6:addr + 6 + width], "little")
    start = addr + 6 + width
    end = start + size
    (want,) = struct.unpack_from("<I", buf, end)
    if lookup3(buf[addr:end]) != want:
        raise ValueError(f"hdf5: object header checksum at {addr}")
    msgs, p = [], start
    while p + 4 <= end:
        mtype, msize, _ = struct.unpack_from("<BHB", buf, p)
        msgs.append((mtype, buf[p + 4:p + 4 + msize]))
        p += 4 + msize
    return msgs


def _links(msgs):
    out = {}
    for mtype, body in msgs:
        if mtype != LINK:
            continue
        version, flags = body[0], body[1]
        if version != 1 or flags & 0x0B:
            raise ValueError(f"hdf5: link message flags {flags:#x} not read")
        p = 2 + (1 if flags & 0x10 else 0) + (8 if flags & 0x04 else 0)
        n = body[p]
        name = body[p + 1:p + 1 + n].decode()
        (out[name],) = struct.unpack_from("<Q", body, p + 1 + n)
    return out


def _read_dataspace(body):
    version, ndims, flags, kind = body[0], body[1], body[2], body[3]
    if version != 2 or kind not in (0, 1):
        raise ValueError("hdf5: dataspace not read")
    return struct.unpack_from(f"<{ndims}Q", body, 4)


def _read_datatype(body):
    """(numpy dtype or "vlen-utf8", bytes read)."""
    cls, bits0 = body[0] & 0x0F, body[1]
    (size,) = struct.unpack_from("<I", body, 4)
    order = ">" if bits0 & 1 else "<"
    if cls == 0:
        return np.dtype(f"{order}{'i' if bits0 & 0x08 else 'u'}{size}"), 12
    if cls == 1:
        return np.dtype(f"{order}f{size}"), 20
    if cls == 9 and bits0 & 0x0F == 1:
        return "vlen-utf8", 8 + _read_datatype(body[8:])[1]
    raise ValueError(f"hdf5: datatype class {cls} not read")


def _heap_object(buf, addr, index):
    if buf[addr:addr + 4] != b"GCOL":
        raise ValueError(f"hdf5: no global heap collection at {addr}")
    (size,) = struct.unpack_from("<Q", buf, addr + 8)
    p, end = addr + 16, addr + size
    while p + 16 <= end:
        idx, _, _, n = struct.unpack_from("<HHIQ", buf, p)
        if idx == 0:
            break
        if idx == index:
            return bytes(buf[p + 16:p + 16 + n])
        p += 16 + n + (-n % 8)
    raise ValueError(f"hdf5: no heap object {index} at {addr}")


def _read_attribute(buf, body):
    version, _, nlen, tlen, slen = struct.unpack_from("<BBHHH", body)
    if version != 3:
        raise ValueError(f"hdf5: attribute message version {version}")
    p = 9
    name = body[p:p + nlen].rstrip(b"\0").decode()
    p += nlen
    dtype, _ = _read_datatype(body[p:p + tlen])
    shape = _read_dataspace(body[p + tlen:p + tlen + slen])
    raw = body[p + tlen + slen:]
    if dtype == "vlen-utf8":
        if shape:
            raise ValueError("hdf5: only scalar string attributes are read")
        n, addr, index = struct.unpack_from("<IQI", raw)
        return name, _heap_object(buf, addr, index)[:n].decode()
    count = int(np.prod(shape)) if shape else 1
    value = np.frombuffer(raw, dtype, count).reshape(shape).copy()
    return name, value


def _read_dataset(buf, msgs):
    shape = dtype = layout = None
    attrs = {}
    for mtype, body in msgs:
        if mtype == DATASPACE:
            shape = _read_dataspace(body)
        elif mtype == DATATYPE:
            dtype, _ = _read_datatype(body)
        elif mtype == LAYOUT:
            if body[0] != 3 or body[1] != 1:
                raise ValueError("hdf5: only contiguous layouts are read")
            layout = struct.unpack_from("<QQ", body, 2)
        elif mtype == ATTRIBUTE:
            key, value = _read_attribute(buf, body)
            attrs[key] = value
    if shape is None or dtype is None or layout is None:
        raise ValueError("hdf5: not a dataset's header")
    addr, nbytes = layout
    if addr == UNDEF:
        data = np.zeros(shape, dtype)
    else:
        data = np.frombuffer(buf, dtype, nbytes // dtype.itemsize,
                             addr).reshape(shape).copy()
    return Series(data, attrs)


def read_results(path):
    """Read a file ``write_results`` wrote: ``{group: {name: Series(data,
    attrs)}}``, every checksum verified."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != SIGNATURE or buf[8] != 2:
        raise ValueError(f"hdf5: {path} has no version-2 superblock")
    (want,) = struct.unpack_from("<I", buf, SUPERBLOCK_SIZE - 4)
    if lookup3(buf[:SUPERBLOCK_SIZE - 4]) != want:
        raise ValueError(f"hdf5: {path}: superblock checksum")
    eof, root = struct.unpack_from("<QQ", buf, 28)
    if eof != len(buf):
        raise ValueError(f"hdf5: {path}: end of file {eof}, file "
                         f"{len(buf)} bytes")
    out = {}
    for gname, gaddr in _links(_checked_header(buf, root)).items():
        out[gname] = {
            dname: _read_dataset(buf, _checked_header(buf, daddr))
            for dname, daddr in _links(_checked_header(buf, gaddr)).items()}
    return out
