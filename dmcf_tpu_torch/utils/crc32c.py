"""CRC32C (Castagnoli), the checksum of TensorFlow's file formats: the
record framing of TensorBoard event files (``tb_writer``), the blocks of a
checkpoint's LevelDB index and its tensor data (``tf_bundle``).  Those
formats store the *masked* value (``masked_crc32c``).

Table-driven in plain Python: about 0.25 s a MiB, which is enough for
event records and for checkpoints of a few MiB.
"""

from __future__ import annotations

_POLY = 0x82F63B78
_MASK_DELTA = 0xA282EAD8


def _table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _table()


def crc32c(data, crc: int = 0) -> int:
    """CRC32C of ``data`` (bytes-like), continuing from ``crc``."""
    c = crc ^ 0xFFFFFFFF
    table = _TABLE
    for b in memoryview(data).cast("B"):
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def mask(crc: int) -> int:
    """The masked form TensorFlow stores (rotate right 15, add a
    constant)."""
    return ((crc >> 15 | crc << 17) + _MASK_DELTA) & 0xFFFFFFFF


def unmask(masked: int) -> int:
    rot = (masked - _MASK_DELTA) & 0xFFFFFFFF
    return (rot >> 17 | rot << 15) & 0xFFFFFFFF


def masked_crc32c(data) -> int:
    return mask(crc32c(data))
