"""Minimal TensorBoard event-file writer with no TensorFlow (the port's
copy of dmcf_tpu/utils/tb_writer.py; the same bytes for the same calls).

An events file is a sequence of length-prefixed, CRC32C-masked records of
serialized ``Event`` protos.  This module hand-encodes the two messages
the pipelines emit (scalar and text summaries) in the protobuf wire
format.

Wire schema (tensorboard/compat/proto/event.proto):
  Event:   wall_time = 1 (double), step = 2 (int64), summary = 5 (message)
  Summary: value = 1 (repeated message)
  Summary.Value: tag = 1 (string), simple_value = 2 (float),
                 tensor = 8 (message, used for text)
  TensorProto: dtype = 1 (enum, DT_STRING = 7), string_val = 8 (bytes)
  Record framing (tensorflow record format): u64-LE length, masked-crc32c
  of the length bytes, payload, masked-crc32c of the payload.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time

from .crc32c import masked_crc32c as _masked_crc
from .protowire import fields

# ---------------------------------------------------------------------------
# protobuf wire encoding helpers


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _field(num: int, wire: int) -> bytes:
    return _varint(num << 3 | wire)


def _len_delim(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def _double(num: int, v: float) -> bytes:
    return _field(num, 1) + struct.pack("<d", v)


def _float(num: int, v: float) -> bytes:
    return _field(num, 5) + struct.pack("<f", v)


def _int64(num: int, v: int) -> bytes:
    return _field(num, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _event(step: int, summary: bytes) -> bytes:
    return (_double(1, time.time()) + _int64(2, int(step)) +
            _len_delim(5, summary))


def read_records(path):
    """The payloads of a TFRecord / events file, each record's two masked
    CRC32C values checked (raises ValueError on a mismatch)."""
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return out
            if len(header) < 12:
                raise ValueError(f"{path}: truncated record header")
            length, hcrc = struct.unpack("<QI", header)
            if _masked_crc(header[:8]) != hcrc:
                raise ValueError(f"{path}: record length fails its CRC")
            payload = f.read(length)
            tail = f.read(4)
            if len(payload) < length or len(tail) < 4 or \
                    _masked_crc(payload) != struct.unpack("<I", tail)[0]:
                raise ValueError(f"{path}: record payload fails its CRC")
            out.append(payload)


def read_events(path):
    """The events of an events file (``read_records``, CRCs checked) as
    dicts: ``wall_time``, ``step``, and per event kind ``file_version``,
    or ``tag`` with ``value`` (a scalar) or ``text``."""
    out = []
    for rec in read_records(path):
        ev = {"step": 0}
        for f, _, v in fields(rec):
            if f == 1:
                ev["wall_time"] = struct.unpack("<d", v)[0]
            elif f == 2:
                ev["step"] = v
            elif f == 3:
                ev["file_version"] = bytes(v).decode()
            elif f == 5:                            # Summary
                for f2, _, value in fields(v):
                    if f2 != 1:
                        continue
                    for f3, _, x in fields(value):  # Summary.Value
                        if f3 == 1:
                            ev["tag"] = bytes(x).decode()
                        elif f3 == 2:
                            ev["value"] = struct.unpack("<f", x)[0]
                        elif f3 == 8:               # TensorProto
                            ev["text"] = b"".join(
                                bytes(s) for f4, _, s in fields(x)
                                if f4 == 8).decode()
        out.append(ev)
    return out


class TBEventWriter:
    """Append-only scalar/text writer producing TensorBoard events files."""

    def __init__(self, directory):
        os.makedirs(directory, exist_ok=True)
        fname = "events.out.tfevents.%d.%s.%d.v2" % (
            int(time.time()), socket.gethostname(), os.getpid())
        self.path = os.path.join(directory, fname)
        self._f = open(self.path, "ab")
        self._lock = threading.Lock()
        # file-version header event, as TF writes it
        self._write(_double(1, time.time()) +
                    _len_delim(3, b"brain.Event:2"))

    def _write(self, event: bytes):
        header = struct.pack("<Q", len(event))
        rec = (header + struct.pack("<I", _masked_crc(header)) + event +
               struct.pack("<I", _masked_crc(event)))
        with self._lock:
            self._f.write(rec)

    def scalar(self, tag, value, step):
        val = _len_delim(1, tag.encode()) + _float(2, float(value))
        self._write(_event(step, _len_delim(1, val)))

    def text(self, tag, text, step=0):
        tensor = _varint(1 << 3) + _varint(7) + \
            _len_delim(8, str(text).encode())
        # tensorboard's text plugin finds text via the plugin_data name
        plugin = _len_delim(1, _len_delim(1, b"text"))
        val = (_len_delim(1, tag.encode()) + _len_delim(8, tensor) +
               _len_delim(9, plugin))
        self._write(_event(step, _len_delim(1, val)))

    def flush(self):
        with self._lock:
            self._f.flush()

    def close(self):
        with self._lock:
            self._f.close()
