"""Reading the protobuf wire format without protobuf: varints and the
(field number, wire type, value) walk of a message.  Enough for the
TensorFlow messages the port reads (``tf_bundle``'s bundle entries,
``tb_writer``'s events)."""

from __future__ import annotations


def varint(buf, pos):
    """(value, next position) of the varint at ``buf[pos]``."""
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def fields(buf):
    """(field number, wire type, value) over a message: varints as ints,
    the others as the bytes of the field."""
    pos, n = 0, len(buf)
    while pos < n:
        tag, pos = varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = varint(buf, pos)
        elif wire == 1:
            val, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            ln, pos = varint(buf, pos)
            val, pos = buf[pos:pos + ln], pos + ln
        elif wire == 5:
            val, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val
