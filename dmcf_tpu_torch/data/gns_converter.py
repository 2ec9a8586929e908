"""GNS (DeepMind learning_to_simulate) tfrecord -> msgpack.zst converter
(the port's copy of dmcf_tpu/data/gns_converter.py; the same scene files).

No TensorFlow: a minimal protobuf wire-format parser decodes the
tf.SequenceExample records (context: key/particle_type; feature_lists:
position [, step_context]), velocities are derived by forward differences,
fluid (type 5) and boundary (type 3) particles are split, boundary normals
are estimated by a Gaussian neighbor splat, thick domain walls are sampled,
and 50-frame blocks are written as msgpack.zst scene files.

Usage:
    python -m dmcf_tpu_torch.data.gns_converter \
        --data_path datasets/WaterRamps --out_path datasets/WaterRamps \
        --split train

The scene files are written by the port's ``write_msgpack_zst``
(``msgpack`` and the system's ``libzstd.so.1``).
"""

from __future__ import annotations

import argparse
import json
import os
import struct

import numpy as np

from ..utils.crc32c import masked_crc32c
from .dataset import write_msgpack_zst

INPUT_SEQUENCE_LENGTH = 6


# ---------------------------------------------------------------------------
# minimal protobuf wire parsing (enough for tf.SequenceExample)
# ---------------------------------------------------------------------------


def _read_varint(buf, pos):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf):
    """Yield (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 0x7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_feature(buf):
    """tf.Feature -> (kind, values)."""
    for field, wire, val in _iter_fields(buf):
        if field == 1:  # bytes_list
            return "bytes", [v for f, w, v in _iter_fields(val) if f == 1]
        if field == 2:  # float_list (packed or repeated)
            floats = []
            for f, w, v in _iter_fields(val):
                if f == 1:
                    if w == 2:
                        floats.extend(struct.unpack(f"<{len(v) // 4}f", v))
                    else:
                        floats.append(struct.unpack("<f", v)[0])
            return "float", floats
        if field == 3:  # int64_list
            ints = []
            for f, w, v in _iter_fields(val):
                if f == 1:
                    if w == 2:
                        p = 0
                        while p < len(v):
                            x, p = _read_varint(v, p)
                            ints.append(x)
                    else:
                        ints.append(v)
            return "int64", ints
    return None, []


def _parse_feature_map(buf):
    """Features message (map<string, Feature>)."""
    out = {}
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            key = None
            feat = None
            for f, w, v in _iter_fields(val):
                if f == 1:
                    key = v.decode()
                elif f == 2:
                    feat = _parse_feature(v)
            out[key] = feat
    return out


def _parse_feature_lists(buf):
    """FeatureLists message (map<string, FeatureList>)."""
    out = {}
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            key = None
            feats = []
            for f, w, v in _iter_fields(val):
                if f == 1:
                    key = v.decode()
                elif f == 2:
                    feats = [_parse_feature(x)
                             for ff, ww, x in _iter_fields(v) if ff == 1]
            out[key] = feats
    return out


def parse_sequence_example(buf):
    """Serialized tf.SequenceExample -> (context dict, feature_lists dict)."""
    context, lists = {}, {}
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            context = _parse_feature_map(val)
        elif field == 2:
            lists = _parse_feature_lists(val)
    return context, lists


def read_tfrecord(path):
    """Yield raw record payloads from a TFRecord file (crc skipped)."""
    with open(path, "rb") as f:
        while True:
            head = f.read(12)
            if len(head) < 12:
                return
            (length,) = struct.unpack("<Q", head[:8])
            payload = f.read(length)
            f.read(4)  # data crc
            yield payload


# ---------------------------------------------------------------------------
# wire-format encoding: the inverse of the parser above, to synthesize
# GNS-format datasets and to test the round trip.
# ---------------------------------------------------------------------------


def _enc_varint(x):
    out = b""
    while True:
        b = x & 0x7F
        x >>= 7
        out += bytes([b | (0x80 if x else 0)])
        if not x:
            return out


def _enc_ld(num, data):
    return _enc_varint((num << 3) | 2) + _enc_varint(len(data)) + data


def encode_sequence_example(positions, ptype, step_context=None):
    """[T, N, dim] float32 positions + [N] int64 types -> serialized
    tf.SequenceExample bytes (the format parse_sequence_example reads)."""
    packed = b"".join(_enc_varint(int(v)) for v in ptype)
    feature = _enc_ld(3, _enc_ld(1, packed))  # Feature.int64_list
    context = _enc_ld(1, _enc_ld(1, b"particle_type") + _enc_ld(2, feature))

    def bytes_feature(arr):
        inner = _enc_ld(1, np.ascontiguousarray(arr, "<f4").tobytes())
        return _enc_ld(1, inner)  # Feature.bytes_list

    feats = b"".join(_enc_ld(1, bytes_feature(p)) for p in positions)
    flists = _enc_ld(1, _enc_ld(1, b"position") + _enc_ld(2, feats))
    if step_context is not None:
        cf = b"".join(_enc_ld(1, bytes_feature(c)) for c in step_context)
        flists += _enc_ld(1, _enc_ld(1, b"step_context") + _enc_ld(2, cf))
    return _enc_ld(1, context) + _enc_ld(2, flists)


def write_tfrecord(path, records):
    """tfrecord framing: <u64 length><4B len-crc><data><4B data-crc>, the
    CRCs masked CRC32C as TensorFlow writes them (``read_tfrecord`` skips
    them)."""
    with open(path, "wb") as f:
        for rec in records:
            head = struct.pack("<Q", len(rec))
            f.write(head + struct.pack("<I", masked_crc32c(head)))
            f.write(rec + struct.pack("<I", masked_crc32c(rec)))


def parse_gns_trajectory(record, metadata):
    """One record -> dict(pos [T, N, dim], type [N], ctx?)."""
    context, lists = parse_sequence_example(record)
    dim = metadata["dim"]
    t = metadata["sequence_length"] + 1

    kind, vals = context["particle_type"]
    if kind == "bytes":
        ptype = np.frombuffer(b"".join(vals), dtype=np.int64)
    else:
        ptype = np.asarray(vals, np.int64)

    frames = []
    for kind, vals in lists["position"]:
        assert kind == "bytes"
        frames.append(np.frombuffer(b"".join(vals), dtype=np.float32))
    pos = np.stack(frames).reshape(t, -1, dim)

    out = {"pos": pos, "type": ptype}
    if "step_context" in lists:
        ctx = [np.frombuffer(b"".join(v), np.float32)
               for _, v in lists["step_context"]]
        out["ctx"] = np.stack(ctx)
    return out


# ---------------------------------------------------------------------------
# boundary synthesis
# ---------------------------------------------------------------------------


def estimate_normals(bnds, res, h=0.5):
    """Boundary normals from a Gaussian splat of neighboring boundary
    points (vectorized version of ParticleIdxGrid.get_normal)."""
    p = bnds * np.array([res, res, 1.0])
    d = p[None, :, :] - p[:, None, :]  # [N, N, 3]
    dist_sq = np.sum(d**2, axis=-1)
    w = np.exp(-dist_sq / h**2)
    near = dist_sq <= (3 * h) ** 2
    np.fill_diagonal(near, False)
    normal = -np.sum(np.where(near[..., None], d * w[..., None], 0.0),
                     axis=1)
    n = np.linalg.norm(normal, axis=-1, keepdims=True)
    normal = np.where(n > 1e-10, normal / np.maximum(n, 1e-10), 0.0)
    normal[near.sum(1) < 1] = 0.0
    return normal


def _box_points(x0, x1, y0, y1, z0, z1):
    xs, ys, zs = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1),
                             np.arange(z0, z1), indexing="ij")
    return np.stack([xs.reshape(-1), ys.reshape(-1), zs.reshape(-1)],
                    axis=-1) + 0.5


def sample_boundary_walls(bnd, gs):
    """Thick domain walls: left/right/bottom/top slabs with inward
    normals."""
    bnd = int(bnd)
    parts, normals = [], []

    def add(pts, n):
        parts.append(pts)
        normals.append(np.repeat(np.asarray([n], np.float32), len(pts), 0))

    add(_box_points(0, bnd, 0, gs[1], 0, gs[2]), [1.0, 0.0, 0.0])
    add(_box_points(gs[0] - bnd, gs[0], 0, gs[1], 0, gs[2]),
        [-1.0, 0.0, 0.0])
    add(_box_points(bnd, gs[0] - bnd, 0, bnd, 0, gs[2]), [0.0, 1.0, 0.0])
    add(_box_points(bnd, gs[0] - bnd, gs[1] - bnd, gs[1], 0, gs[2]),
        [0.0, -1.0, 0.0])
    return np.concatenate(parts, 0), np.concatenate(normals, 0)


# ---------------------------------------------------------------------------


def convert(data_path, out_path, split="train", block_size=50, res=65,
            dt=0.0025, limit=None):
    """Convert one split of a GNS dataset directory."""
    with open(os.path.join(data_path, "metadata.json")) as f:
        metadata = json.load(f)

    out_dir = os.path.join(out_path, split)
    os.makedirs(out_dir, exist_ok=True)
    pattern = os.path.join(out_dir, "sim_%04d_%02d.msgpack.zst")

    n_written = 0
    records = read_tfrecord(os.path.join(data_path, f"{split}.tfrecord"))
    for di, record in enumerate(records):
        if limit is not None and di >= limit:
            break
        data = parse_gns_trajectory(record, metadata)
        pos, ptype = data["pos"], data["type"]
        pos = np.concatenate([pos, np.zeros_like(pos[..., :1])], axis=-1)
        fluid = pos[:, ptype == 5]
        bnds = pos[:, ptype == 3][0] if np.any(ptype == 3) else \
            np.zeros((0, 3), np.float32)
        vel = np.concatenate(
            [fluid[1:] - fluid[:-1], fluid[-1:] - fluid[-2:-1]],
            axis=0) / dt

        if bnds.shape[0] > 0:
            bnds_nor = estimate_normals(bnds, res)
        walls, walls_nor = sample_boundary_walls(res * 0.1 * 2,
                                                 [res * 2, res * 2, 1])
        walls = walls / np.array([res * 2, res * 2, 1.0])
        if bnds.shape[0] > 0:
            bnds = np.concatenate([bnds, walls], 0)
            bnds_nor = np.concatenate([bnds_nor, walls_nor], 0)
        else:
            bnds, bnds_nor = walls, walls_nor
        bnds = np.asarray(bnds, np.float32)
        bnds[:, -1] = 0.0

        for bi in range(fluid.shape[0] // block_size):
            frames = [{
                "box": bnds,
                "box_normals": np.asarray(bnds_nor, np.float32),
                "frame_id": bi * block_size + i,
                "scene_id": "sim_%04d" % di,
                "pos": np.asarray(fluid[bi * block_size + i], np.float32),
                "vel": np.asarray(vel[bi * block_size + i], np.float32),
            } for i in range(block_size)]
            write_msgpack_zst(pattern % (di, bi), frames)
            n_written += 1
    return n_written


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_path", type=str,
                        default="datasets/WaterRamps")
    parser.add_argument("--out_path", type=str,
                        default="datasets/WaterRamps")
    parser.add_argument("--split", type=str, default="train")
    parser.add_argument("--block_size", type=int, default=50)
    parser.add_argument("--res", type=int, default=65)
    parser.add_argument("--dt", type=float, default=0.0025)
    parser.add_argument("--limit", type=int, default=None)
    args = parser.parse_args()
    n = convert(args.data_path, args.out_path, split=args.split,
                block_size=args.block_size, res=args.res, dt=args.dt,
                limit=args.limit)
    print(f"wrote {n} scene blocks")


if __name__ == "__main__":
    main()
