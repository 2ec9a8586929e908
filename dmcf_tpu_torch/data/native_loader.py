"""ctypes bindings of the native scene loader (the port's copy of
dmcf_tpu/data/native_loader.py).

``native/scene_loader.cpp`` decodes a ``*.msgpack.zst`` scene file (zstd,
then msgpack) in C++, off the GIL, through ``libzstd.so.1`` alone: no
Python ``zstandard`` and no ``zstd.h`` is needed.  It is built with
``g++ -O3 -fPIC -shared -std=c++17`` at first use (never at import) into
``_build/scene_loader-<hash>.so``, keyed by a hash of the source and the
command, as ``kernels/build.py`` keys the CUDA libraries.

``Dataset`` reads through it when ``DMCF_NATIVE_LOADER=1``.  Unlike the
JAX package, nothing falls back: when the loader is asked for and cannot
be built or loaded, ``load_scene`` raises with the compiler's or the
dynamic loader's message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "scene_loader.cpp"
BUILD_DIR = _PKG / "_build"
CXX = "g++"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]
LIBS = ["-l:libzstd.so.1"]

# value kinds of scene_entry (enum Kind in the source)
NIL, INT, FLOAT, STR, BIN, BOOL, ARRAY, SCALAR, OTHER = range(9)
_OPEN_ERRORS = {-1: "cannot open the file", -2: "cannot read the file",
                -3: "zstd cannot decompress it",
                -4: "its payload is not a msgpack list of frames",
                -5: "a frame is not a msgpack map the loader decodes"}

_lib = None


def _command(out):
    return [CXX, *CXX_FLAGS, str(SOURCE), "-o", str(out), *LIBS]


def target():
    """The shared library's path for the current source and command."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(_command("")).encode())
    return BUILD_DIR / f"scene_loader-{h.hexdigest()[:16]}.so"


def build():
    """Compile the loader unless it is built.  Returns the compiler's
    output (empty when it was already built); raises RuntimeError with
    that output when the compiler fails or is missing."""
    out = target()
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(_command(tmp), capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native scene loader: cannot run the compiler "
                           f"{CXX!r}: {e}") from e
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"native scene loader: {CXX} failed for "
                           f"{SOURCE.name} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def load_library():
    """The loader's ctypes handle, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    build()
    try:
        lib = ctypes.CDLL(str(target()))
    except OSError as e:
        raise RuntimeError(f"native scene loader: cannot load "
                           f"{target()}: {e}") from e
    i64, p = ctypes.c_int64, ctypes.POINTER
    lib.scene_open.argtypes = [ctypes.c_char_p]
    lib.scene_open.restype = i64
    lib.scene_num_frames.argtypes = [i64]
    lib.scene_num_frames.restype = i64
    lib.scene_num_entries.argtypes = [i64, i64]
    lib.scene_num_entries.restype = i64
    lib.scene_entry.argtypes = [
        i64, i64, i64, p(ctypes.c_void_p), p(i64), p(i64),
        p(ctypes.c_double), p(ctypes.c_void_p), p(i64), p(i64),
        p(ctypes.c_int), ctypes.c_char_p]
    lib.scene_entry.restype = ctypes.c_int
    lib.scene_close.argtypes = [i64]
    lib.scene_close.restype = None
    _lib = lib
    return lib


def load_scene(path):
    """Decode a ``.msgpack.zst`` scene natively: the list of frame dicts
    that ``read_msgpack_zst`` returns (arrays copied out of the handle)."""
    lib = load_library()
    h = lib.scene_open(os.fsencode(str(path)))
    if h <= 0:
        raise RuntimeError(f"native scene loader: {path}: "
                           f"{_OPEN_ERRORS.get(h, f'error {h}')}")
    key = ctypes.c_void_p()
    key_len, ival, nbytes = ctypes.c_int64(), ctypes.c_int64(), \
        ctypes.c_int64()
    fval = ctypes.c_double()
    data = ctypes.c_void_p()
    shape = (ctypes.c_int64 * 8)()
    ndim = ctypes.c_int()
    dtype = ctypes.create_string_buffer(16)
    try:
        frames = []
        for t in range(lib.scene_num_frames(h)):
            frame = {}
            for i in range(lib.scene_num_entries(h, t)):
                kind = lib.scene_entry(
                    h, t, i, ctypes.byref(key), ctypes.byref(key_len),
                    ctypes.byref(ival), ctypes.byref(fval),
                    ctypes.byref(data), ctypes.byref(nbytes), shape,
                    ctypes.byref(ndim), dtype)
                if kind < 0:
                    raise RuntimeError(f"native scene loader: {path}: "
                                       f"frame {t} entry {i} unreadable")
                name = ctypes.string_at(key.value, key_len.value).decode()
                raw = ctypes.string_at(data.value, nbytes.value) \
                    if nbytes.value else b""
                if kind in (ARRAY, SCALAR):
                    arr = np.frombuffer(raw, np.dtype(dtype.value.decode()))
                    frame[name] = arr.reshape(
                        [shape[d] for d in range(ndim.value)]).copy() \
                        if kind == ARRAY else arr[0]
                elif kind == INT:
                    frame[name] = ival.value
                elif kind == BOOL:
                    frame[name] = bool(ival.value)
                elif kind == FLOAT:
                    frame[name] = fval.value
                elif kind == STR:
                    frame[name] = raw.decode()
                elif kind == BIN:
                    frame[name] = raw
                elif kind == NIL:
                    frame[name] = None
                else:
                    raise ValueError(
                        f"native scene loader: {path}: frame {t} key "
                        f"{name!r} holds a list or a plain map, which the "
                        f"loader does not decode")
            frames.append(frame)
        return frames
    finally:
        lib.scene_close(h)
