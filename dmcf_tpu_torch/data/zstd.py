"""zstd frames through the system's ``libzstd.so.1`` (ctypes; no Python
``zstandard`` and no ``zstd.h``).

``compress`` makes one frame with its content size in the header
(``ZSTD_compress`` writes it), so python-zstandard's one-shot
``ZstdDecompressor().decompress`` reads it; ``decompress`` reads one
frame that gives its content size, as that reader does, and raises
``ValueError`` on a frame that does not (written by a streaming
compressor), where python-zstandard raises its ``ZstdError``.  The bytes
need not equal python-zstandard's, which bundles its own libzstd: both
read each other's frames.  The library is opened at the first call,
never at import; when it is missing the call raises ``OSError`` naming
it.  It is opened with ``RTLD_DEEPBIND``, so its calls into itself bind
to its own functions even where another library loaded into the process
with global symbols carries a zstd of its own (TensorFlow's
``libtensorflow_framework`` does: without it the two versions' internals
mix and ``ZSTD_compress`` crashes).  Opened first by someone else
without that flag it would keep the other bindings, so the native scene
loader opens it here before its own library.
"""

from __future__ import annotations

import ctypes
import os

LIBRARY = "libzstd.so.1"
# ZSTD_getFrameContentSize's sentinels (unsigned long long)
CONTENTSIZE_UNKNOWN = (1 << 64) - 1
CONTENTSIZE_ERROR = (1 << 64) - 2

_lib = None


def load_library():
    """The library's ctypes handle, opened on first use (``RTLD_DEEPBIND``:
    see the module docstring).  Code that loads another library linked
    against ``libzstd.so.1`` calls this first, so that library finds it
    resident with its own bindings."""
    global _lib
    if _lib is not None:
        return _lib
    try:
        lib = ctypes.CDLL(LIBRARY, mode=os.RTLD_LOCAL | os.RTLD_DEEPBIND)
    except OSError as e:
        raise OSError(f"zstd: cannot load {LIBRARY} (the zstd shared "
                      f"library): {e}") from e
    size_t, p = ctypes.c_size_t, ctypes.c_void_p
    lib.ZSTD_compressBound.argtypes = [size_t]
    lib.ZSTD_compressBound.restype = size_t
    lib.ZSTD_compress.argtypes = [p, size_t, p, size_t, ctypes.c_int]
    lib.ZSTD_compress.restype = size_t
    lib.ZSTD_decompress.argtypes = [p, size_t, p, size_t]
    lib.ZSTD_decompress.restype = size_t
    lib.ZSTD_getFrameContentSize.argtypes = [p, size_t]
    lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
    lib.ZSTD_isError.argtypes = [size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_getErrorName.argtypes = [size_t]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _checked(lib, code, what):
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd: {what}: "
                         f"{lib.ZSTD_getErrorName(code).decode()}")
    return code


def compress(data, level=22):
    """One zstd frame of ``data`` (bytes-like) at ``level``, its content
    size in the header."""
    lib = load_library()
    src = bytes(data)
    cap = _checked(lib, lib.ZSTD_compressBound(len(src)), "compress bound")
    dst = ctypes.create_string_buffer(max(cap, 1))
    n = _checked(lib, lib.ZSTD_compress(dst, cap, src, len(src),
                                        int(level)), "compress")
    return dst.raw[:n]


def decompress(data):
    """The content of one zstd frame (bytes-like) whose header gives its
    size.  Raises ValueError when the header gives none, is not a zstd
    header, or the frame does not decode to that size."""
    lib = load_library()
    src = bytes(data)
    size = lib.ZSTD_getFrameContentSize(src, len(src))
    if size == CONTENTSIZE_UNKNOWN:
        raise ValueError("zstd: the frame's header gives no content size")
    if size == CONTENTSIZE_ERROR:
        raise ValueError("zstd: not a zstd frame header")
    dst = ctypes.create_string_buffer(max(size, 1))
    n = _checked(lib, lib.ZSTD_decompress(dst, size, src, len(src)),
                 "decompress")
    if n != size:
        raise ValueError(f"zstd: the frame decoded to {n} bytes, its "
                         f"header says {size}")
    return dst.raw[:n]
