"""zstd through the system's `libzstd.so.1`, bound with ctypes.

The Orbax checkpoints of the JAX package compress their OCDBT files and
their zarr chunks with zstd (`utils/ocdbt.py`, `utils/orbax_ckpt.py`).
The port reads and writes them through the C library that Ubuntu's
`libzstd1` package installs (a dependency of apt, so on every Ubuntu
image; the H100's machine has 1.5.5), and through no Python package:
`zstandard` is not installed there.  This is the one route, on every
machine; a machine without the library raises when a checkpoint is first
compressed or decompressed.  A ctypes call releases the GIL, so threads
compress and decompress leaves side by side.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

_CONTENTSIZE_UNKNOWN = 2**64 - 1
_CONTENTSIZE_ERROR = 2**64 - 2


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


_LIB = None
_LIB_LOCK = threading.Lock()


def _lib():
    """libzstd, loaded and declared at first use."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            # its own symbols first: a library loaded before it with zstd linked in
            # and exported (TensorFlow's framework library is one) would
            # otherwise take the calls libzstd makes to itself
            lib = ctypes.CDLL("libzstd.so.1", mode=os.RTLD_LOCAL | os.RTLD_DEEPBIND)
            size_t, vp = ctypes.c_size_t, ctypes.c_void_p
            for name, res, args in (
                    ("ZSTD_versionNumber", ctypes.c_uint, []),
                    ("ZSTD_compressBound", size_t, [size_t]),
                    ("ZSTD_compress", size_t, [vp, size_t, vp, size_t, ctypes.c_int]),
                    ("ZSTD_decompress", size_t, [vp, size_t, vp, size_t]),
                    ("ZSTD_getFrameContentSize", ctypes.c_ulonglong, [vp, size_t]),
                    ("ZSTD_isError", ctypes.c_uint, [size_t]),
                    ("ZSTD_getErrorName", ctypes.c_char_p, [size_t]),
                    ("ZSTD_createDCtx", vp, []),
                    ("ZSTD_freeDCtx", size_t, [vp]),
                    ("ZSTD_decompressStream", size_t,
                     [vp, ctypes.POINTER(_OutBuffer), ctypes.POINTER(_InBuffer)])):
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = res, args
            _LIB = lib
    return _LIB


def version() -> int:
    """The library's version number (10505 for 1.5.5)."""
    return _lib().ZSTD_versionNumber()


def _check(lib, rc: int, what: str) -> int:
    if lib.ZSTD_isError(rc):
        raise ValueError(f"zstd {what}: {lib.ZSTD_getErrorName(rc).decode()}")
    return rc


def _src(data):
    """(pointer, size, keep-alive) of a bytes-like object."""
    mv = memoryview(data).cast("B")
    if mv.readonly:
        buf = ctypes.c_char_p(mv.tobytes() if not isinstance(data, bytes) else data)
        return ctypes.cast(buf, ctypes.c_void_p), mv.nbytes, buf
    arr = (ctypes.c_char * mv.nbytes).from_buffer(mv)
    return ctypes.addressof(arr), mv.nbytes, arr


def compress(data, level: int = 1) -> memoryview:
    """One zstd frame of `data` (bytes-like), its content size recorded,
    as a bytes-like view of a buffer of its own."""
    lib = _lib()
    src, n, keep = _src(data)
    out = np.empty(lib.ZSTD_compressBound(n), np.uint8)
    rc = _check(lib, lib.ZSTD_compress(out.ctypes.data, out.nbytes, src, n, level), "compress")
    del keep
    return memoryview(out[:rc])


def decompress(data) -> bytes:
    """The bytes of the zstd frame `data`: to its recorded content size,
    else (tensorstore records none) decoded as a stream."""
    lib = _lib()
    src, n, keep = _src(data)
    size = lib.ZSTD_getFrameContentSize(src, n)
    if size == _CONTENTSIZE_ERROR:
        raise ValueError("zstd decompress: not a zstd frame")
    if size == _CONTENTSIZE_UNKNOWN:
        return _decompress_stream(lib, src, n)
    out = ctypes.create_string_buffer(max(size, 1))
    rc = _check(lib, lib.ZSTD_decompress(out, size, src, n), "decompress")
    del keep
    if rc != size:
        raise ValueError(f"zstd decompress: {rc} bytes, expected {size}")
    return out.raw[:size]


def decompress_into(data, out) -> None:
    """Decode the zstd frame `data` into the writable buffer `out` (a
    numpy array's memory, say), which it must fill exactly."""
    lib = _lib()
    src, n, keep = _src(data)
    dst = memoryview(out).cast("B")
    arr = (ctypes.c_char * dst.nbytes).from_buffer(dst)
    rc = _check(lib, lib.ZSTD_decompress(arr, dst.nbytes, src, n), "decompress")
    del keep, arr
    if rc != dst.nbytes:
        raise ValueError(f"zstd decompress: {rc} bytes, expected {dst.nbytes}")


def _decompress_stream(lib, src, n: int) -> bytes:
    """A frame without a recorded content size (tensorstore writes those),
    decoded in steps into a buffer that doubles as it fills."""
    dctx = lib.ZSTD_createDCtx()
    if not dctx:
        raise MemoryError("ZSTD_createDCtx")
    try:
        inb = _InBuffer(src, n, 0)
        chunks, cap = [], max(4 * n, 1 << 16)
        while True:
            buf = ctypes.create_string_buffer(cap)
            outb = _OutBuffer(ctypes.addressof(buf), cap, 0)
            rc = _check(lib, lib.ZSTD_decompressStream(dctx, ctypes.byref(outb), ctypes.byref(inb)),
                        "decompress")
            chunks.append(buf.raw[:outb.pos])
            if inb.pos == n and rc == 0:
                return b"".join(chunks)
            if inb.pos == n and outb.pos < cap:
                raise ValueError("zstd decompress: truncated frame")
            if outb.pos == cap:
                cap *= 2
    finally:
        lib.ZSTD_freeDCtx(dctx)
