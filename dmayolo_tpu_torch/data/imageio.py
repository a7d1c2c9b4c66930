"""Image files: read, write and size, without OpenCV or PIL.

One image path for the whole port.  JPEG is decoded and encoded by the
system's libjpeg through the port's host library
(`dmayolo_tpu_torch/csrc/host/imgio.cpp`, built with g++ at first use;
the JPEG codec is compiled in only where `<jpeglib.h>` exists).  PNG is
parsed here: zlib from Python's standard library, the row filters in the
host library.  Other formats of `IMG_FORMATS` raise, naming the format.

`imread` returns BGR uint8 (H, W, 3), as `cv2.imread` does: grey images
are replicated to three channels, alpha is dropped, 16-bit samples keep
their high byte.  Every call into the host library releases the GIL.
"""
from __future__ import annotations

import ctypes
import functools
import struct
import zlib
from pathlib import Path
from typing import Tuple

import numpy as np

from ..utils.cuda_build import load_host_library

IMG_FORMATS = {"bmp", "jpg", "jpeg", "png", "tif", "tiff", "dng", "webp", "mpo"}
PNG_SIG = b"\x89PNG\r\n\x1a\n"
JPEG_SIG = b"\xff\xd8\xff"
PNG_LEVEL = 1  # zlib level of written PNGs (cv2's default)
JPEG_QUALITY = 95  # cv2's default

_u8p = ctypes.POINTER(ctypes.c_uint8)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The host library, built on first use, with its signatures declared."""
    so = load_host_library("imgio")
    i, l, d, p = ctypes.c_int, ctypes.c_long, ctypes.POINTER(ctypes.c_double), _u8p
    ip = ctypes.POINTER(ctypes.c_int)
    sigs = {
        "io_has_jpeg": ([], i),
        "io_jpeg_probe": ([p, ctypes.c_ulong, ip], i),
        "io_jpeg_decode": ([p, ctypes.c_ulong, p, i, i], i),
        "io_jpeg_encode": ([p, i, i, i, p, l], l),
        "io_png_unfilter": ([p, i, l, i], i),
        "io_png_filter_bgr": ([p, i, i, p], None),
        "io_swap_rb": ([p, p, l], None),
        "io_resize_linear": ([p, i, i, p, i, i, i], None),
        "io_resize_area": ([p, i, i, p, i, i, i], None),
        "io_warp": ([p, i, i, p, i, i, i, d, i, i], None),
        "io_bgr2hsv": ([p, p, l], None),
        "io_hsv2bgr": ([p, p, l], None),
        "io_hsv_lut": ([p, l, p, p, p], None),
        "io_median": ([p, i, i, i, i, p], None),
        "io_line": ([p, i, i, i, i, i, i, i, p], None),
        "io_fill_poly": ([p, i, i, i, ip, i, p], None),
        "io_fill_circle": ([p, i, i, i, i, i, i, p], None),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(so, name)
        fn.argtypes, fn.restype = args, res
    return so


def jpeg_available() -> bool:
    """Whether the host library was built with the JPEG codec."""
    return bool(lib().io_has_jpeg())


def _no_jpeg(path) -> RuntimeError:
    return RuntimeError(f"{path}: JPEG needs <jpeglib.h> and libjpeg, which this machine "
                        "lacks; the host library was built without JPEG")


def _ext(path) -> str:
    return str(path).rsplit(".", 1)[-1].lower()


# --------------------------------------------------------------------- JPEG
def _jpeg_decode(buf: bytes, path) -> np.ndarray:
    io = lib()
    if not io.io_has_jpeg():
        raise _no_jpeg(path)
    src = np.frombuffer(buf, np.uint8)
    dims = (ctypes.c_int * 2)()
    if io.io_jpeg_probe(_ptr(src), len(buf), dims) != 0:
        raise ValueError(f"{path}: not a readable JPEG")
    out = np.empty((dims[0], dims[1], 3), np.uint8)
    if io.io_jpeg_decode(_ptr(src), len(buf), _ptr(out), dims[0], dims[1]) != 0:
        raise ValueError(f"{path}: corrupt JPEG")
    return out


def _jpeg_encode(img: np.ndarray, quality: int, path) -> bytes:
    io = lib()
    if not io.io_has_jpeg():
        raise _no_jpeg(path)
    h, w = img.shape[:2]
    cap = h * w * 3 + (1 << 16)
    for _ in range(2):
        out = np.empty(cap, np.uint8)
        n = io.io_jpeg_encode(_ptr(img), h, w, int(quality), _ptr(out), cap)
        if n > 0:
            return out[:n].tobytes()
        if n == 0:
            raise ValueError(f"{path}: JPEG encode failed")
        cap = -n
    raise ValueError(f"{path}: JPEG encode failed")


# ---------------------------------------------------------------------- PNG
def _png_chunks(buf: bytes, path):
    if buf[:8] != PNG_SIG:
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    while pos + 8 <= len(buf):
        length, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        yield kind, buf[pos + 8:pos + 8 + length]
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: truncated PNG")


def _png_header(buf: bytes, path):
    kind, body = next(_png_chunks(buf, path))
    if kind != b"IHDR":
        raise ValueError(f"{path}: PNG without IHDR")
    return struct.unpack(">IIBBBBB", body)  # w, h, depth, colour, comp, filter, interlace


_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_decode(buf: bytes, path) -> np.ndarray:
    w, h, depth, colour, _, _, interlace = _png_header(buf, path)
    if colour not in _PNG_CHANNELS or depth not in (8, 16) or (colour == 3 and depth != 8):
        raise ValueError(f"{path}: PNG colour type {colour} at bit depth {depth} is not supported")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    idat, palette = [], None
    for kind, body in _png_chunks(buf, path):
        if kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
    ch = _PNG_CHANNELS[colour]
    bpp = ch * depth // 8
    rowbytes = w * bpp
    raw = np.frombuffer(bytearray(zlib.decompress(b"".join(idat))), np.uint8)
    if raw.size != h * (rowbytes + 1):
        raise ValueError(f"{path}: PNG data of {raw.size} bytes, expected {h * (rowbytes + 1)}")
    if lib().io_png_unfilter(_ptr(raw), h, rowbytes, bpp) != 0:
        raise ValueError(f"{path}: PNG row filter unknown")
    px = raw[:h * rowbytes].reshape(h, w, bpp)
    if depth == 16:
        px = px[..., 0::2]  # big-endian samples: the high byte
    if colour == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        px = palette[px[..., 0]]
    elif colour in (0, 4):
        return np.ascontiguousarray(np.repeat(px[..., :1], 3, axis=2))
    rgb = np.ascontiguousarray(px[..., :3])
    out = np.empty_like(rgb)
    lib().io_swap_rb(_ptr(rgb), _ptr(out), h * w)
    return out


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _png_encode(img: np.ndarray) -> bytes:
    h, w = img.shape[:2]
    rows = np.empty(h * (3 * w + 1), np.uint8)
    lib().io_png_filter_bgr(_ptr(img), h, w, _ptr(rows))
    return (PNG_SIG + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows, PNG_LEVEL)) + _png_chunk(b"IEND", b""))


# ------------------------------------------------------------------- public
def _decode(buf: bytes, path) -> np.ndarray:
    """An encoded image (JPEG or PNG, by its signature) -> BGR uint8."""
    if buf[:3] == JPEG_SIG:
        return _jpeg_decode(buf, path)
    if buf[:8] == PNG_SIG:
        return _png_decode(buf, path)
    raise ValueError(f"{path}: format {_ext(path)!r} is not supported by the port's "
                     "image reader (JPEG and PNG are)")


def imread(path) -> np.ndarray:
    """The image file at `path` as BGR uint8 (H, W, 3); raises when it
    cannot be read."""
    with open(path, "rb") as f:
        return _decode(f.read(), path)


def imwrite(path, img: np.ndarray, quality: int = JPEG_QUALITY) -> None:
    """Write BGR uint8 (H, W, 3) as JPEG (`.jpg`/`.jpeg`, at `quality`) or
    PNG (`.png`), by the file's extension."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"imwrite takes (H, W, 3) uint8, got {img.shape}")
    ext = _ext(path)
    if ext in ("jpg", "jpeg"):
        data = _jpeg_encode(img, quality, path)
    elif ext == "png":
        data = _png_encode(img)
    else:
        raise ValueError(f"{path}: format {ext!r} is not supported by the port's image writer")
    Path(path).write_bytes(data)


def image_shape(path) -> Tuple[int, int]:
    """(height, width) from the file's header, without decoding."""
    with open(path, "rb") as f:
        head = f.read(1 << 16)
        if head[:3] == JPEG_SIG:
            io = lib()
            if not io.io_has_jpeg():
                raise _no_jpeg(path)
            buf = head + f.read()
            src = np.frombuffer(buf, np.uint8)
            dims = (ctypes.c_int * 2)()
            if io.io_jpeg_probe(_ptr(src), len(buf), dims) != 0:
                raise ValueError(f"{path}: not a readable JPEG")
            return int(dims[0]), int(dims[1])
    if head[:8] == PNG_SIG:
        w, h = _png_header(head, path)[:2]
        return int(h), int(w)
    raise ValueError(f"{path}: format {_ext(path)!r} is not supported by the port's image reader")
