"""Image files: read, write and size, without OpenCV or PIL.

One image path for the whole port.  JPEG takes one of two codecs,
chosen by `jpeg_codec()`:

- "libjpeg": the system's libjpeg through the port's host library
  (`dmayolo_tpu_torch/csrc/host/imgio.cpp`, built with g++ at first use;
  its JPEG codec is compiled in only where `<jpeglib.h>` exists), the
  same pixels as `cv2.imread`;
- "nvjpeg": where the system has no libjpeg, the CUDA toolkit's nvJPEG
  (`csrc/host/nvjpeg_codec.cpp`, built with g++ at first use where the
  toolkit has `nvjpeg.h`), which needs a CUDA device.  It decodes on the
  card and returns host arrays like the other route.  Its pixels need
  not be libjpeg's: the two libraries may round the IDCT and upsample
  chroma differently (libjpeg-turbo's "fancy" upsampling).  nvJPEG does
  not take CMYK, 12-bit or arithmetic-coded JPEG: those raise, naming
  their kind.

No route falls back on another: a failed build or call raises.  PNG is
parsed here: zlib from Python's standard library, the row filters in the
host library.  Other formats of `IMG_FORMATS` raise, naming the format.

`imread` and `imdecode` return BGR uint8 (H, W, 3), as `cv2.imread` does:
grey images are replicated to three channels, alpha is dropped, 16-bit
samples keep their high byte.  Every call into either library releases
the GIL.
"""
from __future__ import annotations

import ctypes
import functools
import struct
import zlib
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from ..utils import cuda_build

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
    so = cuda_build.load_host_library("imgio")
    i, l, d, p = ctypes.c_int, ctypes.c_long, ctypes.POINTER(ctypes.c_double), _u8p
    ip = ctypes.POINTER(ctypes.c_int)
    sigs = {
        "io_jpeg_probe": ([p, ctypes.c_ulong, ip], i),
        "io_jpeg_decode": ([p, ctypes.c_ulong, p, i, i, i], i),
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
        "io_rectangle": ([p, i, i, i, i, i, i, i, i, p], None),
        "io_put_text": ([p, i, i, i, ctypes.c_char_p, i, i, ctypes.c_double, i, p], None),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(so, name)
        fn.argtypes, fn.restype = args, res
    return so


@functools.lru_cache(maxsize=None)
def nvlib() -> ctypes.CDLL:
    """The nvJPEG codec, built on first use, its thread's handle made."""
    so = cuda_build.load_nvjpeg_library()
    p, i, l = _u8p, ctypes.c_int, ctypes.c_long
    sigs = {
        "nvj_init": ([], i),
        "nvj_decode": ([p, ctypes.c_ulong, p, i, i], i),
        "nvj_encode": ([p, i, i, i, p, l, ctypes.POINTER(l)], i),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(so, name)
        fn.argtypes, fn.restype = args, res
    _nv_check(so.nvj_init(), "nvJPEG")
    return so


def jpeg_codec() -> str:
    """The JPEG route of this machine: "libjpeg" where the system has
    `<jpeglib.h>`, else "nvjpeg" where the CUDA toolkit has `nvjpeg.h` and
    a CUDA device is present.  Raises where neither is."""
    if cuda_build.has_header("jpeglib.h"):
        return "libjpeg"
    if cuda_build.nvjpeg_header() and torch.cuda.is_available():
        return "nvjpeg"
    raise RuntimeError("JPEG needs either <jpeglib.h> and libjpeg (the host library's route) "
                       "or the CUDA toolkit's nvJPEG (include/nvjpeg.h) and a CUDA device; "
                       "this machine has neither")


def jpeg_available() -> bool:
    """Whether JPEG can be read and written here (by either route)."""
    try:
        jpeg_codec()
    except RuntimeError:
        return False
    return True


def _ext(path) -> str:
    return str(path).rsplit(".", 1)[-1].lower()


# --------------------------------------------------------------------- JPEG
# frame markers (SOFn) by the coding they name; C4, C8 and CC are not frames
_SOF_KINDS = {0xC0: "baseline", 0xC1: "extended sequential", 0xC2: "progressive",
              0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical progressive",
              0xC7: "hierarchical lossless", 0xC9: "arithmetic-coded",
              0xCA: "progressive arithmetic-coded", 0xCB: "lossless arithmetic-coded",
              0xCD: "hierarchical arithmetic-coded",
              0xCE: "hierarchical progressive arithmetic-coded",
              0xCF: "hierarchical lossless arithmetic-coded"}


def jpeg_frame(buf: bytes, path):
    """The JPEG's frame header: (coding, sample precision in bits, height,
    width, components), from the first SOFn marker; raises ValueError
    naming `path` when there is none before the scan."""
    pos, n = 2, len(buf)
    while pos + 4 <= n:
        if buf[pos] != 0xFF:
            break
        marker = buf[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        if marker in (0x01, *range(0xD0, 0xD8)):  # no length
            pos += 2
            continue
        if marker in (0xD9, 0xDA):  # end of image, or the scan before any frame
            break
        length = struct.unpack(">H", buf[pos + 2:pos + 4])[0]
        if marker in _SOF_KINDS:
            if pos + 10 > n:
                break
            precision, h, w, comps = struct.unpack(">BHHB", buf[pos + 4:pos + 10])
            return _SOF_KINDS[marker], precision, h, w, comps
        pos += 2 + length
    raise ValueError(f"{path}: not a readable JPEG (no frame header)")


def nvjpeg_unsupported(frame) -> str:
    """The kind of a JPEG frame (from `jpeg_frame`) that nvJPEG does not
    take, or "" when it takes it."""
    coding, precision, _, _, comps = frame
    if precision != 8:
        return f"{precision}-bit"
    if "arithmetic" in coding:
        return coding
    if coding not in ("baseline", "extended sequential", "progressive"):
        return coding
    if comps == 4:
        return "CMYK"
    if comps not in (1, 3):
        return f"{comps}-component"
    return ""


# nvjpegStatus_t, by value (nvjpeg.h)
_NV_STATUS = {1: "not initialized", 2: "invalid parameter", 3: "bad JPEG",
              4: "JPEG not supported", 5: "allocator failure", 6: "execution failed",
              7: "architecture mismatch", 8: "internal error",
              9: "implementation not supported", 10: "incomplete bitstream"}
_NV_CUDA_BASE, _NV_SHAPE, _NV_TOO_SMALL = 1000, 2001, 2002


def _nv_check(rc: int, path) -> None:
    if rc == 0:
        return
    if rc in (3, 10):
        raise ValueError(f"{path}: corrupt JPEG (nvJPEG: {_NV_STATUS[rc]})")
    if rc == _NV_SHAPE:
        raise ValueError(f"{path}: corrupt JPEG (nvJPEG reads another size than its header)")
    what = (f"CUDA error {rc - _NV_CUDA_BASE}" if _NV_CUDA_BASE <= rc < _NV_SHAPE
            else _NV_STATUS.get(rc, f"status {rc}"))
    raise RuntimeError(f"{path}: nvJPEG failed: {what}")


def _jpeg_decode(buf: bytes, path, fancy: bool = True) -> np.ndarray:
    """`fancy=False` (libjpeg's route only) upsamples 4:2:0 chroma by
    replication, as nvJPEG does: the reference nvJPEG's pixels are held to."""
    src = np.frombuffer(buf, np.uint8)
    if jpeg_codec() == "nvjpeg":
        frame = jpeg_frame(buf, path)
        kind = nvjpeg_unsupported(frame)
        if kind:
            raise ValueError(f"{path}: {kind} JPEG is not supported by nvJPEG")
        h, w = frame[2], frame[3]
        out = np.empty((h, w, 3), np.uint8)
        _nv_check(nvlib().nvj_decode(_ptr(src), len(buf), _ptr(out), h, w), path)
        return out
    io = lib()
    dims = (ctypes.c_int * 2)()
    if io.io_jpeg_probe(_ptr(src), len(buf), dims) != 0:
        raise ValueError(f"{path}: not a readable JPEG")
    out = np.empty((dims[0], dims[1], 3), np.uint8)
    if io.io_jpeg_decode(_ptr(src), len(buf), _ptr(out), dims[0], dims[1], int(fancy)) != 0:
        raise ValueError(f"{path}: corrupt JPEG")
    return out


def _jpeg_encode(img: np.ndarray, quality: int, path) -> bytes:
    h, w = img.shape[:2]
    cap = h * w * 3 + (1 << 16)
    nv = jpeg_codec() == "nvjpeg"
    for _ in range(2):
        out = np.empty(cap, np.uint8)
        if nv:
            n = ctypes.c_long(0)
            rc = nvlib().nvj_encode(_ptr(img), h, w, int(quality), _ptr(out), cap,
                                    ctypes.byref(n))
            if rc == _NV_TOO_SMALL:
                cap = n.value
                continue
            _nv_check(rc, path)
            return out[:n.value].tobytes()
        n = lib().io_jpeg_encode(_ptr(img), h, w, int(quality), _ptr(out), cap)
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


def imdecode(buf: bytes) -> np.ndarray:
    """Encoded image bytes (JPEG or PNG) as BGR uint8 (H, W, 3), as
    `cv2.imdecode(..., IMREAD_COLOR)`; raises ValueError when they cannot
    be read."""
    buf = bytes(buf)
    if buf[:3] == JPEG_SIG:
        return _jpeg_decode(buf, "<buffer>")
    if buf[:8] == PNG_SIG:
        return _png_decode(buf, "<buffer>")
    raise ValueError("<buffer>: not a JPEG or PNG image")


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
            buf = head + f.read()
            if jpeg_codec() == "nvjpeg":
                return tuple(jpeg_frame(buf, path)[2:4])
            src = np.frombuffer(buf, np.uint8)
            dims = (ctypes.c_int * 2)()
            if lib().io_jpeg_probe(_ptr(src), len(buf), dims) != 0:
                raise ValueError(f"{path}: not a readable JPEG")
            return int(dims[0]), int(dims[1])
    if head[:8] == PNG_SIG:
        w, h = _png_header(head, path)[:2]
        return int(h), int(w)
    raise ValueError(f"{path}: format {_ext(path)!r} is not supported by the port's image reader")
