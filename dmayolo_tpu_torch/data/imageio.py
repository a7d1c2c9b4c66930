"""Image files: read, write and size.

One image path for the whole port.  Each file is read by its signature,
not its extension (a `.jpg` holding PNG bytes reads as PNG, as in cv2).
One rule: what the port's host library has a codec for, it decodes.
JPEG (and MPO, whose first image is a JPEG) takes one of two codecs,
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

No route falls back on another: a failed build or call raises.  PNG, BMP
and TIFF are parsed here; zlib (PNG's IDAT, TIFF's deflate) from
Python's standard library; the PNG row filters, the BMP row unpacking and
TIFF's LZW, PackBits and predictor in the host library.  BMP: 1/4/8-bit
palette, 16-bit 5-5-5 and 5-6-5, 24 and 32 bits, either row order; TIFF:
the first IFD, either byte order, strips or tiles, 8- or 16-bit grey,
RGB(A) or palette, compression none, LZW, deflate or PackBits.  A DNG is
read as its first IFD, a TIFF, as cv2's libtiff reads it (a raw CFA or
JPEG-compressed IFD0 raises, naming what it holds).

webp has no codec here that could match libwebp's: it is read and
written through OpenCV's (`_cv2()`, imported lazily, in that one
function), as the JAX package reads and writes it with `cv2.imread` and
`cv2.imwrite`; `image_shape` reads its size from the VP8, VP8L or VP8X
header.  Video goes the same way (`data/video.py`).  `imwrite` writes
JPEG, PNG, 24-bit BMP, LZW TIFF and webp.

`imread` and `imdecode` return BGR uint8 (H, W, 3), as `cv2.imread` does:
grey images are replicated to three channels, alpha is dropped, 16-bit
samples keep their high byte (PNG, grey TIFF) or are scaled (colour
TIFF), and the EXIF orientation (a JPEG's APP1, a PNG's eXIf, a TIFF's
tag 274, a webp's EXIF chunk) is applied.  Every call into the host
library releases the GIL.
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
        "io_orient": ([p, i, i, i, i, p], None),
        "io_bmp_unpack": ([p, i, i, i, l, i, p, i, p], None),
        "io_lzw_decode": ([p, l, p, l], l),
        "io_lzw_encode": ([p, l, p, l], l),
        "io_packbits_decode": ([p, l, p, l], l),
        "io_tiff_predictor": ([p, l, l, i, i, i], None),
        "io_resize_linear": ([p, i, i, p, i, i, i], None),
        "io_resize_area": ([p, i, i, p, i, i, i], None),
        "io_warp": ([p, i, i, p, i, i, i, d, i, i], None),
        "io_bgr2hsv": ([p, p, l], None),
        "io_hsv2bgr": ([p, p, l], None),
        "io_hsv_lut": ([p, l, p, p, p], None),
        "io_bgr2lab": ([p, p, l], None),
        "io_lab2bgr": ([p, p, l], None),
        "io_clahe": ([p, i, i, ctypes.c_double, i, p], None),
        "io_median": ([p, i, i, i, i, p], None),
        "io_line": ([p, i, i, i, i, i, i, i, p], None),
        "io_fill_poly": ([p, i, i, i, ip, i, p], None),
        "io_fill_circle": ([p, i, i, i, i, i, i, p], None),
        "io_rectangle": ([p, i, i, i, i, i, i, i, i, p], None),
        "io_polyline_aa": ([p, i, i, i, ip, i, i, i, p], None),
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


def _cv2():
    """OpenCV, imported here and nowhere else in the port: webp and video
    are decoded and encoded by it, as the JAX package does.  Raises,
    naming the need, where it is not installed."""
    try:
        import cv2
    except ImportError as err:
        raise RuntimeError("video and webp need OpenCV's decoder, as the JAX package's "
                           f"cv2.imread / VideoCapture; cv2 is not installed ({err})") from None
    return cv2


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


# -------------------------------------------------------------- orientation
def _exif_orientation(tiff: bytes) -> int:
    """Tag 0x0112 of IFD0 of a TIFF-structured EXIF block (either byte
    order): 1-8, or 1 where it is absent, unreadable or out of range."""
    endian = {b"II": "<", b"MM": ">"}.get(bytes(tiff[:2]))
    if endian is None or len(tiff) < 8:
        return 1
    ifd = struct.unpack(endian + "I", tiff[4:8])[0]
    if ifd + 2 > len(tiff):
        return 1
    for k in range(struct.unpack(endian + "H", tiff[ifd:ifd + 2])[0]):
        e = ifd + 2 + 12 * k
        if e + 12 > len(tiff):
            break
        tag, typ = struct.unpack(endian + "HH", tiff[e:e + 4])
        if tag == 0x0112:
            v = (struct.unpack(endian + "H", tiff[e + 8:e + 10])[0] if typ == 3
                 else struct.unpack(endian + "I", tiff[e + 8:e + 12])[0] if typ == 4 else 1)
            return v if 1 <= v <= 8 else 1
    return 1


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """`img` under an EXIF orientation, as cv2.imread applies it."""
    if orientation == 1:
        return img
    h, w, c = img.shape
    out = np.empty((w, h, c) if orientation >= 5 else (h, w, c), np.uint8)
    lib().io_orient(_ptr(np.ascontiguousarray(img)), h, w, c, orientation, _ptr(out))
    return out


def _jpeg_markers(buf: bytes):
    """(marker, payload) of each segment before the first scan."""
    pos, n = 2, len(buf)
    while pos + 4 <= n and buf[pos] == 0xFF:
        marker = buf[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker in (0x01, *range(0xD0, 0xD8)):
            pos += 2
            continue
        if marker in (0xD9, 0xDA):
            return
        length = struct.unpack(">H", buf[pos + 2:pos + 4])[0]
        yield marker, buf[pos + 4:pos + 2 + length]
        pos += 2 + length


def _jpeg_meta(buf: bytes):
    """(EXIF orientation, whether an MPF segment marks more images after the
    first, as MPO files hold), from the segments before the first scan."""
    orientation, mpo = 1, False
    for marker, body in _jpeg_markers(buf):
        if marker == 0xE1 and body[:6] == b"Exif\0\0" and orientation == 1:
            orientation = _exif_orientation(body[6:])
        elif marker == 0xE2 and body[:4] == b"MPF\0":
            mpo = True
    return orientation, mpo


def _jpeg_first_image(buf: bytes) -> bytes:
    """The bytes of the first image of a multi-image JPEG stream (an MPO),
    through its end-of-image marker."""
    pos, n = 2, len(buf)
    while pos + 2 <= n:
        if buf[pos] != 0xFF:
            break
        marker = buf[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker == 0xD9:
            return buf[:pos + 2]
        if marker in (0x01, *range(0xD0, 0xD8)):
            pos += 2
            continue
        pos += 2 + struct.unpack(">H", buf[pos + 2:pos + 4])[0]
        if marker == 0xDA:  # entropy-coded data, to the next marker
            while True:
                pos = buf.find(b"\xff", pos)
                if pos < 0 or pos + 1 >= n:
                    return buf
                nxt = buf[pos + 1]
                if nxt == 0 or 0xD0 <= nxt <= 0xD7:
                    pos += 2
                elif nxt == 0xFF:
                    pos += 1
                else:
                    break
    return buf


def _png_orientation(buf: bytes, path) -> int:
    for kind, body in _png_chunks(buf, path):
        if kind == b"eXIf":
            return _exif_orientation(body[6:] if body[:6] == b"Exif\0\0" else body)
        if kind == b"IDAT":
            return 1
    return 1


# ---------------------------------------------------------------------- BMP
BMP_SIG = b"BM"
_BMP_COMPRESSION = {1: "RLE8", 2: "RLE4", 4: "JPEG", 5: "PNG", 6: "alpha bitfields"}


def _bmp_header(buf: bytes, path):
    """(height, width, bits a pixel, top-down, compression, header size)."""
    if len(buf) < 26 or buf[:2] != BMP_SIG:
        raise ValueError(f"{path}: not a BMP")
    hs = struct.unpack("<I", buf[14:18])[0]
    if hs == 12:  # OS/2 core header
        w, h, _, bpp = struct.unpack("<HhHH", buf[18:26])
        comp = 0
    elif hs >= 40 and len(buf) >= 54:
        w, h, _, bpp, comp = struct.unpack("<iiHHI", buf[18:34])
    else:
        raise ValueError(f"{path}: BMP header of {hs} bytes is not supported")
    return abs(h), w, bpp, h < 0, comp, hs


def _bmp_decode(buf: bytes, path) -> np.ndarray:
    h, w, bpp, top_down, comp, hs = _bmp_header(buf, path)
    if comp not in (0, 3):
        raise ValueError(f"{path}: {_BMP_COMPRESSION.get(comp, comp)}-compressed BMP is not "
                         "supported")
    if bpp not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"{path}: BMP of {bpp} bits a pixel is not supported")
    mode = 0
    if bpp == 16 and comp == 3:
        r, g, b = struct.unpack("<III", buf[54:66])
        if (r, g, b) == (0xF800, 0x7E0, 0x1F):
            mode = 1
        elif (r, g, b) != (0x7C00, 0x3E0, 0x1F):
            raise ValueError(f"{path}: 16-bit BMP with masks {r:#x} {g:#x} {b:#x} is not supported")
    palette = np.zeros((256, 3), np.uint8)
    if bpp <= 8:
        entry = 3 if hs == 12 else 4
        used = 0 if hs == 12 else struct.unpack("<I", buf[46:50])[0]
        n = min(used or 1 << bpp, 256)
        start = 14 + hs
        pal = np.frombuffer(buf[start:start + n * entry], np.uint8)
        n = pal.size // entry
        palette[:n] = pal[:n * entry].reshape(n, entry)[:, :3]
    stride = (w * bpp + 31) // 32 * 4
    off = struct.unpack("<I", buf[10:14])[0]
    if off + stride * h > len(buf):
        raise ValueError(f"{path}: truncated BMP")
    rows = np.frombuffer(buf, np.uint8, count=stride * h, offset=off)
    out = np.empty((h, w, 3), np.uint8)
    lib().io_bmp_unpack(_ptr(rows), h, w, bpp, stride, int(top_down), _ptr(palette), mode,
                        _ptr(out))
    return out


def _bmp_encode(img: np.ndarray) -> bytes:
    """24-bit bottom-up BI_RGB, as cv2.imwrite writes BMP."""
    h, w = img.shape[:2]
    stride = (3 * w + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = img[::-1].reshape(h, 3 * w)
    head = struct.pack("<2sIHHI", BMP_SIG, 54 + rows.size, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, 0, 0, 0, 0, 0)
    return head + info + rows.tobytes()


# --------------------------------------------------------------------- TIFF
TIFF_SIGS = (b"II*\0", b"MM\0*")
_TIFF_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i",
               10: "ii", 11: "f", 12: "d", 13: "I"}
_TIFF_COMPRESSION = {2: "CCITT RLE", 3: "CCITT fax 3", 4: "CCITT fax 4", 6: "old-style JPEG",
                     7: "JPEG", 34712: "JPEG 2000", 34887: "LERC", 34925: "LZMA",
                     50000: "ZSTD", 50001: "WebP", 32946: "deflate", 8: "deflate",
                     5: "LZW", 32773: "PackBits", 1: "none"}
_TIFF_DECODERS = {1, 5, 8, 32773, 32946}
DNG_VERSION = 50706  # the tag that makes a TIFF a DNG


def _tiff_ifd0(buf: bytes, path):
    """(byte order, {tag: values}) of the first IFD."""
    if buf[:4] not in TIFF_SIGS:
        raise ValueError(f"{path}: not a TIFF (BigTIFF is not supported)")
    e = "<" if buf[:2] == b"II" else ">"
    ifd = struct.unpack(e + "I", buf[4:8])[0]
    if ifd + 2 > len(buf):
        raise ValueError(f"{path}: truncated TIFF")
    tags = {}
    for k in range(struct.unpack(e + "H", buf[ifd:ifd + 2])[0]):
        pos = ifd + 2 + 12 * k
        tag, typ, count = struct.unpack(e + "HHI", buf[pos:pos + 8])
        fmt = _TIFF_TYPES.get(typ)
        if fmt is None:
            continue
        size = struct.calcsize(e + fmt) * count
        at = pos + 8 if size <= 4 else struct.unpack(e + "I", buf[pos + 8:pos + 12])[0]
        if at + size > len(buf):
            raise ValueError(f"{path}: truncated TIFF (tag {tag})")
        tags[tag] = struct.unpack(e + fmt * count, buf[at:at + size])
    return e, tags


def _tiff_geometry(tags, path):
    """(height, width, orientation) of the first IFD (a DNG's too)."""
    try:
        w, h = tags[256][0], tags[257][0]
    except KeyError:
        raise ValueError(f"{path}: TIFF without its size tags") from None
    o = tags.get(274, (1,))[0]
    return h, w, o if 1 <= o <= 8 else 1


def _tiff_inflate(data: bytes, comp: int, size: int, path) -> np.ndarray:
    """One strip or tile of `size` bytes, decompressed (short strips are
    zero-filled, as libtiff reads them)."""
    out = np.zeros(size, np.uint8)
    if comp == 1:
        raw = np.frombuffer(data[:size], np.uint8)
        out[:raw.size] = raw
    elif comp in (8, 32946):
        try:
            raw = np.frombuffer(zlib.decompress(data)[:size], np.uint8)
        except zlib.error as err:
            raise ValueError(f"{path}: corrupt deflate data ({err})") from None
        out[:raw.size] = raw
    else:
        src = np.frombuffer(data, np.uint8)
        fn = lib().io_lzw_decode if comp == 5 else lib().io_packbits_decode
        if fn(_ptr(src), src.size, _ptr(out), size) < 0:
            raise ValueError(f"{path}: corrupt {_TIFF_COMPRESSION[comp]} data")
    return out


def _tiff_decode(buf: bytes, path) -> np.ndarray:
    e, tags = _tiff_ifd0(buf, path)
    h, w, o = _tiff_geometry(tags, path)
    what = "DNG" if DNG_VERSION in tags else "TIFF"
    comp = tags.get(259, (1,))[0]
    if comp not in _TIFF_DECODERS:
        raise ValueError(f"{path}: {what} compression {comp} "
                         f"({_TIFF_COMPRESSION.get(comp, 'unknown')}) is not supported")
    if tags.get(284, (1,))[0] != 1:
        raise ValueError(f"{path}: TIFF planar configuration 2 (separate planes) is not supported")
    spp = tags.get(277, (1,))[0]
    bits = tags.get(258, (1,))
    photo = tags.get(262, (None,))[0]
    if len(set(bits)) != 1 or bits[0] not in (8, 16) or tags.get(339, (1,))[0] != 1:
        raise ValueError(f"{path}: TIFF samples of {bits} bits (format "
                         f"{tags.get(339, (1,))[0]}) are not supported")
    if photo not in (1, 2, 3) or (photo == 2 and spp < 3) or (photo == 3 and bits[0] != 8):
        raise ValueError(f"{path}: {what} photometric interpretation {photo} with {spp} samples "
                         f"of {bits[0]} bits is not supported")
    pred = tags.get(317, (1,))[0]
    if pred not in (1, 2):
        raise ValueError(f"{path}: TIFF predictor {pred} is not supported")
    nb = bits[0] // 8
    if 322 in tags:  # tiles
        tw, tl = tags[322][0], tags[323][0]
        offsets, counts = tags[324], tags[325]
        across = -(-w // tw)
        blocks = [((k // across) * tl, (k % across) * tw, tl, tw) for k in range(len(offsets))]
    else:
        rps = min(tags.get(278, (h,))[0], h)
        offsets = tags[273]
        counts = tags.get(279) or [len(buf) - o for o in offsets]
        blocks = [(k * rps, 0, min(rps, h - k * rps), w) for k in range(len(offsets))]
    px = np.zeros((h, w, spp * nb), np.uint8)
    for (y0, x0, rows, cols), off, cnt in zip(blocks, offsets, counts):
        if y0 >= h or x0 >= w:
            continue
        raw = _tiff_inflate(buf[off:off + cnt], comp, rows * cols * spp * nb, path)
        if nb == 2 and e == ">":
            raw = raw.reshape(-1, 2)[:, ::-1].copy().reshape(-1)  # to native (little) order
        if pred == 2:
            lib().io_tiff_predictor(_ptr(raw), rows, cols, spp, nb, 0)
        blk = raw.reshape(rows, cols, spp * nb)
        rh, rw = min(rows, h - y0), min(cols, w - x0)
        px[y0:y0 + rh, x0:x0 + rw] = blk[:rh, :rw]
    if nb == 2:  # 16-bit samples as cv2 takes them: grey keeps the high
        # byte, colour is scaled with rounding (v * 255 / 65535)
        v = px.view("<u2")
        px = ((v >> 8) if photo == 1 else (v.astype(np.uint32) * 255 + 32895) >> 16).astype(np.uint8)
    if photo == 3:
        cmap = np.asarray(tags[320], np.uint16).reshape(3, 256)
        lut = np.ascontiguousarray((cmap[::-1].T >> 8).astype(np.uint8))  # BGR rows
        img = lut[px[..., 0]]
    elif photo == 1:
        img = np.repeat(px[..., :1], 3, axis=2)
    else:
        rgb = np.ascontiguousarray(px[..., :3])
        img = np.empty_like(rgb)
        lib().io_swap_rb(_ptr(rgb), _ptr(img), h * w)
    return _orient(np.ascontiguousarray(img), o)


def _tiff_encode(img: np.ndarray) -> bytes:
    """Little-endian RGB, LZW with horizontal differencing (predictor 2), in
    strips of about 8 KB, as cv2.imwrite writes TIFF (through libtiff)."""
    h, w = img.shape[:2]
    rgb = np.empty_like(img)
    lib().io_swap_rb(_ptr(img), _ptr(rgb), h * w)
    rowbytes = 3 * w
    rps = max(1, 8192 // rowbytes)
    strips = []
    for y in range(0, h, rps):
        rows = np.ascontiguousarray(rgb[y:y + rps]).reshape(-1)
        n = rows.size // rowbytes
        lib().io_tiff_predictor(_ptr(rows), n, w, 3, 1, 1)
        out = np.empty(rows.size * 3 // 2 + 16, np.uint8)
        k = lib().io_lzw_encode(_ptr(rows), rows.size, _ptr(out), out.size)
        strips.append(out[:k].tobytes())
    data = b"".join(strips)
    offsets = np.cumsum([8] + [len(s) for s in strips[:-1]]).tolist()
    counts = [len(s) for s in strips]
    extra = 8 + len(data) + (len(data) & 1)  # out-of-line values follow the data
    blobs = b""

    def far(fmt, values):
        nonlocal blobs
        at = extra + len(blobs)
        blobs += struct.pack("<" + fmt * len(values), *values)
        return at

    def entry(tag, typ, values):
        fmt = "I" if typ == 5 else _TIFF_TYPES[typ]  # a rational is two LONGs
        if struct.calcsize("<" + fmt * len(values)) <= 4:
            val = struct.pack("<" + fmt * len(values), *values).ljust(4, b"\0")
        else:
            val = struct.pack("<I", far(fmt, values))
        return struct.pack("<HHI", tag, typ, len(values) // (2 if typ == 5 else 1)) + val

    entries = [entry(256, 4, [w]), entry(257, 4, [h]), entry(258, 3, [8, 8, 8]),
               entry(259, 3, [5]), entry(262, 3, [2]), entry(273, 4, offsets),
               entry(277, 3, [3]), entry(278, 4, [rps]), entry(279, 4, counts),
               entry(282, 5, [1, 1]), entry(283, 5, [1, 1]), entry(284, 3, [1]),
               entry(296, 3, [1]), entry(317, 3, [2])]
    ifd_at = extra + len(blobs)
    ifd = struct.pack("<H", len(entries)) + b"".join(entries) + struct.pack("<I", 0)
    return (b"II*\0" + struct.pack("<I", ifd_at) + data + b"\0" * (len(data) & 1) + blobs
            + ifd)


# --------------------------------------------------------------------- webp
WEBP_SIG = (b"RIFF", b"WEBP")


def _webp_chunks(buf: bytes):
    """(fourcc, body) of each chunk of a RIFF WEBP file."""
    at, end = 12, min(len(buf), 8 + struct.unpack("<I", buf[4:8])[0])
    while at + 8 <= end:
        n = struct.unpack("<I", buf[at + 4:at + 8])[0]
        yield buf[at:at + 4], buf[at + 8:at + 8 + n]
        at += 8 + n + (n & 1)


def _webp_header(buf: bytes, path):
    """(height, width, EXIF orientation) of a webp, from its VP8X canvas,
    its VP8 key frame or its VP8L header, without decoding."""
    chunks = list(_webp_chunks(buf))
    kind, body = chunks[0] if chunks else (b"", b"")
    if kind == b"VP8X" and len(body) >= 10:
        w = int.from_bytes(body[4:7], "little") + 1
        h = int.from_bytes(body[7:10], "little") + 1
    elif kind == b"VP8 " and len(body) >= 10 and body[3:6] == b"\x9d\x01\x2a":
        w, h = (v & 0x3FFF for v in struct.unpack("<HH", body[6:10]))
    elif kind == b"VP8L" and len(body) >= 5 and body[0] == 0x2F:
        bits = struct.unpack("<I", body[1:5])[0]
        w, h = (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
    else:
        raise ValueError(f"{path}: not a readable webp (first chunk {kind!r})")
    o = next((_exif_orientation(b[6:] if b[:6] == b"Exif\0\0" else b)
              for k, b in chunks if k == b"EXIF"), 1)
    return h, w, o


def _webp_decode(buf: bytes, path) -> np.ndarray:
    """libwebp's pixels through OpenCV, as stored (the orientation is the
    caller's, as for JPEG and PNG); raises where cv2 cannot read them."""
    cv2 = _cv2()
    img = cv2.imdecode(np.frombuffer(buf, np.uint8),
                       cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    if img is None:
        raise ValueError(f"{path}: cv2 could not decode this webp")
    return img


def _webp_encode(img: np.ndarray, path) -> bytes:
    """cv2.imwrite's webp at its default parameters (quality 100: lossless)."""
    ok, data = _cv2().imencode(".webp", img)
    if not ok:
        raise ValueError(f"{path}: cv2 could not encode webp")
    return data.tobytes()


# ------------------------------------------------------------------- public


def _kind(buf: bytes, path) -> str:
    """The format of encoded bytes, by their signature; raises, naming the
    format, for those the port does not read."""
    if buf[:3] == JPEG_SIG:
        return "jpeg"
    if buf[:8] == PNG_SIG:
        return "png"
    if buf[:2] == BMP_SIG:
        return "bmp"
    if buf[:4] in TIFF_SIGS:
        return "tiff"
    if buf[:4] == WEBP_SIG[0] and buf[8:12] == WEBP_SIG[1]:
        return "webp"
    raise ValueError(f"{path}: format {_ext(path)!r} is not supported by the port's "
                     "image reader (JPEG, MPO, PNG, BMP, TIFF, DNG and webp are)")


def _decode(buf: bytes, path, exif: bool = True) -> np.ndarray:
    """Encoded bytes -> BGR uint8, with the orientation of a JPEG's, PNG's
    or webp's EXIF applied unless `exif` is False (a TIFF's own tag is
    applied always)."""
    kind = _kind(buf, path)
    if kind == "jpeg":
        o, mpo = _jpeg_meta(buf)
        img = _jpeg_decode(_jpeg_first_image(buf) if mpo else buf, path)
    elif kind == "png":
        o, img = _png_orientation(buf, path), _png_decode(buf, path)
    elif kind == "bmp":
        o, img = 1, _bmp_decode(buf, path)
    elif kind == "webp":
        o, img = _webp_header(buf, path)[2], _webp_decode(buf, path)
    else:
        return _tiff_decode(buf, path)
    return _orient(img, o) if exif else img


def imread(path) -> np.ndarray:
    """The image file at `path` as BGR uint8 (H, W, 3), its EXIF
    orientation applied, as `cv2.imread`; raises when it cannot be read."""
    with open(path, "rb") as f:
        return _decode(f.read(), path)


def imdecode(buf: bytes, exif: bool = True) -> np.ndarray:
    """Encoded image bytes as BGR uint8 (H, W, 3), as `cv2.imdecode(...,
    IMREAD_COLOR)`, which applies the EXIF orientation; `exif=False`
    leaves a JPEG, MPO, PNG or webp as stored, as PIL's
    `Image.open(...).convert("RGB")` does (both apply a TIFF's orientation
    tag).  Raises ValueError when they cannot be read."""
    return _decode(bytes(buf), "<buffer>", exif)


def imwrite(path, img: np.ndarray, quality: int = JPEG_QUALITY) -> None:
    """Write BGR uint8 (H, W, 3) by the file's extension: JPEG (`.jpg`,
    `.jpeg`, at `quality`), PNG, BMP (24-bit), TIFF (`.tif`, `.tiff`:
    LZW with predictor 2) or webp (through cv2, lossless), as cv2.imwrite
    writes them."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"imwrite takes (H, W, 3) uint8, got {img.shape}")
    ext = _ext(path)
    if ext in ("jpg", "jpeg"):
        data = _jpeg_encode(img, quality, path)
    elif ext == "png":
        data = _png_encode(img)
    elif ext == "bmp":
        data = _bmp_encode(img)
    elif ext in ("tif", "tiff"):
        data = _tiff_encode(img)
    elif ext == "webp":
        data = _webp_encode(img, path)
    else:
        raise ValueError(f"{path}: format {ext!r} is not supported by the port's image writer")
    Path(path).write_bytes(data)


def image_shape(path) -> Tuple[int, int]:
    """(height, width) of `imread(path)`, from the file's headers (H and W
    swapped where the EXIF orientation is 5-8), without decoding."""
    buf = Path(path).read_bytes()
    kind = _kind(buf, path)
    if kind == "jpeg":
        o, _ = _jpeg_meta(buf)
        if jpeg_codec() == "nvjpeg":
            h, w = jpeg_frame(buf, path)[2:4]
        else:
            src = np.frombuffer(buf, np.uint8)
            dims = (ctypes.c_int * 2)()
            if lib().io_jpeg_probe(_ptr(src), len(buf), dims) != 0:
                raise ValueError(f"{path}: not a readable JPEG")
            h, w = dims[0], dims[1]
    elif kind == "png":
        w, h = _png_header(buf, path)[:2]
        o = _png_orientation(buf, path)
    elif kind == "bmp":
        h, w, o = *_bmp_header(buf, path)[:2], 1
    elif kind == "webp":
        h, w, o = _webp_header(buf, path)
    else:
        h, w, o = _tiff_geometry(_tiff_ifd0(buf, path)[1], path)
    return (int(w), int(h)) if o >= 5 else (int(h), int(w))
