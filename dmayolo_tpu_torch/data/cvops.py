"""The image operations of the data path, without OpenCV.

The loops run in the port's host library (`csrc/host/imgio.cpp`, through
ctypes, which releases the GIL); the rest is numpy.  Images are uint8
(H, W, C), BGR where colour order matters, as cv2 keeps them.  Sizes are
given as cv2 gives them: `dsize` is (width, height), points are (x, y).

How close each op comes to cv2 (the tests hold these):
  * `resize` linear: cv2's fixed-point INTER_LINEAR (its vector route),
    within 1 level on a fraction of a percent; area: a float area
    average, within 1 level of cv2's INTER_AREA;
  * `warp_affine` / `warp_perspective`: bilinear on float coordinates,
    within 1 level of cv2 on a small share of pixels;
  * `bgr_to_hsv`, `bgr_to_lab`, `lab_to_bgr`, `clahe`, `to_gray`, `blur`,
    `median_blur`, `add_saturate`, `copy_make_border`: bit-exact;
  * `hsv_to_bgr` (and so `hsv_lut`): bit-exact with cv2's scalar route,
    within 1 level of its vector route;
  * `gaussian_blur`: within 1 level;
  * the raster (`fill_rect`, `fill_circle`, `fill_poly`, `fill_ellipse`,
    `line`): the same shapes as cv2's LINE_8 drawing, which may differ at
    the boundary pixels; `rectangle` (outline, any thickness): pixel-equal
    to cv2's LINE_8 rectangle; its LINE_AA form within the bound
    tests/test_torch_image_formats.py states;
  * `put_text`: text of cv2's size and placement in a fixed bitmap font,
    not cv2's Hershey strokes (no test compares its pixels).
"""
from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import numpy as np

from .imageio import _ptr, lib

INTER_LINEAR = "linear"
INTER_AREA = "area"
LINE_8, LINE_AA = 8, 16  # cv2's line types


def _contig(im: np.ndarray) -> np.ndarray:
    im = np.ascontiguousarray(im)
    if im.dtype != np.uint8:
        raise TypeError(f"uint8 image expected, got {im.dtype}")
    return im


def _hwc(im: np.ndarray):
    return im.shape[0], im.shape[1], 1 if im.ndim == 2 else im.shape[2]


# ------------------------------------------------------------- geometry
def resize(im: np.ndarray, dsize: Tuple[int, int], interpolation: str = INTER_LINEAR) -> np.ndarray:
    """Resize to dsize = (width, height)."""
    im = _contig(im)
    h, w, c = _hwc(im)
    dw, dh = int(dsize[0]), int(dsize[1])
    out = np.empty((dh, dw) + im.shape[2:], np.uint8)
    if (dw, dh) == (w, h):
        out[:] = im
    elif interpolation == INTER_AREA:
        if dw > w or dh > h:
            raise ValueError(f"area resize only shrinks: {(w, h)} -> {(dw, dh)}")
        lib().io_resize_area(_ptr(im), h, w, _ptr(out), dh, dw, c)
    elif interpolation == INTER_LINEAR:
        lib().io_resize_linear(_ptr(im), h, w, _ptr(out), dh, dw, c)
    else:
        raise ValueError(f"unknown interpolation {interpolation!r}")
    return out


def get_rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D: (2, 3) float64, angle in degrees."""
    a = math.radians(angle)
    alpha, beta = scale * math.cos(a), scale * math.sin(a)
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _warp(im, m3: np.ndarray, dsize, border_value, perspective: bool) -> np.ndarray:
    im = _contig(im)
    h, w, c = _hwc(im)
    dw, dh = int(dsize[0]), int(dsize[1])
    if perspective:
        minv = np.linalg.inv(m3)
    else:  # cv2.invertAffineTransform
        a, b, tx = m3[0]
        d, e, ty = m3[1]
        det = a * e - b * d
        det = 1.0 / det if det != 0 else 0.0
        ia, ib, id_, ie = e * det, -b * det, -d * det, a * det
        minv = np.array([[ia, ib, -ia * tx - ib * ty], [id_, ie, -id_ * tx - ie * ty], [0, 0, 1.0]])
    minv = np.ascontiguousarray(minv, np.float64)
    out = np.empty((dh, dw) + im.shape[2:], np.uint8)
    border = int(border_value[0] if isinstance(border_value, Sequence) else border_value)
    lib().io_warp(_ptr(im), h, w, _ptr(out), dh, dw, c,
                  minv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), int(perspective), border)
    return out


def warp_affine(im, M: np.ndarray, dsize, border_value=114) -> np.ndarray:
    """cv2.warpAffine(im, M, dsize, borderValue=...) with INTER_LINEAR."""
    return _warp(im, np.asarray(M, np.float64).reshape(2, 3), dsize, border_value, False)


def warp_perspective(im, M: np.ndarray, dsize, border_value=114) -> np.ndarray:
    """cv2.warpPerspective(im, M, dsize, borderValue=...) with INTER_LINEAR."""
    return _warp(im, np.asarray(M, np.float64).reshape(3, 3), dsize, border_value, True)


def copy_make_border(im, top: int, bottom: int, left: int, right: int, value=114) -> np.ndarray:
    """Constant-border padding (cv2.copyMakeBorder, BORDER_CONSTANT);
    `value` a number (every channel) or one a channel."""
    h, w = im.shape[:2]
    out = np.empty((h + top + bottom, w + left + right) + im.shape[2:], np.uint8)
    out[...] = np.asarray(value, np.uint8)
    out[top:top + h, left:left + w] = im
    return out


# ---------------------------------------------------------------- colour
def bgr_to_hsv(im) -> np.ndarray:
    """cv2.COLOR_BGR2HSV on uint8 (H in [0, 180))."""
    im = _contig(im)
    out = np.empty_like(im)
    lib().io_bgr2hsv(_ptr(im), _ptr(out), im.size // 3)
    return out


def hsv_to_bgr(im) -> np.ndarray:
    """cv2.COLOR_HSV2BGR on uint8."""
    im = _contig(im)
    out = np.empty_like(im)
    lib().io_hsv2bgr(_ptr(im), _ptr(out), im.size // 3)
    return out


def hsv_lut(im: np.ndarray, lut_h, lut_s, lut_v) -> None:
    """In place: BGR -> HSV, a lookup table a channel (cv2.LUT's role),
    HSV -> BGR, in one pass.  `im` must be C-contiguous uint8."""
    if not (im.flags.c_contiguous and im.dtype == np.uint8):
        raise ValueError("hsv_lut works in place on a C-contiguous uint8 image")
    luts = [np.ascontiguousarray(t, np.uint8) for t in (lut_h, lut_s, lut_v)]
    lib().io_hsv_lut(_ptr(im), im.size // 3, *(_ptr(t) for t in luts))


def bgr_to_lab(im) -> np.ndarray:
    """cv2.COLOR_BGR2LAB on uint8 (L scaled to [0, 255], a and b offset by
    128): cv2's integer tables, bit-exact."""
    im = _contig(im)
    out = np.empty_like(im)
    lib().io_bgr2lab(_ptr(im), _ptr(out), im.size // 3)
    return out


def lab_to_bgr(im) -> np.ndarray:
    """cv2.COLOR_LAB2BGR on uint8, bit-exact."""
    im = _contig(im)
    out = np.empty_like(im)
    lib().io_lab2bgr(_ptr(im), _ptr(out), im.size // 3)
    return out


def clahe(im, clip_limit: float, tiles: int = 8) -> np.ndarray:
    """cv2.createCLAHE(clip_limit, (tiles, tiles)).apply on one uint8
    channel (H, W), bit-exact."""
    im = _contig(im)
    if im.ndim != 2:
        raise ValueError(f"clahe takes one channel (H, W), got {im.shape}")
    out = np.empty_like(im)
    lib().io_clahe(_ptr(im), im.shape[0], im.shape[1], float(clip_limit), int(tiles), _ptr(out))
    return out


def bgr_to_rgb(im) -> np.ndarray:
    """Channels 0 and 2 swapped (BGR <-> RGB), a new contiguous array."""
    im = _contig(im)
    out = np.empty_like(im)
    lib().io_swap_rb(_ptr(im), _ptr(out), im.size // 3)
    return out


def to_gray(im) -> np.ndarray:
    """cv2.COLOR_BGR2GRAY on uint8: its 15-bit fixed-point weights, bit-exact."""
    x = im.astype(np.int32)
    return ((x[..., 0] * 3735 + x[..., 1] * 19235 + x[..., 2] * 9798 + (1 << 14)) >> 15).astype(np.uint8)


def add_saturate(im, delta) -> np.ndarray:
    """cv2.add(im, delta, dtype=CV_8U) for an integer `delta`."""
    return np.clip(im.astype(np.int32) + np.asarray(delta, np.int32), 0, 255).astype(np.uint8)


# --------------------------------------------------------------- filters
def _reflect101(im, r: int) -> np.ndarray:
    pad = ((r, r), (r, r)) + ((0, 0),) * (im.ndim - 2)
    return np.pad(im, pad, mode="reflect")


def _sep_filter(im, kernel: np.ndarray) -> np.ndarray:
    k = len(kernel)
    r = k // 2
    x = _reflect101(im, r).astype(np.float64)
    h, w = im.shape[:2]
    rows = sum(kernel[i] * x[:, i:i + w] for i in range(k))
    return sum(kernel[i] * rows[i:i + h] for i in range(k))


def blur(im, k: int) -> np.ndarray:
    """cv2.blur (normalised k x k box, BORDER_REFLECT_101)."""
    x = _sep_filter(im, np.ones(k) / k)
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def gaussian_kernel(k: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel(k, sigma) for sigma > 0."""
    x = np.arange(k) - (k - 1) / 2
    g = np.exp(-(x * x) / (2 * sigma * sigma))
    return g / g.sum()


def gaussian_blur(im, k: int, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(im, (k, k), sigma) (BORDER_REFLECT_101)."""
    x = _sep_filter(im, gaussian_kernel(k, sigma))
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def median_blur(im, k: int) -> np.ndarray:
    """cv2.medianBlur with an odd k (edges replicated)."""
    im = _contig(im)
    h, w, c = _hwc(im)
    out = np.empty_like(im)
    lib().io_median(_ptr(im), h, w, c, int(k), _ptr(out))
    return out


# ---------------------------------------------------------------- raster
def _color(im, color) -> np.ndarray:
    """`color` as the image's channels, uint8: a scalar or a sequence
    repeated cyclically to the channel count (numpy's resize), clipped."""
    c = _hwc(im)[2]
    col = [int(v) for v in (color if hasattr(color, "__len__") else (color,))]
    return np.array([min(max(col[k % len(col)], 0), 255) for k in range(c)], np.uint8)


def _check_draw(im):
    if not (im.flags.c_contiguous and im.dtype == np.uint8):
        raise ValueError("drawing works in place on a C-contiguous uint8 image")
    return _hwc(im)


def fill_rect(im, p1, p2, color) -> None:
    """cv2.rectangle(im, p1, p2, color, -1): corners inclusive, clipped."""
    h, w, _ = _check_draw(im)
    x1, x2 = sorted((int(p1[0]), int(p2[0])))
    y1, y2 = sorted((int(p1[1]), int(p2[1])))
    x1, y1 = max(x1, 0), max(y1, 0)
    x2, y2 = min(x2, w - 1), min(y2, h - 1)
    if x1 <= x2 and y1 <= y2:
        im[y1:y2 + 1, x1:x2 + 1] = _color(im, color)


def fill_circle(im, center, radius: int, color) -> None:
    """cv2.circle(im, center, radius, color, -1)."""
    h, w, c = _check_draw(im)
    lib().io_fill_circle(_ptr(im), h, w, c, int(center[0]), int(center[1]), int(radius),
                         _ptr(_color(im, color)))


def fill_poly(im, pts, color) -> None:
    """cv2.fillPoly(im, [pts], color) of one polygon, pts (n, 2) integer."""
    h, w, c = _check_draw(im)
    p = np.ascontiguousarray(np.asarray(pts).reshape(-1, 2), np.int32)
    lib().io_fill_poly(_ptr(im), h, w, c, p.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                       len(p), _ptr(_color(im, color)))


def ellipse_poly(center, axes, angle: float, delta: int) -> np.ndarray:
    """cv2.ellipse2Poly for the whole ellipse: integer vertices every
    `delta` degrees."""
    a = math.radians(round(angle))  # cv2 rounds the angle to whole degrees
    ca, sa = math.cos(a), math.sin(a)
    pts = []
    for t in range(0, 360 + 1, delta):
        x, y = axes[0] * math.cos(math.radians(t)), axes[1] * math.sin(math.radians(t))
        p = (int(round(center[0] + x * ca - y * sa)), int(round(center[1] + x * sa + y * ca)))
        if not pts or p != pts[-1]:
            pts.append(p)
    return np.array(pts, np.int32)


def fill_ellipse(im, center, axes, angle: float, color) -> None:
    """cv2.ellipse(im, center, axes, angle, 0, 360, color, -1): the polygon
    cv2 fills, its vertex step chosen by size as cv2 chooses it."""
    size = max(axes)
    delta = 90 if size < 3 else 30 if size < 10 else 18 if size < 15 else 5
    fill_poly(im, ellipse_poly(center, axes, angle, delta), color)


def line(im, p0, p1, color, thickness: int = 1) -> None:
    """cv2.line(im, p0, p1, color, thickness): one-pixel 8-connected, or a
    filled band of the given width with round caps."""
    h, w, c = _check_draw(im)
    col = _color(im, color)
    if thickness <= 1:
        lib().io_line(_ptr(im), h, w, c, int(p0[0]), int(p0[1]), int(p1[0]), int(p1[1]), _ptr(col))
        return
    x0, y0, x1, y1 = (float(v) for v in (*p0, *p1))
    length = math.hypot(x1 - x0, y1 - y0)
    r = thickness / 2
    if length > 0:
        nx, ny = -(y1 - y0) / length * r, (x1 - x0) / length * r
        band = np.array([[x0 + nx, y0 + ny], [x1 + nx, y1 + ny],
                         [x1 - nx, y1 - ny], [x0 - nx, y0 - ny]])
        fill_poly(im, np.round(band), col)
    for x, y in ((x0, y0), (x1, y1)):
        fill_circle(im, (int(x), int(y)), int(thickness // 2), col)


def rectangle(im, p1, p2, color, thickness: int = 1, line_type: int = LINE_8) -> None:
    """cv2.rectangle(im, p1, p2, color, thickness, line_type).  LINE_8:
    the outline of the corners' rectangle, pixel-equal to cv2's; a
    thickness t > 1 draws each side as a band t // 2 + t % 2 pixels either
    side of it, rounded at the corners as cv2's thick lines are; t < 0
    fills.  LINE_AA: the outline anti-aliased (`io_polyline_aa`), a band
    of t / 2 either side with round corners and a soft edge; the tests
    state how near cv2's it comes."""
    if thickness < 0:
        fill_rect(im, p1, p2, color)
        return
    h, w, c = _check_draw(im)
    if line_type == LINE_AA:
        (x1, y1), (x2, y2) = p1, p2
        pts = np.array([x1, y1, x2, y1, x2, y2, x1, y2], np.int32)
        lib().io_polyline_aa(_ptr(im), h, w, c, pts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                             4, 1, int(thickness), _ptr(_color(im, color)))
        return
    lib().io_rectangle(_ptr(im), h, w, c, int(p1[0]), int(p1[1]), int(p2[0]), int(p2[1]),
                       int(thickness), _ptr(_color(im, color)))


def put_text(im, text: str, org, font_scale: float, color, thickness: int = 1) -> None:
    """Text with its baseline's left end at `org`, as cv2.putText places
    it, in the host library's fixed ASCII bitmap font (the Hershey simplex
    glyphs rasterised at scale 1) at `font_scale`: text of the size cv2's
    FONT_HERSHEY_SIMPLEX gives, but its pixels are the bitmap's, not cv2's
    strokes."""
    h, w, c = _check_draw(im)
    lib().io_put_text(_ptr(im), h, w, c, str(text).encode("ascii", "replace"), int(org[0]),
                      int(org[1]), float(font_scale), int(thickness), _ptr(_color(im, color)))
