// imgio: the port's host image library (decode, encode, resample, colour,
// raster), called through ctypes from dmayolo_tpu_torch/data/imageio.py
// and data/cvops.py.  ctypes releases the GIL around every call, so the
// loader's threads run these loops in parallel.
//
// Pixels are interleaved uint8, BGR for colour images as OpenCV keeps them.
// JPEG goes through the system's libjpeg(-turbo) and is compiled in only
// when <jpeglib.h> is found (IMGIO_JPEG, set by utils/cuda_build.py);
// elsewhere imageio.py takes nvJPEG (nvjpeg_codec.cpp).
// PNG's zlib streams are inflated and deflated by Python's zlib; the row
// filters are here.
//
// Where OpenCV's arithmetic is known, it is followed so that the results
// match cv2 exactly or to one level:
//   * BGR->HSV: cv2's integer tables (hsv_shift 12), bit-exact;
//   * HSV->BGR: cv2's scalar float formula (bit-exact with its scalar
//     route; its vector route differs from that by one level);
//   * bilinear resize: cv2's fixed-point INTER_LINEAR (11-bit coefficients,
//     the vertical pass as its vector route computes it);
//   * area resize: a separable area average in float (native/fastload.cpp's);
//   * warps: float coordinates and float bilinear weights, constant border.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <cstdlib>
#include <vector>

#ifdef IMGIO_JPEG
#include <jpeglib.h>
#endif

namespace {

#ifdef IMGIO_JPEG
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}
#endif

inline uint8_t sat_u8(float v) {
  // cvRound then saturate: round half to even, as lrintf does
  long r = std::lrintf(v);
  return static_cast<uint8_t>(r < 0 ? 0 : r > 255 ? 255 : r);
}

// ------------------------------------------------------------------- text
// A fixed bitmap font for box labels: the 95 printable ASCII glyphs of
// the Hershey simplex font (public domain) rasterised once at scale 1,
// thickness 1, 8-connected, into cells of kFontRows rows, each glyph with
// its advance.  Drawn at a scale s: a pixel is set when any font pixel
// under its footprint (1 / s font pixels a side) is; a thickness t > 1
// widens every set pixel by t - 1 pixels right and down.  The pixels are
// this font's, not OpenCV's Hershey strokes.

constexpr int kFontRows = 33;
constexpr int kFontAscent = 26;
constexpr int kFontLeft = -2;  // the glyph cells' column 0, from the pen
// advance, then one 32-bit row mask a row (bit x = column x), top down
const uint32_t kFont[95][34] = {
    {8, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // ' '
    {8, 0x0, 0x0, 0x0, 0x0, 0x0, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0xf8, 0xf8, 0xf8, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // '!'
    {11, 0x0, 0x0, 0x0, 0x0, 0x0, 0xf78, 0xf78, 0xf78, 0x778, 0x778, 0x778, 0x770, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // '"'
    {21, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x38f00, 0x38f00, 0x38700, 0x3c700, 0x1ffff0, 0x1ffff0, 0x1ffff0, 0x1c780, 0x1c780, 0x1c380, 0x1e380, 0xffff8, 0xffff8, 0xffff8, 0xe3c0, 0xe3c0, 0xe1c0, 0xf1c0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // '#'
    {18, 0x0, 0x0, 0xc00, 0x1e00, 0x1e00, 0x3f80, 0xffe0, 0x1fff0, 0x3fff0, 0x3e0f8, 0x7c078, 0x38078, 0xf8, 0x3f0, 0x1ff0, 0xffe0, 0x1ff80, 0x3fc00, 0x7e000, 0x78000, 0x78078, 0x78078, 0x7c0f8, 0x3fff8, 0x3fff0, 0xffe0, 0x1f00, 0x1e00, 0x1e00, 0x0, 0x0, 0x0, 0x0},  // '$'
    {22, 0x0, 0x0, 0x0, 0x0, 0x0, 0x1803e0, 0x3c07f0, 0x3e0ff0, 0x1f0f78, 0xf0e38, 0x78e38, 0x3ce38, 0x3ee38, 0x1ef78, 0xf7f0, 0xe7ff0, 0x3ffc00, 0x3ffc00, 0x7bde00, 0x71cf00, 0x71cf80, 0x71c780, 0x71c3c0, 0x7bc1e0, 0x3fc1f0, 0x3f80f0, 0x60000, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // '%'
    {21, 0x0, 0x0, 0x0, 0x0, 0x0, 0x1f00, 0x7fc0, 0xffe0, 0xfbe0, 0xf1e0, 0xe0e0, 0xf1e0, 0xfbe0, 0x7fc0, 0x3fc0, 0x1c1fc0, 0x1e1fe0, 0x1e3ff0, 0x1e7cf8, 0xff878, 0xff078, 0x7e078, 0x7e0f0, 0xffff0, 0x3ffff0, 0x3e7fc0, 0xf00, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // '&'
    {7, 0x0, 0x0, 0x0, 0x0, 0x0, 0x78, 0x78, 0x78, 0x78, 0x78, 0x78, 0x70, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // '\''
    {18, 0x0, 0x0, 0x7800, 0x7c00, 0x7e00, 0x3f00, 0xf00, 0xf00, 0x700, 0x780, 0x780, 0x780, 0x780, 0x780, 0x780, 0x780, 0x780, 0x780, 0x780, 0x780, 0x780, 0x780, 0x780, 0x700, 0xf00, 0xf00, 0x7e00, 0x7e00, 0x7c00, 0x7000, 0x0, 0x0, 0x0},  // '('
    {18, 0x0, 0x0, 0x3c0, 0xfc0, 0x1fc0, 0x1f00, 0x3e00, 0x3c00, 0x3c00, 0x3800, 0x3800, 0x7800, 0x7800, 0x7800, 0x7800, 0x7800, 0x7800, 0x7800, 0x7800, 0x7800, 0x7800, 0x3800, 0x3800, 0x3c00, 0x3c00, 0x3e00, 0x1f80, 0x1fc0, 0xfc0, 0x180, 0x0, 0x0, 0x0},  // ')'
    {13, 0x0, 0x0, 0x0, 0x0, 0x380, 0x380, 0x380, 0x1ff8, 0x3ff8, 0x3ff8, 0xfe0, 0xfe0, 0x1ff0, 0xef0, 0x640, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // '*'
    {18, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0xe00, 0x1e00, 0x1e00, 0x1e00, 0x1e00, 0x1e00, 0x1e00, 0x7fff8, 0x7fff8, 0x7fff8, 0x1e00, 0x1e00, 0x1e00, 0x1e00, 0x1e00, 0x1e00, 0xc00, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // '+'
    {8, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0xf0, 0xf0, 0xf8, 0x78, 0x78, 0x38, 0x38, 0x0, 0x0, 0x0, 0x0},  // ','
    {14, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x3ff8, 0x3ff8, 0x3ff0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // '-'
    {8, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0xf0, 0xf8, 0xf8, 0xf8, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // '.'
    {14, 0x0, 0x0, 0x0, 0xf000, 0xf000, 0x7800, 0x7800, 0x3800, 0x3c00, 0x3c00, 0x1e00, 0x1e00, 0xf00, 0xf00, 0x700, 0x780, 0x780, 0x3c0, 0x3c0, 0x1e0, 0x1e0, 0x1e0, 0xf0, 0xf0, 0x78, 0x78, 0x38, 0x3c, 0x3c, 0x0, 0x0, 0x0, 0x0},  // '/'
    {18, 0x0, 0x0, 0x0, 0x0, 0x0, 0x3f00, 0xffc0, 0x1ffe0, 0x3fff0, 0x3f1f0, 0x3f0f8, 0x7f878, 0x7b878, 0x79c78, 0x79c78, 0x79e78, 0x78e78, 0x78e78, 0x78778, 0x78778, 0x3c7f8, 0x3c3f0, 0x3e3f0, 0x1fff0, 0x1ffe0, 0xffc0, 0x1e00, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // '0'
    {18, 0x0, 0x0, 0x0, 0x0, 0x0, 0x1c00, 0x1f00, 0x1f80, 0x1fc0, 0x1fe0, 0x1ff0, 0x1cf0, 0x1c60, 0x1c00, 0x1c00, 0x1c00, 0x1c00, 0x1c00, 0x1c00, 0x1c00, 0x1c00, 0x1c00, 0x1c00, 0x7fff0, 0x7fff0, 0x7fff0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // '1'
    {18, 0x0, 0x0, 0x0, 0x0, 0x0, 0x3f00, 0xffc0, 0x1ffe0, 0x1ffe0, 0x3e1f0, 0x3c0f0, 0x3c0f0, 0x3c070, 0x3e000, 0x1f000, 0x1f800, 0xfc00, 0x7e00, 0x3f00, 0x1f80, 0xfc0, 0x7e0, 0x3f0, 0x3fff8, 0x3fff8, 0x3fff8, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // '2'
    {18, 0x0, 0x0, 0x0, 0x0, 0x0, 0x3fff0, 0x3fff0, 0x3fff0, 0x3fff0, 0x1f000, 0xf800, 0x7c00, 0x3e00, 0x1f00, 0x7f80, 0x1ff80, 0x3ff80, 0x3f000, 0x3c000, 0x78000, 0x78078, 0x3c078, 0x3e0f8, 0x3fff0, 0x1fff0, 0xffc0, 0x1f00, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // '3'
    {18, 0x0, 0x0, 0x0, 0x0, 0x0, 0xf000, 0xf800, 0xfc00, 0xfe00, 0xfe00, 0xff00, 0xff80, 0xf780, 0xf3c0, 0xf3e0, 0xf1e0, 0xf0f0, 0xf0f8, 0x7fffc, 0x7fffc, 0x7fffc, 0x7fff8, 0xf000, 0xf000, 0xf000, 0xf000, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // '4'
    {18, 0x0, 0x0, 0x0, 0x0, 0x0, 0x1ffe0, 0x1ffe0, 0x1ffe0, 0x1ffe0, 0xe0, 0xe0, 0xf0, 0x8f0, 0x7ff0, 0x1fff0, 0x3fff0, 0x3e1f0, 0x3c000, 0x7c000, 0x78000, 0x7c078, 0x3c0f8, 0x3e1f0, 0x3fff0, 0x1ffe0, 0xffc0, 0x1e00, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // '5'
    {18, 0x0, 0x0, 0x0, 0x0, 0x0, 0x3800, 0x7c00, 0x3e00, 0x3e00, 0x1f00, 0xf80, 0x780, 0x3fc0, 0xffe0, 0x1ffe0, 0x3fff0, 0x7c1f0, 0x780f8, 0x78078, 0x78078, 0x78078, 0x7c0f0, 0x3e1f0, 0x3fff0, 0x1ffe0, 0xffc0, 0x1c00, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // '6'
    {18, 0x0, 0x0, 0x0, 0x0, 0x0, 0x3fff0, 0x3fff0, 0x3fff0, 0x3fff0, 0x3e000, 0x1e000, 0x1f000, 0xf000, 0xf000, 0x7800, 0x7800, 0x7c00, 0x3c00, 0x3e00, 0x1e00, 0x1e00, 0xf00, 0xf00, 0xf80, 0x780, 0x780, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // '7'
    {18, 0x0, 0x0, 0x0, 0x0, 0x0, 0x3f00, 0xffc0, 0x1ffe0, 0x3fbf0, 0x3c0f0, 0x3c0f0, 0x3c0f0, 0x3c0f0, 0x3f3f0, 0x1ffe0, 0x1ffe0, 0x3fff0, 0x3e1f0, 0x7c078, 0x78078, 0x78078, 0x78078, 0x3c0f8, 0x3fff0, 0x1fff0, 0xffc0, 0x1f00, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // '8'
    {18, 0x0, 0x0, 0x0, 0x0, 0x0, 0x3f00, 0xffc0, 0x1ffe0, 0x3fff0, 0x3e0f8, 0x3c078, 0x7c078, 0x78078, 0x3c078, 0x3c0f8, 0x3e1f0, 0x1fff0, 0x1ffe0, 0xffc0, 0x7c00, 0x7c00, 0x3e00, 0x1f00, 0x1f00, 0xf80, 0x780, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // '9'
    {8, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0xf0, 0xf8, 0xf8, 0xf8, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0xf0, 0xf8, 0xf8, 0xf8, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // ':'
    {8, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0xf0, 0xf0, 0xf0, 0xf0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0xf0, 0xf0, 0xf0, 0x70, 0x78, 0x78, 0x30, 0x0, 0x0, 0x0, 0x0},  // ';'
    {15, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x7000, 0x7c00, 0x7e00, 0x3f80, 0xfc0, 0x7f0, 0x1f8, 0xf8, 0x78, 0x1f8, 0x3f0, 0xfe0, 0x1f80, 0x7f00, 0x7c00, 0x7800, 0x6000, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // '<'
    {17, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x1fff0, 0x1fff0, 0x1fff0, 0x0, 0x0, 0x0, 0x0, 0x1fff0, 0x1fff0, 0x1fff0, 0xfff0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // '='
    {15, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x78, 0xf8, 0x1f8, 0x7f0, 0xfc0, 0x3f80, 0x7e00, 0xfc00, 0xf800, 0x7e00, 0x3f00, 0x1fc0, 0x7e0, 0x3f0, 0xf8, 0x78, 0x30, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // '>'
    {16, 0x0, 0x0, 0x0, 0x0, 0x0, 0x1f80, 0x7fe0, 0xfff0, 0xfff8, 0x1f078, 0x1e078, 0x1e03c, 0xf038, 0xf800, 0x7c00, 0x7e00, 0x3e00, 0x1f00, 0xf00, 0xf00, 0xf00, 0xf00, 0x700, 0xf00, 0xf00, 0xf00, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // '?'
    {25, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0xf000, 0xfff00, 0x3fff80, 0x7f1fc0, 0x7c03e0, 0xf001f0, 0xe7f8f0, 0xe7fe70, 0x1e7fe78, 0x1e78e78, 0x1c78f38, 0x1c70f38, 0x1c70738, 0x1c78f38, 0x1e78f38, 0xfffe78, 0xfffe70, 0x7dfc70, 0xf0, 0x7801e0, 0x7e07e0, 0x3fff80, 0xfff00, 0x3f800, 0x0, 0x0, 0x0},  // '@'
    {20, 0x0, 0x0, 0x0, 0x0, 0x0, 0x3c00, 0x3e00, 0x7e00, 0x7f00, 0x7f00, 0xff00, 0xf780, 0x1f780, 0x1e3c0, 0x1e3c0, 0x3c3c0, 0x3c1e0, 0x3c1e0, 0x7fff0, 0x7fff0, 0xffff0, 0xffff8, 0xf0078, 0x1e0078, 0x1e003c, 0x1e003c, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'A'
    {20, 0x0, 0x0, 0x0, 0x0, 0x0, 0x3ff0, 0x3fff0, 0x7fff0, 0x7fff0, 0x780f0, 0xf80f0, 0xf00f0, 0xf80f0, 0x7e0f0, 0x7fff0, 0x3fff0, 0x7fff0, 0xfe0f0, 0xf80f0, 0xf00f0, 0xf00f0, 0xf00f0, 0xfc0f0, 0x7fff0, 0x3fff0, 0x1fff0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'B'
    {20, 0x0, 0x0, 0x0, 0x0, 0x0, 0x7e00, 0x1ffc0, 0x7ffe0, 0x7ffe0, 0xf81f0, 0xf00f0, 0xf00f0, 0xe0078, 0x78, 0x78, 0x78, 0x78, 0x78, 0x78, 0xf0078, 0xf00f0, 0xf00f0, 0xf81f0, 0x7ffe0, 0x3ffc0, 0x1ff80, 0x3c00, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'C'
    {20, 0x0, 0x0, 0x0, 0x0, 0x0, 0x3ff0, 0x1fff0, 0x3fff0, 0x7fff0, 0xfc0f0, 0xf00f0, 0xf00f0, 0xf00f0, 0x1e00f0, 0x1e00f0, 0x1e00f0, 0x1e00f0, 0x1e00f0, 0x1e00f0, 0xf00f0, 0xf00f0, 0xf80f0, 0xfc0f0, 0x7fff0, 0x3fff0, 0x1fff0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'D'
    {18, 0x0, 0x0, 0x0, 0x0, 0x0, 0x3fff0, 0x3fff0, 0x3fff0, 0x3fff0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0x1fff0, 0x3fff0, 0x3fff0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0x3fff0, 0x3fff0, 0x3fff0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'E'
    {17, 0x0, 0x0, 0x0, 0x0, 0x0, 0x3fff0, 0x3fff0, 0x3fff0, 0x3fff0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0x3fff0, 0x3fff0, 0x1fff0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'F'
    {20, 0x0, 0x0, 0x0, 0x0, 0x0, 0x7e00, 0x1ff80, 0x7ffc0, 0x7ffe0, 0xf81f0, 0xf00f0, 0xf00f0, 0x78, 0x78, 0x78, 0x1ff078, 0x1ff078, 0x1ff078, 0x1e0078, 0xf0078, 0xf00f0, 0xf00f0, 0xfc1f0, 0x7ffe0, 0x3ffc0, 0x1ff80, 0x3c00, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'G'
    {21, 0x0, 0x0, 0x0, 0x0, 0x0, 0xe00f0, 0x1e00f0, 0x1e00f0, 0x1e00f0, 0x1e00f0, 0x1e00f0, 0x1e00f0, 0x1e00f0, 0x1e00f0, 0x1ffff0, 0x1ffff0, 0x1ffff0, 0x1ffff0, 0x1e00f0, 0x1e00f0, 0x1e00f0, 0x1e00f0, 0x1e00f0, 0x1e00f0, 0x1e00f0, 0x1e00f0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'H'
    {8, 0x0, 0x0, 0x0, 0x0, 0x0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'I'
    {19, 0x0, 0x0, 0x0, 0x0, 0x0, 0x3fff0, 0x3fff0, 0x3fff0, 0x3fff0, 0x38000, 0x38000, 0x38000, 0x38000, 0x38000, 0x38000, 0x38000, 0x38000, 0x38000, 0x38000, 0x3c038, 0x3c078, 0x3c078, 0x3e0f8, 0x1fff8, 0xfff0, 0x7fe0, 0xf00, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'J'
    {18, 0x0, 0x0, 0x0, 0x0, 0x0, 0x780f0, 0x7c0f0, 0x3e0f0, 0x1f0f0, 0xf8f0, 0x7cf0, 0x3ef0, 0x1ff0, 0xff0, 0x7f0, 0x3f0, 0x7f0, 0xff0, 0x1ff0, 0x3ff0, 0x7ef0, 0xfcf0, 0x1f0f0, 0x3e0f0, 0x7c0f0, 0x780f0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'K'
    {17, 0x0, 0x0, 0x0, 0x0, 0x0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0x3fff0, 0x3fff0, 0x3fff0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'L'
    {23, 0x0, 0x0, 0x0, 0x0, 0x0, 0x7800f0, 0x7800f0, 0x7c01f0, 0x7c01f0, 0x7e03f0, 0x7e03f0, 0x7f07f0, 0x7f07f0, 0x7f8ff0, 0x7f8ff0, 0x7bdef0, 0x7bfef0, 0x79fcf0, 0x79fcf0, 0x78f8f0, 0x78f8f0, 0x7870f0, 0x7800f0, 0x7800f0, 0x7800f0, 0x7800f0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'M'
    {21, 0x0, 0x0, 0x0, 0x0, 0x0, 0xe0070, 0xf00f0, 0xf01f0, 0xf01f0, 0xf03f0, 0xf07f0, 0xf07f0, 0xf0ff0, 0xf1ff0, 0xf1ef0, 0xf3ef0, 0xf7cf0, 0xf78f0, 0xff8f0, 0xff0f0, 0xfe0f0, 0xfe0f0, 0xfc0f0, 0xf80f0, 0xf80f0, 0xf00f0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'N'
    {20, 0x0, 0x0, 0x0, 0x0, 0x0, 0x3e00, 0x1ff80, 0x3ffe0, 0x7fff0, 0x7c1f0, 0xf80f0, 0xf00f0, 0xf0078, 0xf0078, 0xf0078, 0xf0078, 0xf0078, 0xf0078, 0xf0078, 0xf0078, 0xf00f0, 0xf80f0, 0x7c1f0, 0x7ffe0, 0x3ffc0, 0x1ff80, 0x3c00, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'O'
    {19, 0x0, 0x0, 0x0, 0x0, 0x0, 0x3ff0, 0x1fff0, 0x3fff0, 0x7fff0, 0x780f0, 0xf80f0, 0xf00f0, 0xf00f0, 0xf80f0, 0x780f0, 0x7fff0, 0x3fff0, 0x1fff0, 0x1ff0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'P'
    {20, 0x0, 0x0, 0x0, 0x0, 0x0, 0x3e00, 0x1ff80, 0x3ffe0, 0x7fff0, 0x7c1f0, 0xf80f0, 0xf00f0, 0xf0078, 0xf0078, 0xf0078, 0xf0078, 0xf0078, 0xf0078, 0xf0078, 0xf0078, 0xf00f0, 0xf80f0, 0xfc1f0, 0x7ffe0, 0x7ffc0, 0x7ff80, 0xfbc00, 0xf0000, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'Q'
    {19, 0x0, 0x0, 0x0, 0x0, 0x0, 0x3ff0, 0x1fff0, 0x3fff0, 0x7fff0, 0x780f0, 0xf80f0, 0xf00f0, 0xf80f0, 0x780f0, 0x7c0f0, 0x7fff0, 0x3fff0, 0xfff0, 0xf0f0, 0x1e0f0, 0x3e0f0, 0x3c0f0, 0x7c0f0, 0x780f0, 0xf80f0, 0xf00f0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'R'
    {18, 0x0, 0x0, 0x0, 0x0, 0x0, 0x3f00, 0xffc0, 0x1fff0, 0x3fff0, 0x3c0f0, 0x7c078, 0x38078, 0xf0, 0x3f0, 0x1ff0, 0xffc0, 0x1ff80, 0x3fc00, 0x7e000, 0x78000, 0x78078, 0x78078, 0x7c0f8, 0x3fff0, 0x3fff0, 0xffc0, 0x1e00, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'S'
    {17, 0x0, 0x0, 0x0, 0x0, 0x0, 0x3fffc, 0x3fffc, 0x3fffc, 0x3fffc, 0xf00, 0xf00, 0xf00, 0xf00, 0xf00, 0xf00, 0xf00, 0xf00, 0xf00, 0xf00, 0xf00, 0xf00, 0xf00, 0xf00, 0xf00, 0xf00, 0xf00, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'T'
    {21, 0x0, 0x0, 0x0, 0x0, 0x0, 0xe0070, 0xe00f0, 0xe00f0, 0xe00f0, 0xe00f0, 0xe00f0, 0xe00f0, 0xe00f0, 0xe00f0, 0xe00f0, 0xe00f0, 0xe00f0, 0xe00f0, 0xf00f0, 0xf00f0, 0xf00f0, 0xf01f0, 0xfc3e0, 0x7ffe0, 0x3ffc0, 0x1ff80, 0x3c00, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'U'
    {19, 0x0, 0x0, 0x0, 0x0, 0x0, 0xe0038, 0xf003c, 0xf0078, 0xf0078, 0xf80f8, 0x780f0, 0x780f0, 0x3c1f0, 0x3c1e0, 0x3c1e0, 0x1e3e0, 0x1e3c0, 0x1e3c0, 0xf7c0, 0xf780, 0xf780, 0x7f80, 0x7f00, 0x7f00, 0x3e00, 0x3e00, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'V'
    {24, 0x0, 0x0, 0x0, 0x0, 0x0, 0xe00038, 0xf00078, 0xf00078, 0xf00078, 0xf00078, 0xf07078, 0x78f8f0, 0x78f8f0, 0x78f8f0, 0x79fcf0, 0x79fcf0, 0x3ddde0, 0x3fdfe0, 0x3fdfe0, 0x3f8fe0, 0x3f8fe0, 0x1f8fc0, 0x1f0fc0, 0x1f07c0, 0x1f07c0, 0x1e07c0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'W'
    {19, 0x0, 0x0, 0x0, 0x0, 0x0, 0x70038, 0xf8078, 0x780f8, 0x7c0f0, 0x3e1f0, 0x1e3e0, 0x1f7c0, 0xffc0, 0x7f80, 0x7f00, 0x3f00, 0x3f00, 0x7f80, 0xff80, 0xffc0, 0x1f3e0, 0x3e1e0, 0x3e1f0, 0x7c0f8, 0xf807c, 0xf007c, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'X'
    {19, 0x0, 0x0, 0x0, 0x0, 0x0, 0xe0038, 0xf007c, 0xf8078, 0x780f8, 0x7c0f0, 0x3c1f0, 0x3e3e0, 0x1f3c0, 0xf7c0, 0xff80, 0x7f80, 0x7f00, 0x3e00, 0x3e00, 0x1e00, 0x1e00, 0x1e00, 0x1e00, 0x1e00, 0x1e00, 0x1e00, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'Y'
    {18, 0x0, 0x0, 0x0, 0x0, 0x0, 0x3fff8, 0x3fff8, 0x3fff8, 0x3fff8, 0x3e000, 0x1f000, 0xf800, 0xfc00, 0x7c00, 0x3e00, 0x1f00, 0x1f00, 0xf80, 0x7c0, 0x7e0, 0x3e0, 0x1f0, 0xf8, 0x7fff8, 0x7fff8, 0x7fff8, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'Z'
    {10, 0x0, 0x0, 0x0, 0x7f0, 0x7f0, 0x7f0, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x7f0, 0x7f0, 0x7f0, 0x0, 0x0},  // '['
    {14, 0x0, 0x0, 0x0, 0x3c, 0x3c, 0x78, 0x78, 0x78, 0xf0, 0xf0, 0x1e0, 0x1e0, 0x1c0, 0x3c0, 0x3c0, 0x780, 0x780, 0xf00, 0xf00, 0xf00, 0x1e00, 0x1e00, 0x3c00, 0x3c00, 0x3800, 0x7800, 0x7800, 0xf000, 0xf000, 0x0, 0x0, 0x0, 0x0},  // '\\'
    {10, 0x0, 0x0, 0x0, 0x3fc, 0x3fc, 0x3fc, 0x3c0, 0x3c0, 0x3c0, 0x3c0, 0x3c0, 0x3c0, 0x3c0, 0x3c0, 0x3c0, 0x3c0, 0x3c0, 0x3c0, 0x3c0, 0x3c0, 0x3c0, 0x3c0, 0x3c0, 0x3c0, 0x3c0, 0x3c0, 0x3c0, 0x3c0, 0x3fc, 0x3fc, 0x3fc, 0x0, 0x0},  // ']'
    {13, 0x0, 0x0, 0x0, 0x0, 0x0, 0x3c0, 0x7e0, 0xff0, 0x1ef8, 0x1c38, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // '^'
    {22, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x3ffff8, 0x3ffff8, 0x3ffff8, 0x3ffff8, 0x0, 0x0, 0x0, 0x0, 0x0},  // '_'
    {10, 0x0, 0x0, 0x0, 0x0, 0x70, 0xf8, 0x1f0, 0x3e0, 0x3c0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // '`'
    {16, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0xf00, 0x3fe0, 0x7ff0, 0xfff0, 0xf0f0, 0xf070, 0xfc00, 0xffc0, 0xfff0, 0xe3f8, 0xf078, 0xf078, 0xf878, 0xfef8, 0xfff8, 0xfff0, 0x780, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'a'
    {18, 0x0, 0x0, 0x0, 0x0, 0x0, 0x70, 0x70, 0x70, 0x70, 0x70, 0x1c70, 0xfff0, 0x1fff0, 0x1fff0, 0x3e1f0, 0x3c0f0, 0x3c0f0, 0x3c070, 0x3c070, 0x3c070, 0x3c0f0, 0x3c0f0, 0x3e1f0, 0x1fff0, 0x1fff0, 0xfff0, 0x1c00, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'b'
    {16, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0xf00, 0x7fc0, 0xffe0, 0x1fff0, 0x1f0f0, 0x1e078, 0x1c078, 0x78, 0x78, 0x78, 0x1c078, 0x1e078, 0x1f0f0, 0x1fff0, 0xffe0, 0x7fc0, 0x1e00, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'c'
    {18, 0x0, 0x0, 0x0, 0x0, 0x0, 0x1c000, 0x3c000, 0x3c000, 0x3c000, 0x3c000, 0x3c700, 0x3ffc0, 0x3fff0, 0x3fff0, 0x3f0f8, 0x3e078, 0x3e078, 0x3c078, 0x3c078, 0x3c078, 0x3e078, 0x3e078, 0x3f0f8, 0x3fff0, 0x3fff0, 0x3ffc0, 0x700, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'd'
    {17, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0xe00, 0x7fc0, 0x7fe0, 0xfff0, 0x1f0f0, 0x1e078, 0x1e078, 0x1fff8, 0x1fff8, 0x1fff8, 0x78, 0x78, 0x1e0f8, 0x1fbf0, 0xffe0, 0x7fc0, 0xf00, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'e'
    {12, 0x0, 0x0, 0x0, 0x0, 0x1f00, 0x1f80, 0x1fc0, 0x7e0, 0x1e0, 0x1e0, 0xff8, 0x1ffc, 0x1ffc, 0x1ffc, 0x1e0, 0x1e0, 0x1e0, 0x1e0, 0x1e0, 0x1e0, 0x1e0, 0x1e0, 0x1e0, 0x1e0, 0x1e0, 0x1e0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'f'
    {18, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x18700, 0x3ffc0, 0x3fff0, 0x3fff0, 0x3f0f8, 0x3e078, 0x3e078, 0x3c078, 0x3c078, 0x3c078, 0x3e078, 0x3e078, 0x3f0f8, 0x3fff0, 0x3fff0, 0x3ffc0, 0x1c600, 0x1e078, 0x1e0f8, 0x1fbf0, 0xfff0, 0x7fe0, 0xf00},  // 'g'
    {18, 0x0, 0x0, 0x0, 0x0, 0x0, 0x70, 0x70, 0x70, 0x70, 0x70, 0x1c70, 0xff70, 0x1fff0, 0x1fff0, 0x3e1f0, 0x3c0f0, 0x3c0f0, 0x3c070, 0x3c070, 0x3c070, 0x3c070, 0x3c070, 0x3c070, 0x3c070, 0x3c070, 0x3c070, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'h'
    {7, 0x0, 0x0, 0x0, 0x0, 0x0, 0xf8, 0xf8, 0xf8, 0x70, 0x0, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'i'
    {8, 0x0, 0x0, 0x0, 0x0, 0x0, 0xf0, 0xf0, 0xf0, 0xf0, 0x0, 0x60, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0xf0, 0x78, 0x7e, 0x3f, 0x1e, 0x0},  // 'j'
    {15, 0x0, 0x0, 0x0, 0x0, 0x0, 0x70, 0x70, 0x70, 0x70, 0x70, 0xe070, 0xf870, 0xfc70, 0x7e70, 0x3f70, 0xff0, 0x7f0, 0x3f0, 0x7f0, 0xff0, 0x1ff0, 0x3f70, 0x7e70, 0xfc70, 0x1f870, 0x1f070, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'k'
    {8, 0x0, 0x0, 0x0, 0x0, 0x0, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'l'
    {26, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x381e30, 0xff7ff0, 0x1fffff0, 0x3fffff0, 0x3e3f0f0, 0x3c1e0f0, 0x3c1e0f0, 0x3c1e070, 0x3c1e070, 0x3c1e070, 0x3c1e070, 0x3c1e070, 0x3c1e070, 0x3c1e070, 0x3c1e070, 0x3c1e070, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'm'
    {18, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x1c70, 0xfff0, 0x1fff0, 0x1fff0, 0x1e1f0, 0x3c0f0, 0x3c0f0, 0x3c070, 0x3c070, 0x3c070, 0x3c070, 0x3c070, 0x3c070, 0x3c070, 0x3c070, 0x3c070, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'n'
    {17, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0xe00, 0x7fc0, 0xffe0, 0x1fff0, 0x1e0f0, 0x1e078, 0x1c078, 0x3c078, 0x3c078, 0x3c078, 0x1c078, 0x1e078, 0x1e0f0, 0x1fff0, 0xffe0, 0x7fc0, 0xe00, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'o'
    {18, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x1c70, 0xfff0, 0x1fff0, 0x1fff0, 0x3e1f0, 0x3c0f0, 0x3c0f0, 0x3c070, 0x3c070, 0x3c070, 0x3c0f0, 0x3c0f0, 0x3e1f0, 0x1fff0, 0x1fff0, 0xfff0, 0x1c70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x0},  // 'p'
    {18, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x18700, 0x3ffc0, 0x3fff0, 0x3fff0, 0x3f0f8, 0x3e078, 0x3c078, 0x3c078, 0x3c078, 0x3c078, 0x3c078, 0x3e078, 0x3f0f8, 0x3fff0, 0x3fff0, 0x3ffc0, 0x3c700, 0x3c000, 0x3c000, 0x3c000, 0x3c000, 0x1c000, 0x0},  // 'q'
    {11, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0xc70, 0x1ff0, 0x1ff0, 0x1ff0, 0x1f0, 0xf0, 0xf0, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'r'
    {15, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x780, 0x3fe0, 0x7ff0, 0x7df8, 0x7078, 0x78, 0x1f8, 0xff0, 0x3fe0, 0xff80, 0xfc00, 0xf000, 0xf078, 0xfcf8, 0x7ff8, 0x3ff0, 0x780, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 's'
    {12, 0x0, 0x0, 0x0, 0x0, 0x0, 0xe0, 0x1e0, 0x1e0, 0x1e0, 0x1e0, 0xff8, 0x1ffc, 0x1ffc, 0x1ffc, 0x1e0, 0x1e0, 0x1e0, 0x1e0, 0x1e0, 0x1e0, 0x1e0, 0x1e0, 0x1e0, 0x1fe0, 0x1fc0, 0x1f80, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 't'
    {18, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x18030, 0x3c078, 0x3c078, 0x3c078, 0x3c078, 0x3c078, 0x3c078, 0x3c078, 0x3c078, 0x3c078, 0x3c070, 0x3e0f0, 0x3e0f0, 0x3fff0, 0x3ffe0, 0x3ffc0, 0xf00, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'u'
    {16, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x18018, 0x3c03c, 0x1e078, 0x1e078, 0x1e078, 0xf0f0, 0xf0f0, 0x79e0, 0x79e0, 0x79e0, 0x3fc0, 0x3fc0, 0x1f80, 0x1f80, 0x1f80, 0xf00, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'v'
    {24, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0xc02018, 0x1e07038, 0xe0f878, 0xf0f878, 0xf0f878, 0xf1fc70, 0x79fcf0, 0x79dcf0, 0x7bdee0, 0x3bdfe0, 0x3f8fe0, 0x3f8fe0, 0x1f8fc0, 0x1f07c0, 0x1f07c0, 0xf0780, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'w'
    {16, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0xc038, 0x1e078, 0x1f0f8, 0xf8f0, 0x79f0, 0x3fe0, 0x3fc0, 0x1f80, 0xf80, 0x1fc0, 0x3fc0, 0x7fe0, 0x79f0, 0xf8f8, 0x1f078, 0x1e07c, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'x'
    {16, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x18018, 0x3c03c, 0x3e078, 0x1e078, 0x1e0f8, 0xf0f0, 0xf0f0, 0x79e0, 0x79e0, 0x3fe0, 0x3fc0, 0x3fc0, 0x1f80, 0x1f80, 0xf00, 0xf00, 0x780, 0x780, 0x7c0, 0x3c0, 0x3c0, 0x1c0, 0x0},  // 'y'
    {15, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x7ff0, 0xfff8, 0xfff8, 0x7ff8, 0x7c00, 0x3e00, 0x1f00, 0xf80, 0xf80, 0x7c0, 0x3e0, 0x1f0, 0x1f8, 0xfff8, 0xfff8, 0xfff8, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // 'z'
    {11, 0x0, 0x0, 0x0, 0xe00, 0xf80, 0xfc0, 0x7c0, 0x1e0, 0x1e0, 0x1e0, 0x1e0, 0xe0, 0xe0, 0xe0, 0xf0, 0xf8, 0x7c, 0x7c, 0xf8, 0xf0, 0xf0, 0xe0, 0xe0, 0x1e0, 0x1e0, 0x1e0, 0x1e0, 0x7c0, 0xfc0, 0xf80, 0xf00, 0x0, 0x0},  // '{'
    {7, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x20},  // '|'
    {11, 0x0, 0x0, 0x0, 0x3c, 0xfc, 0x1fc, 0x1f8, 0x1e0, 0x3c0, 0x3c0, 0x3c0, 0x3c0, 0x3c0, 0x3c0, 0x7c0, 0xf80, 0xf80, 0xf00, 0xf80, 0x780, 0x3c0, 0x3c0, 0x3c0, 0x3c0, 0x3c0, 0x3c0, 0x1e0, 0x1f0, 0x1fc, 0xfc, 0x7c, 0x0, 0x0},  // '}'
    {17, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0xc3e0, 0x1fff0, 0x1fff0, 0xfff0, 0x3010, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0},  // '~'
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------- JPEG
// dims out: [height, width].  Returns 0 on success.
int io_jpeg_probe(const uint8_t* buf, unsigned long len, int* dims) {
#ifdef IMGIO_JPEG
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  dims[0] = cinfo.image_height;
  dims[1] = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  return 0;
#else
  (void)buf; (void)len; (void)dims;
  return 2;
#endif
}

// Decode to BGR uint8 into out (h * w * 3 bytes, from io_jpeg_probe).
// fancy: libjpeg's triangle ("fancy") chroma upsampling, cv2's default;
// 0 replicates chroma samples (box upsampling), as nvJPEG does.
int io_jpeg_decode(const uint8_t* buf, unsigned long len, uint8_t* out, int h, int w,
                   int fancy) {
#ifdef IMGIO_JPEG
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  cinfo.out_color_space = JCS_EXT_BGR;  // libjpeg-turbo: straight to BGR
  cinfo.do_fancy_upsampling = fancy ? TRUE : FALSE;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_width) != w || static_cast<int>(cinfo.output_height) != h) {
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  const size_t stride = static_cast<size_t>(w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
#else
  (void)buf; (void)len; (void)out; (void)h; (void)w;
  return 2;
#endif
}

// Encode BGR uint8 (h, w, 3) at `quality` (libjpeg's defaults otherwise:
// 4:2:0, no optimised tables), into out (cap bytes).  Returns the size, or
// -needed when cap is too small, or 0 on error.
long io_jpeg_encode(const uint8_t* bgr, int h, int w, int quality, uint8_t* out, long cap) {
#ifdef IMGIO_JPEG
  jpeg_compress_struct cinfo;
  JpegErr jerr;
  unsigned char* mem = nullptr;
  unsigned long mem_size = 0;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_compress(&cinfo);
    free(mem);
    return 0;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &mem, &mem_size);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_EXT_BGR;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  const size_t stride = static_cast<size_t>(w) * 3;
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(bgr) + static_cast<size_t>(cinfo.next_scanline) * stride;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  long n = static_cast<long>(mem_size);
  if (n > cap) {
    free(mem);
    return -n;
  }
  std::memcpy(out, mem, mem_size);
  free(mem);
  return n;
#else
  (void)bgr; (void)h; (void)w; (void)quality; (void)out; (void)cap;
  return 0;
#endif
}

// ---------------------------------------------------------------- PNG rows
// Undo the PNG row filters in place: data holds h rows of (1 + rowbytes)
// bytes (filter type, then the filtered row); the unfiltered rows are
// packed to the front (h * rowbytes bytes).  bpp: bytes a pixel (>= 1).
// Returns 0, or 1 on an unknown filter type.
int io_png_unfilter(uint8_t* data, int h, long rowbytes, int bpp) {
  std::vector<uint8_t> prev(rowbytes, 0);
  for (int y = 0; y < h; ++y) {
    const uint8_t* in = data + static_cast<size_t>(y) * (rowbytes + 1);
    const int ft = in[0];
    ++in;
    uint8_t* cur = data + static_cast<size_t>(y) * rowbytes;  // writes trail the reads
    const uint8_t* up = prev.data();
    switch (ft) {
      case 0:
        std::memmove(cur, in, rowbytes);
        break;
      case 1:
        for (long i = 0; i < rowbytes; ++i)
          cur[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (long i = 0; i < rowbytes; ++i) cur[i] = static_cast<uint8_t>(in[i] + up[i]);
        break;
      case 3:
        for (long i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          cur[i] = static_cast<uint8_t>(in[i] + ((a + up[i]) >> 1));
        }
        break;
      case 4:
        for (long i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = up[i];
          const int c = i >= bpp ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = static_cast<uint8_t>(in[i] + pred);
        }
        break;
      default:
        return 1;
    }
    std::memcpy(prev.data(), cur, rowbytes);
  }
  return 0;
}

// BGR (h, w, 3) -> PNG scanlines of RGB with filter 1 (Sub) on every row:
// out holds h * (1 + 3 w) bytes.
void io_png_filter_bgr(const uint8_t* bgr, int h, int w, uint8_t* out) {
  const size_t rb = static_cast<size_t>(w) * 3;
  for (int y = 0; y < h; ++y) {
    const uint8_t* s = bgr + y * rb;
    uint8_t* o = out + y * (rb + 1);
    o[0] = 1;
    ++o;
    int pr = 0, pg = 0, pb = 0;
    for (int x = 0; x < w; ++x) {
      const int b = s[3 * x], g = s[3 * x + 1], r = s[3 * x + 2];
      o[3 * x] = static_cast<uint8_t>(r - pr);
      o[3 * x + 1] = static_cast<uint8_t>(g - pg);
      o[3 * x + 2] = static_cast<uint8_t>(b - pb);
      pr = r; pg = g; pb = b;
    }
  }
}

// Swap channels 0 and 2 of n 3-channel pixels (RGB <-> BGR); src may be dst.
void io_swap_rb(const uint8_t* src, uint8_t* dst, long n) {
  for (long i = 0; i < n; ++i) {
    const uint8_t a = src[3 * i], b = src[3 * i + 1], c = src[3 * i + 2];
    dst[3 * i] = c;
    dst[3 * i + 1] = b;
    dst[3 * i + 2] = a;
  }
}

// ---------------------------------------------------------------- orientation
// dst = src (h, w, cn) under EXIF orientation o (1-8), as cv2 applies it:
// 2 mirror, 3 rotate 180, 4 flip, 5 transpose, 6 rotate 90 clockwise,
// 7 transverse, 8 rotate 90 counter-clockwise.  dst is (w, h, cn) for
// o >= 5, else (h, w, cn).
void io_orient(const uint8_t* src, int h, int w, int cn, int o, uint8_t* dst) {
  const bool swap = o >= 5;
  const int dw = swap ? h : w, dh = swap ? w : h;
  for (int y = 0; y < dh; ++y)
    for (int x = 0; x < dw; ++x) {
      int sx, sy;  // the source pixel of (x, y)
      switch (o) {
        case 2: sx = w - 1 - x; sy = y; break;
        case 3: sx = w - 1 - x; sy = h - 1 - y; break;
        case 4: sx = x; sy = h - 1 - y; break;
        case 5: sx = y; sy = x; break;
        case 6: sx = y; sy = h - 1 - x; break;
        case 7: sx = w - 1 - y; sy = h - 1 - x; break;
        case 8: sx = w - 1 - y; sy = x; break;
        default: sx = x; sy = y; break;
      }
      std::memcpy(dst + (static_cast<size_t>(y) * dw + x) * cn,
                  src + (static_cast<size_t>(sy) * w + sx) * cn, cn);
    }
}

// ---------------------------------------------------------------- BMP
// The pixel rows of a BMP -> BGR (h, w, 3), as cv2 reads them.  rows: the
// file's pixel array, `stride` bytes a row, bottom-up unless top_down.
// bpp 1/4/8 index `palette` (256 BGR triples, zero past the file's);
// 16: mode 0 is 5-5-5, 1 is 5-6-5, each field shifted up to 8 bits
// without filling the low bits (cv2's icvCvt_BGR5x52BGR); 24 and 32 copy
// B, G, R (32's fourth byte dropped).
void io_bmp_unpack(const uint8_t* rows, int h, int w, int bpp, long stride, int top_down,
                   const uint8_t* palette, int mode, uint8_t* out) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* r = rows + static_cast<size_t>(top_down ? y : h - 1 - y) * stride;
    uint8_t* o = out + static_cast<size_t>(y) * w * 3;
    for (int x = 0; x < w; ++x, o += 3) {
      if (bpp <= 8) {
        const int per = 8 / bpp, shift = 8 - bpp * (1 + x % per);
        const int idx = (r[x / per] >> shift) & ((1 << bpp) - 1);
        std::memcpy(o, palette + 3 * idx, 3);
      } else if (bpp == 16) {
        const int t = r[2 * x] | (r[2 * x + 1] << 8);
        o[0] = static_cast<uint8_t>((t << 3) & 0xf8);
        o[1] = static_cast<uint8_t>(mode ? (t >> 3) & 0xfc : (t >> 2) & 0xf8);
        o[2] = static_cast<uint8_t>(mode ? (t >> 8) & 0xf8 : (t >> 7) & 0xf8);
      } else {
        std::memcpy(o, r + static_cast<size_t>(x) * (bpp / 8), 3);
      }
    }
  }
}

// ---------------------------------------------------------------- TIFF
// LZW as TIFF codes it (compression 5): MSB-first codes of 9 to 12 bits,
// 256 clear, 257 end of information, the width growing one code early
// (at 511, 1023, 2047 entries).  Decodes into dst, at most cap bytes;
// returns the bytes written, or -1 on a corrupt stream.
long io_lzw_decode(const uint8_t* src, long n, uint8_t* dst, long cap) {
  constexpr int kClear = 256, kEoi = 257, kMax = 4096;
  std::vector<int> prefix(kMax), length(kMax);
  std::vector<uint8_t> first(kMax), last(kMax);
  for (int i = 0; i < 256; ++i) {
    prefix[i] = -1;
    length[i] = 1;
    first[i] = last[i] = static_cast<uint8_t>(i);
  }
  long bitpos = 0, out = 0;
  const long nbits = n * 8;
  int width = 9, next = 258, old = -1;
  auto emit = [&](int code) {  // the string of `code`, written back to front
    const int len = length[code];
    long end = out + len;
    for (int c = code, k = len - 1; c >= 0; c = prefix[c], --k)
      if (out + k < cap) dst[out + k] = last[c];
    out = std::min(end, cap);
  };
  while (bitpos + width <= nbits && out < cap) {
    int code = 0;
    for (int b = 0; b < width; ++b, ++bitpos)
      code = (code << 1) | ((src[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    if (code == kEoi) break;
    if (code == kClear) {
      width = 9;
      next = 258;
      old = -1;
      continue;
    }
    if (old < 0) {
      if (code > 255) return -1;
      emit(code);
      old = code;
      continue;
    }
    if (code > next) return -1;
    if (next < kMax) {
      const int base = code < next ? code : old;
      prefix[next] = old;
      length[next] = length[old] + 1;
      first[next] = first[old];
      last[next] = first[base];
    }
    emit(code);
    old = code;
    if (next < kMax) ++next;
    if (next + 1 >= (1 << width) && width < 12) ++width;
  }
  return out;
}

// LZW-encode n bytes as libtiff does (a clear code first, a clear when the
// table fills, the final code, end of information); returns the bytes
// written, or -(bytes needed) when cap is too small.
long io_lzw_encode(const uint8_t* src, long n, uint8_t* dst, long cap) {
  constexpr int kClear = 256, kEoi = 257, kMax = 4096, kHash = 1 << 14;
  std::vector<int> keys(kHash, -1), vals(kHash);  // (code << 8 | byte) -> code
  long out = 0, bits = 0;
  uint32_t acc = 0;
  int width = 9, next = 258;
  auto put = [&](int code) {
    acc = (acc << width) | static_cast<uint32_t>(code);
    bits += width;
    while (bits >= 8) {
      bits -= 8;
      if (out < cap) dst[out] = static_cast<uint8_t>(acc >> bits);
      ++out;
    }
    acc &= (1u << bits) - 1;
  };
  auto slot = [&](int key) {
    int h = (key * 2654435761u) >> 18;
    while (keys[h] >= 0 && keys[h] != key) h = (h + 1) & (kHash - 1);
    return h;
  };
  auto added = [&]() {  // after an entry: a clear when the table is full, else maybe wider
    if (next == kMax - 2) {
      put(kClear);
      std::fill(keys.begin(), keys.end(), -1);
      next = 258;
      width = 9;
    } else if (next > (1 << width) - 1) {
      ++width;
    }
  };
  put(kClear);
  int ent = -1;
  for (long i = 0; i < n; ++i) {
    const int c = src[i];
    if (ent < 0) {
      ent = c;
      continue;
    }
    const int key = (ent << 8) | c;
    const int h = slot(key);
    if (keys[h] == key) {
      ent = vals[h];
      continue;
    }
    put(ent);
    keys[h] = key;
    vals[h] = next++;
    ent = c;
    added();
  }
  if (ent >= 0) {
    put(ent);
    ++next;
    added();
  }
  put(kEoi);
  if (bits > 0) {
    if (out < cap) dst[out] = static_cast<uint8_t>(acc << (8 - bits));
    ++out;
  }
  return out <= cap ? out : -out;
}

// PackBits (compression 32773) into dst, at most cap bytes; returns the
// bytes written.
long io_packbits_decode(const uint8_t* src, long n, uint8_t* dst, long cap) {
  long i = 0, out = 0;
  while (i < n && out < cap) {
    const int c = static_cast<int8_t>(src[i++]);
    if (c >= 0) {
      const long k = std::min<long>({c + 1L, n - i, cap - out});
      std::memcpy(dst + out, src + i, k);
      i += c + 1;
      out += k;
    } else if (c != -128) {
      if (i >= n) break;
      const long k = std::min<long>(1L - c, cap - out);
      std::memset(dst + out, src[i++], k);
      out += k;
    }
  }
  return out;
}

// TIFF predictor 2 (horizontal differencing) on `rows` rows of w pixels of
// spp samples, 1- or 2-byte samples (2: native-order uint16), in place:
// undone (sums) when encode is 0, applied (differences) otherwise.
void io_tiff_predictor(uint8_t* data, long rows, long w, int spp, int bytes, int encode) {
  const long n = w * spp;
  for (long y = 0; y < rows; ++y) {
    if (bytes == 2) {
      uint16_t* r = reinterpret_cast<uint16_t*>(data) + y * n;
      if (encode)
        for (long i = n - 1; i >= spp; --i) r[i] = static_cast<uint16_t>(r[i] - r[i - spp]);
      else
        for (long i = spp; i < n; ++i) r[i] = static_cast<uint16_t>(r[i] + r[i - spp]);
    } else {
      uint8_t* r = data + y * n;
      if (encode)
        for (long i = n - 1; i >= spp; --i) r[i] = static_cast<uint8_t>(r[i] - r[i - spp]);
      else
        for (long i = spp; i < n; ++i) r[i] = static_cast<uint8_t>(r[i] + r[i - spp]);
    }
  }
}

// ---------------------------------------------------------------- resize
// cv2 INTER_LINEAR on uint8: half-pixel centres, float positions, 11-bit
// coefficients; the horizontal pass in int, the vertical one as cv2's
// vector route does it (each row >> 4, a high-half 16-bit product with the
// coefficient, summed, + 2 >> 2).
namespace {
void linear_coeffs(int src, int dst, std::vector<int>& i0, std::vector<int>& i1,
                   std::vector<int>& c0, std::vector<int>& c1) {
  const double scale = static_cast<double>(src) / dst;
  i0.resize(dst); i1.resize(dst); c0.resize(dst); c1.resize(dst);
  for (int d = 0; d < dst; ++d) {
    float f = static_cast<float>((d + 0.5) * scale - 0.5);
    int s = static_cast<int>(std::floor(f));
    f -= s;
    if (s < 0) { f = 0; s = 0; }
    if (s >= src - 1) { f = 0; s = src - 1; }
    i0[d] = s;
    i1[d] = std::min(s + 1, src - 1);
    c0[d] = static_cast<int>(std::lrintf((1.f - f) * 2048.f));
    c1[d] = static_cast<int>(std::lrintf(f * 2048.f));
  }
}
}  // namespace

void io_resize_linear(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh, int dw, int cn) {
  std::vector<int> x0, x1, a0, a1, y0, y1, b0, b1;
  linear_coeffs(sw, dw, x0, x1, a0, a1);
  linear_coeffs(sh, dh, y0, y1, b0, b1);
  const size_t n = static_cast<size_t>(dw) * cn;
  std::vector<int> r0(n), r1(n);
  int have0 = -1, have1 = -1;
  auto hpass = [&](int y, std::vector<int>& out) {
    const uint8_t* row = src + static_cast<size_t>(y) * sw * cn;
    for (int x = 0; x < dw; ++x) {
      const uint8_t* p = row + static_cast<size_t>(x0[x]) * cn;
      const uint8_t* q = row + static_cast<size_t>(x1[x]) * cn;
      for (int c = 0; c < cn; ++c)
        out[static_cast<size_t>(x) * cn + c] = p[c] * a0[x] + q[c] * a1[x];
    }
  };
  for (int y = 0; y < dh; ++y) {
    if (have0 != y0[y]) {
      if (have1 == y0[y]) { std::swap(r0, r1); std::swap(have0, have1); }
      else { hpass(y0[y], r0); have0 = y0[y]; }
    }
    if (have1 != y1[y]) { hpass(y1[y], r1); have1 = y1[y]; }
    const int c0 = b0[y], c1 = b1[y];
    uint8_t* d = dst + static_cast<size_t>(y) * n;
    for (size_t k = 0; k < n; ++k) {
      const int v = (((r0[k] >> 4) * c0) >> 16) + (((r1[k] >> 4) * c1) >> 16);
      const int o = (v + 2) >> 2;
      d[k] = static_cast<uint8_t>(o < 0 ? 0 : o > 255 ? 255 : o);
    }
  }
}

// Area average (cv2 INTER_AREA semantics for downscale); separable, in
// float: the horizontal spans reduce each source row, the vertical
// coverage accumulates rows into output rows.
void io_resize_area(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh, int dw, int cn) {
  const float sx = static_cast<float>(sw) / dw;
  const float sy = static_cast<float>(sh) / dh;
  std::vector<int> xi;
  std::vector<float> xw;
  std::vector<int> xoff(dw + 1, 0);
  std::vector<float> xsum(dw, 0.0f);
  for (int x = 0; x < dw; ++x) {
    const float fx0 = x * sx, fx1 = (x + 1) * sx;
    const int ix0 = static_cast<int>(std::floor(fx0));
    const int ix1 = std::min(static_cast<int>(std::ceil(fx1)), sw);
    for (int xx = ix0; xx < ix1; ++xx) {
      const float cov = std::min(fx1, xx + 1.0f) - std::max(fx0, static_cast<float>(xx));
      xi.push_back(xx * cn);
      xw.push_back(cov);
      xsum[x] += cov;
    }
    xoff[x + 1] = static_cast<int>(xi.size());
  }
  const size_t n = static_cast<size_t>(dw) * cn;
  std::vector<float> hrow(n), acc(n, 0.0f), area(dw, 0.0f);
  int cur = 0;
  for (int yy = 0; yy < sh && cur < dh; ++yy) {
    const uint8_t* row = src + static_cast<size_t>(yy) * sw * cn;
    for (int x = 0; x < dw; ++x) {
      for (int c = 0; c < cn; ++c) {
        float a = 0;
        for (int k = xoff[x]; k < xoff[x + 1]; ++k) a += row[xi[k] + c] * xw[k];
        hrow[static_cast<size_t>(x) * cn + c] = a;
      }
    }
    bool more = true;
    while (more && cur < dh) {
      const float fy1 = (cur + 1) * sy;
      float cy = std::min(fy1, yy + 1.0f) - std::max(static_cast<float>(cur) * sy, static_cast<float>(yy));
      cy = std::max(cy, 0.0f);
      if (cy > 0) {
        for (size_t k = 0; k < n; ++k) acc[k] += hrow[k] * cy;
        for (int x = 0; x < dw; ++x) area[x] += xsum[x] * cy;
      }
      if (fy1 <= yy + 1.0f + 1e-6f) {  // this output row ends within the source row
        uint8_t* d = dst + static_cast<size_t>(cur) * dw * cn;
        for (int x = 0; x < dw; ++x)
          for (int c = 0; c < cn; ++c)
            d[static_cast<size_t>(x) * cn + c] =
                static_cast<uint8_t>(acc[static_cast<size_t>(x) * cn + c] / area[x] + 0.5f);
        std::fill(acc.begin(), acc.end(), 0.0f);
        std::fill(area.begin(), area.end(), 0.0f);
        ++cur;
      } else {
        more = false;
      }
    }
  }
  if (cur < dh) {  // a last row left open by rounding
    uint8_t* d = dst + static_cast<size_t>(cur) * dw * cn;
    for (int x = 0; x < dw; ++x)
      for (int c = 0; c < cn; ++c)
        d[static_cast<size_t>(x) * cn + c] = static_cast<uint8_t>(
            area[x] > 0 ? acc[static_cast<size_t>(x) * cn + c] / area[x] + 0.5f : 114);
  }
}

// ---------------------------------------------------------------- warps
// dst(x, y) = src(Minv (x, y, 1)): minv is the 3x3 inverse map (row-major,
// double; the last row 0 0 1 for an affine warp).  Bilinear in float, taps
// outside the source read `border`.
void io_warp(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh, int dw, int cn,
             const double* minv, int perspective, int border) {
  const float m0 = static_cast<float>(minv[0]), m1 = static_cast<float>(minv[1]),
              m2 = static_cast<float>(minv[2]), m3 = static_cast<float>(minv[3]),
              m4 = static_cast<float>(minv[4]), m5 = static_cast<float>(minv[5]);
  const uint8_t bv = static_cast<uint8_t>(border);
  std::vector<uint8_t> bpx(cn, bv);
  for (int y = 0; y < dh; ++y) {
    uint8_t* d = dst + static_cast<size_t>(y) * dw * cn;
    for (int x = 0; x < dw; ++x) {
      float X, Y;
      if (perspective) {
        const double w = minv[6] * x + minv[7] * y + minv[8];
        const double iw = w != 0 ? 1.0 / w : 0.0;
        X = static_cast<float>((minv[0] * x + minv[1] * y + minv[2]) * iw);
        Y = static_cast<float>((minv[3] * x + minv[4] * y + minv[5]) * iw);
      } else {
        X = m0 * x + m1 * y + m2;
        Y = m3 * x + m4 * y + m5;
      }
      uint8_t* o = d + static_cast<size_t>(x) * cn;
      if (!(X > -1.0f && Y > -1.0f && X < sw && Y < sh)) {
        for (int c = 0; c < cn; ++c) o[c] = bv;
        continue;
      }
      const int x0 = static_cast<int>(std::floor(X)), y0 = static_cast<int>(std::floor(Y));
      const float ax = X - x0, ay = Y - y0;
      const uint8_t* p[4];
      const int xs[2] = {x0, x0 + 1}, ys[2] = {y0, y0 + 1};
      for (int j = 0; j < 2; ++j)
        for (int i = 0; i < 2; ++i) {
          const int xx = xs[i], yy = ys[j];
          p[j * 2 + i] = (xx >= 0 && xx < sw && yy >= 0 && yy < sh)
                             ? src + (static_cast<size_t>(yy) * sw + xx) * cn
                             : bpx.data();
        }
      for (int c = 0; c < cn; ++c) {
        const float t = p[0][c] + ax * (p[1][c] - p[0][c]);
        const float b = p[2][c] + ax * (p[3][c] - p[2][c]);
        o[c] = sat_u8(t + ay * (b - t));
      }
    }
  }
}

// ---------------------------------------------------------------- colour
// In place on n BGR pixels: BGR -> HSV (cv2's 8-bit integer tables, H in
// [0, 180)), the three lookup tables, HSV -> BGR (cv2's float formula).
// lut_h/lut_s/lut_v may be null for the plain conversions below.
namespace {
struct HsvTables {
  int sdiv[256], hdiv[256];
  HsvTables() {
    const int shift = 12;
    sdiv[0] = hdiv[0] = 0;
    for (int i = 1; i < 256; ++i) {
      sdiv[i] = static_cast<int>(std::lround((255 << shift) / (1.0 * i)));
      hdiv[i] = static_cast<int>(std::lround((180 << shift) / (6.0 * i)));
    }
  }
};
const HsvTables& tables() {
  static const HsvTables t;
  return t;
}

inline void bgr2hsv_px(const uint8_t* p, uint8_t* q, const HsvTables& t) {
  const int shift = 12;
  const int b = p[0], g = p[1], r = p[2];
  const int v = std::max(std::max(b, g), r);
  const int vmin = std::min(std::min(b, g), r);
  const int diff = v - vmin;
  const int s = (diff * t.sdiv[v] + (1 << (shift - 1))) >> shift;
  int h = v == r ? g - b : v == g ? b - r + 2 * diff : r - g + 4 * diff;
  h = (h * t.hdiv[diff] + (1 << (shift - 1))) >> shift;
  h += h < 0 ? 180 : 0;
  q[0] = static_cast<uint8_t>(h);
  q[1] = static_cast<uint8_t>(s);
  q[2] = static_cast<uint8_t>(v);
}

inline void hsv2bgr_px(const uint8_t* p, uint8_t* q) {
  static const int sector_data[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1},
                                        {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};
  float h = p[0];
  const float s = p[1] * (1.f / 255.f), v = p[2] * (1.f / 255.f);
  float b, g, r;
  if (s == 0) {
    b = g = r = v;
  } else {
    h *= 6.f / 180.f;
    while (h >= 6) h -= 6;
    int sector = static_cast<int>(std::floor(h));
    h -= sector;
    if (static_cast<unsigned>(sector) >= 6u) { sector = 0; h = 0.f; }
    // (1 - s h) rounded once, as cv2's scalar route computes it (a fused
    // multiply-add there); the product of two floats is exact in double
    float tab[4];
    tab[0] = v;
    tab[1] = v * (1.f - s);
    tab[2] = v * static_cast<float>(1.0 - static_cast<double>(s) * h);
    tab[3] = v * static_cast<float>(1.0 - static_cast<double>(s) * (1.f - h));
    b = tab[sector_data[sector][0]];
    g = tab[sector_data[sector][1]];
    r = tab[sector_data[sector][2]];
  }
  q[0] = sat_u8(b * 255.f);
  q[1] = sat_u8(g * 255.f);
  q[2] = sat_u8(r * 255.f);
}
}  // namespace

void io_bgr2hsv(const uint8_t* src, uint8_t* dst, long n) {
  const HsvTables& t = tables();
  for (long i = 0; i < n; ++i) bgr2hsv_px(src + 3 * i, dst + 3 * i, t);
}

void io_hsv2bgr(const uint8_t* src, uint8_t* dst, long n) {
  for (long i = 0; i < n; ++i) hsv2bgr_px(src + 3 * i, dst + 3 * i);
}

void io_hsv_lut(uint8_t* img, long n, const uint8_t* lut_h, const uint8_t* lut_s,
                const uint8_t* lut_v) {
  const HsvTables& t = tables();
  uint8_t hsv[3];
  for (long i = 0; i < n; ++i) {
    uint8_t* p = img + 3 * i;
    bgr2hsv_px(p, hsv, t);
    hsv[0] = lut_h[hsv[0]];
    hsv[1] = lut_s[hsv[1]];
    hsv[2] = lut_v[hsv[2]];
    hsv2bgr_px(hsv, p);
  }
}

// ---------------------------------------------------------------- LAB
// 8-bit sRGB BGR <-> CIE L*a*b* (D65), cv2's integer route (color_lab.cpp:
// RGB2Lab_b, Lab2RGBinteger), bit-exact over all 2^24 inputs each way.  Its tables are built in IEEE
// single precision with correct rounding (cv2's softfloat), which plain
// float arithmetic reproduces with contraction off; the gamma curves in
// double.  L in [0, 255] is L* 255 / 100; a, b are offset by 128.
namespace {
constexpr int kLabShift = 12, kGammaShift = 3, kLabShift2 = kLabShift + kGammaShift;
constexpr int kCbrtTab = 256 * 3 / 2 * (1 << kGammaShift);
constexpr int kInvGammaShift = 12, kInvGammaTab = 1 << kInvGammaShift;
constexpr int kBase = 1 << 14, kMinAB = -8145, kABTab = kBase * 9 / 4;

inline int descale(long v, int n) { return static_cast<int>((v + (1L << (n - 1))) >> n); }

// round half to even of a float, as cvRound(softfloat)
inline int rne(float v) { return static_cast<int>(std::nearbyintf(v)); }

#pragma GCC push_options
#pragma GCC optimize("fp-contract=off")
struct LabTables {
  uint16_t gamma[256];            // sRGB -> linear, 255 << 3 scale
  uint16_t cbrt[kCbrtTab];        // f(t) of CIE, 1 << 15 scale
  uint16_t inv_gamma[kInvGammaTab];
  int ab_to_xz[kABTab];
  uint16_t l_to_yf[256 * 2];
  int fwd[9], inv[9];             // rows X, Y, Z by (b, g, r); rows r, g, b by (x, y, z)
  LabTables() {
    const double g_thresh = 809.0 / 20000, g_inv_thresh = 7827.0 / 2500000;
    const double g_low = 323.0 / 25, g_power = 12.0 / 5, g_shift = 11.0 / 200;
    const float f255 = 255.f;
    for (int i = 0; i < 256; ++i) {
      const double x = static_cast<float>(i) / f255;
      const float lin = static_cast<float>(
          x <= g_thresh ? x / g_low : std::pow((x + g_shift) / (1.0 + g_shift), g_power));
      gamma[i] = static_cast<uint16_t>(rne(static_cast<float>(255 * (1 << kGammaShift)) * lin));
    }
    const float cb_scale = 1.f / static_cast<float>(255 * (1 << kGammaShift));
    const float lthresh = 216.f / 24389.f, lscale = 841.f / 108.f, lbias = 16.f / 116.f;
    for (int i = 0; i < kCbrtTab; ++i) {
      const float x = cb_scale * static_cast<float>(i);
      // cv2's softfloat cube root lands on the float at or below the true
      // root (which decides entry 324); the double root, truncated, does
      const double root = std::cbrt(static_cast<double>(x));
      float fr = static_cast<float>(root);
      if (fr > root) fr = std::nextafterf(fr, 0.f);
      const float f = x < lthresh ? std::fmaf(x, lscale, lbias) : fr;
      cbrt[i] = static_cast<uint16_t>(rne(static_cast<float>(1 << kLabShift2) * f));
    }
    const float inv_scale = 1.f / static_cast<float>(kInvGammaTab);
    for (int i = 0; i < kInvGammaTab; ++i) {
      const double x = inv_scale * static_cast<float>(i);
      const float s = static_cast<float>(
          x <= g_inv_thresh ? x * g_low : std::pow(x, 1.0 / g_power) * (1.0 + g_shift) - g_shift);
      inv_gamma[i] = static_cast<uint16_t>(rne(f255 * s));
    }
    for (int i = kMinAB; i < kABTab + kMinAB; ++i)
      ab_to_xz[i - kMinAB] = i <= 3390 ? i * 108 / 841 - kBase * 16 / 116 * 108 / 841
                                       : i * i / kBase * i / kBase;
    for (int i = 0; i < 256; ++i) {
      int y, ify;
      if (i <= 20) {
        y = rne(static_cast<float>(i * kBase * 20 * 9) / static_cast<float>(17 * 29 * 29 * 29));
        ify = rne(static_cast<float>(kBase) *
                  (16.f / 116.f + static_cast<float>(i * 5) / static_cast<float>(3 * 17 * 29)));
      } else {
        const float fy = static_cast<float>(i * 100 * kBase) / static_cast<float>(255 * 116) +
                         static_cast<float>(16 * kBase) / 116.f;
        ify = rne(fy);
        y = rne(fy * fy / static_cast<float>(kBase) * fy / static_cast<float>(kBase));
      }
      l_to_yf[2 * i] = static_cast<uint16_t>(y);
      l_to_yf[2 * i + 1] = static_cast<uint16_t>(ify);
    }
    static const double rgb2xyz[9] = {0.412453, 0.357580, 0.180423, 0.212671, 0.715160,
                                      0.072169, 0.019334, 0.119193, 0.950227};
    static const double xyz2rgb[9] = {3.240479, -1.53715, -0.498535, -0.969256, 1.875991,
                                      0.041556, 0.055648, -0.204043, 1.057311};
    static const double white[3] = {0.950456, 1.0, 1.088754};
    const double ls = 1 << kLabShift;
    for (int i = 0; i < 3; ++i) {      // X, Y, Z from b, g, r
      fwd[i * 3 + 0] = static_cast<int>(std::nearbyint(ls * rgb2xyz[i * 3 + 2] / white[i]));
      fwd[i * 3 + 1] = static_cast<int>(std::nearbyint(ls * rgb2xyz[i * 3 + 1] / white[i]));
      fwd[i * 3 + 2] = static_cast<int>(std::nearbyint(ls * rgb2xyz[i * 3 + 0] / white[i]));
    }
    for (int r = 0; r < 3; ++r)        // r, g, b from x, y, z
      for (int j = 0; j < 3; ++j)
        inv[r * 3 + j] = static_cast<int>(std::nearbyint(ls * xyz2rgb[r * 3 + j] * white[j]));
  }
};
#pragma GCC pop_options

const LabTables& lab_tables() {
  static const LabTables t;
  return t;
}
}  // namespace

void io_bgr2lab(const uint8_t* src, uint8_t* dst, long n) {
  const LabTables& t = lab_tables();
  const int lscale = (116 * 255 + 50) / 100, lshift = -((16 * 255 * (1 << kLabShift2) + 50) / 100);
  for (long i = 0; i < n; ++i) {
    const int b = t.gamma[src[3 * i]], g = t.gamma[src[3 * i + 1]], r = t.gamma[src[3 * i + 2]];
    const int fx = t.cbrt[descale(b * t.fwd[0] + g * t.fwd[1] + r * t.fwd[2], kLabShift)];
    const int fy = t.cbrt[descale(b * t.fwd[3] + g * t.fwd[4] + r * t.fwd[5], kLabShift)];
    const int fz = t.cbrt[descale(b * t.fwd[6] + g * t.fwd[7] + r * t.fwd[8], kLabShift)];
    const int l = descale(lscale * fy + lshift, kLabShift2);
    const int a = descale(500 * (fx - fy) + 128 * (1 << kLabShift2), kLabShift2);
    const int bb = descale(200 * (fy - fz) + 128 * (1 << kLabShift2), kLabShift2);
    dst[3 * i] = static_cast<uint8_t>(std::min(std::max(l, 0), 255));
    dst[3 * i + 1] = static_cast<uint8_t>(std::min(std::max(a, 0), 255));
    dst[3 * i + 2] = static_cast<uint8_t>(std::min(std::max(bb, 0), 255));
  }
}

void io_lab2bgr(const uint8_t* src, uint8_t* dst, long n) {
  const LabTables& t = lab_tables();
  const int shift = kLabShift + (14 - kInvGammaShift);
  for (long i = 0; i < n; ++i) {
    const int ll = src[3 * i], aa = src[3 * i + 1], bb = src[3 * i + 2];
    const int y = t.l_to_yf[2 * ll], ify = t.l_to_yf[2 * ll + 1];
    const int adiv = ((5 * aa * 53687 + (1 << 7)) >> 13) - 128 * kBase / 500;
    const int bdiv = ((bb * 41943 + (1 << 4)) >> 9) - 128 * kBase / 200 + 1;
    const int x = t.ab_to_xz[ify + adiv - kMinAB], z = t.ab_to_xz[ify - bdiv - kMinAB];
    int c[3];
    for (int k = 0; k < 3; ++k) {
      const int v = descale(static_cast<long>(t.inv[k * 3]) * x + static_cast<long>(t.inv[k * 3 + 1]) * y +
                            static_cast<long>(t.inv[k * 3 + 2]) * z, shift);
      c[k] = t.inv_gamma[std::min(std::max(v, 0), kInvGammaTab - 1)];
    }
    dst[3 * i] = static_cast<uint8_t>(c[2]);
    dst[3 * i + 1] = static_cast<uint8_t>(c[1]);
    dst[3 * i + 2] = static_cast<uint8_t>(c[0]);
  }
}

// Contrast-limited adaptive histogram equalisation of one uint8 channel
// (h, w), as cv2.createCLAHE(clip_limit, (tiles, tiles)).apply: where the
// grid does not divide the image, the histograms are taken on the image
// padded by reflect-101 at the bottom and right to the next multiple (a
// whole extra tile on a side that divides); clip = max(1, clip_limit *
// tile area / 256); the excess is spread evenly, then the residual one a
// step; the LUT is the running sum * 255 / area; each pixel interpolates
// bilinearly, in float, between the LUTs of its four nearest tiles.
void io_clahe(const uint8_t* src, int h, int w, double clip_limit, int tiles, uint8_t* dst) {
  const bool fits = w % tiles == 0 && h % tiles == 0;
  const int tw = fits ? w / tiles : (w + tiles - w % tiles) / tiles;
  const int th = fits ? h / tiles : (h + tiles - h % tiles) / tiles;
  auto reflect = [](int p, int len) {
    if (len == 1) return 0;
    while (p < 0 || p >= len) p = p < 0 ? -p : 2 * len - p - 2;
    return p;
  };
  const int area = tw * th;
  const float lut_scale = 255.f / static_cast<float>(area);
  int clip = 0;
  if (clip_limit > 0.0) clip = std::max(static_cast<int>(clip_limit * area / 256), 1);
  std::vector<uint8_t> lut(static_cast<size_t>(tiles) * tiles * 256);
  std::vector<int> xs(tw);
  for (int ty = 0; ty < tiles; ++ty)
    for (int tx = 0; tx < tiles; ++tx) {
      int hist[256] = {0};
      for (int i = 0; i < tw; ++i) xs[i] = reflect(tx * tw + i, w);
      for (int j = 0; j < th; ++j) {
        const uint8_t* row = src + static_cast<size_t>(reflect(ty * th + j, h)) * w;
        for (int i = 0; i < tw; ++i) ++hist[row[xs[i]]];
      }
      if (clip > 0) {
        int clipped = 0;
        for (int i = 0; i < 256; ++i)
          if (hist[i] > clip) {
            clipped += hist[i] - clip;
            hist[i] = clip;
          }
        const int batch = clipped / 256;
        int residual = clipped - batch * 256;
        for (int i = 0; i < 256; ++i) hist[i] += batch;
        if (residual != 0) {
          const int step = std::max(256 / residual, 1);
          for (int i = 0; i < 256 && residual > 0; i += step, --residual) ++hist[i];
        }
      }
      uint8_t* l = lut.data() + (static_cast<size_t>(ty) * tiles + tx) * 256;
      int sum = 0;
      for (int i = 0; i < 256; ++i) {
        sum += hist[i];
        l[i] = sat_u8(static_cast<float>(sum) * lut_scale);
      }
    }
  std::vector<int> ix1(w), ix2(w);
  std::vector<float> xa(w), xa1(w);
  const float inv_tw = 1.f / static_cast<float>(tw), inv_th = 1.f / static_cast<float>(th);
  for (int x = 0; x < w; ++x) {
    const float txf = static_cast<float>(x) * inv_tw - 0.5f;
    const int t1 = static_cast<int>(std::floor(txf));
    xa[x] = txf - static_cast<float>(t1);
    xa1[x] = 1.f - xa[x];
    ix1[x] = std::max(t1, 0) * 256;
    ix2[x] = std::min(t1 + 1, tiles - 1) * 256;
  }
  for (int y = 0; y < h; ++y) {
    const float tyf = static_cast<float>(y) * inv_th - 0.5f;
    const int t1 = static_cast<int>(std::floor(tyf));
    const float ya = tyf - static_cast<float>(t1), ya1 = 1.f - ya;
    const uint8_t* p1 = lut.data() + static_cast<size_t>(std::max(t1, 0)) * tiles * 256;
    const uint8_t* p2 = lut.data() + static_cast<size_t>(std::min(t1 + 1, tiles - 1)) * tiles * 256;
    const uint8_t* row = src + static_cast<size_t>(y) * w;
    uint8_t* out = dst + static_cast<size_t>(y) * w;
    for (int x = 0; x < w; ++x) {
      const int v = row[x];
      const float top = static_cast<float>(p1[ix1[x] + v]) * xa1[x] + static_cast<float>(p1[ix2[x] + v]) * xa[x];
      const float bot = static_cast<float>(p2[ix1[x] + v]) * xa1[x] + static_cast<float>(p2[ix2[x] + v]) * xa[x];
      out[x] = sat_u8(top * ya1 + bot * ya);
    }
  }
}

// ---------------------------------------------------------------- filters
// Median over a k x k window (k odd), edges replicated (cv2.medianBlur).
void io_median(const uint8_t* src, int h, int w, int cn, int k, uint8_t* dst) {
  const int r = k / 2;
  std::vector<uint8_t> win(static_cast<size_t>(k) * k);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x)
      for (int c = 0; c < cn; ++c) {
        int m = 0;
        for (int dy = -r; dy <= r; ++dy) {
          const int yy = std::min(std::max(y + dy, 0), h - 1);
          for (int dx = -r; dx <= r; ++dx) {
            const int xx = std::min(std::max(x + dx, 0), w - 1);
            win[m++] = src[(static_cast<size_t>(yy) * w + xx) * cn + c];
          }
        }
        std::nth_element(win.begin(), win.begin() + m / 2, win.begin() + m);
        dst[(static_cast<size_t>(y) * w + x) * cn + c] = win[m / 2];
      }
}

// ---------------------------------------------------------------- raster
// Filled shapes on an (h, w, cn) uint8 image, clipped to it.

// Horizontal span [x0, x1] on row y.
static inline void span(uint8_t* img, int h, int w, int cn, int y, int x0, int x1,
                        const uint8_t* color) {
  if (y < 0 || y >= h) return;
  x0 = std::max(x0, 0);
  x1 = std::min(x1, w - 1);
  for (int x = x0; x <= x1; ++x)
    std::memcpy(img + (static_cast<size_t>(y) * w + x) * cn, color, cn);
}

// One-pixel 8-connected line from (x0, y0) to (x1, y1), both ends drawn.
void io_line(uint8_t* img, int h, int w, int cn, int x0, int y0, int x1, int y1,
             const uint8_t* color) {
  const int dx = std::abs(x1 - x0), dy = std::abs(y1 - y0);
  const int sx = x0 < x1 ? 1 : -1, sy = y0 < y1 ? 1 : -1;
  const int n = std::max(dx, dy);
  const bool inside = x0 >= 0 && x0 < w && y0 >= 0 && y0 < h && x1 >= 0 && x1 < w && y1 >= 0 && y1 < h;
  if (!inside && n > 0) {  // clip to the image first, as cv2 does
    double t0 = 0, t1 = 1;
    const double px = x0, py = y0, qx = x1 - x0, qy = y1 - y0;
    const double lo[2] = {0.0, 0.0}, hi[2] = {w - 1.0, h - 1.0};
    const double p[2] = {px, py}, q[2] = {qx, qy};
    for (int a = 0; a < 2; ++a) {
      if (q[a] == 0) {
        if (p[a] < lo[a] || p[a] > hi[a]) return;
        continue;
      }
      double ta = (lo[a] - p[a]) / q[a], tb = (hi[a] - p[a]) / q[a];
      if (ta > tb) std::swap(ta, tb);
      t0 = std::max(t0, ta);
      t1 = std::min(t1, tb);
    }
    if (t0 > t1) return;
    auto cx = [&](double v) { return std::min(std::max(static_cast<int>(std::lround(v)), 0), w - 1); };
    auto cy = [&](double v) { return std::min(std::max(static_cast<int>(std::lround(v)), 0), h - 1); };
    // both ends inside now, so the call below draws without clipping again
    io_line(img, h, w, cn, cx(px + qx * t0), cy(py + qy * t0), cx(px + qx * t1), cy(py + qy * t1),
            color);
    return;
  }
  int err = dx - dy, x = x0, y = y0;
  for (;;) {
    if (x >= 0 && x < w && y >= 0 && y < h)
      std::memcpy(img + (static_cast<size_t>(y) * w + x) * cn, color, cn);
    if (x == x1 && y == y1) break;
    const int e2 = 2 * err;
    if (e2 > -dy) { err -= dy; x += sx; }
    if (e2 < dx) { err += dx; y += sy; }
  }
}

// Filled polygon of n integer vertices (x, y interleaved): every pixel
// whose centre lies inside (even-odd), plus the outline, as cv2.fillPoly
// draws both.
void io_fill_poly(uint8_t* img, int h, int w, int cn, const int* pts, int n,
                  const uint8_t* color) {
  if (n <= 0) return;
  int ymin = pts[1], ymax = pts[1];
  for (int i = 1; i < n; ++i) {
    ymin = std::min(ymin, pts[2 * i + 1]);
    ymax = std::max(ymax, pts[2 * i + 1]);
  }
  ymin = std::max(ymin, 0);
  ymax = std::min(ymax, h - 1);
  std::vector<double> xs;
  for (int y = ymin; y <= ymax; ++y) {
    xs.clear();
    const double yc = y;
    for (int i = 0; i < n; ++i) {
      const int j = (i + 1) % n;
      const double ya = pts[2 * i + 1], yb = pts[2 * j + 1];
      if ((ya <= yc && yb > yc) || (yb <= yc && ya > yc)) {
        const double xa = pts[2 * i], xb = pts[2 * j];
        xs.push_back(xa + (yc - ya) * (xb - xa) / (yb - ya));
      }
    }
    std::sort(xs.begin(), xs.end());
    for (size_t k = 0; k + 1 < xs.size(); k += 2)
      span(img, h, w, cn, y, static_cast<int>(std::ceil(xs[k])),
           static_cast<int>(std::floor(xs[k + 1])), color);
  }
  for (int i = 0; i < n; ++i) {
    const int j = (i + 1) % n;
    io_line(img, h, w, cn, pts[2 * i], pts[2 * i + 1], pts[2 * j], pts[2 * j + 1], color);
  }
}

// Filled circle of radius r about (cx, cy): the pixels with
// dx^2 + dy^2 <= r^2, as cv2 fills it.
void io_fill_circle(uint8_t* img, int h, int w, int cn, int cx, int cy, int r,
                    const uint8_t* color) {
  if (r < 0) return;
  const long lim = static_cast<long>(r) * r;
  for (int dy = -r; dy <= r; ++dy) {
    const long rest = lim - static_cast<long>(dy) * dy;
    int dx = static_cast<int>(std::floor(std::sqrt(static_cast<double>(rest))));
    while (static_cast<long>(dx + 1) * (dx + 1) <= rest) ++dx;
    while (dx > 0 && static_cast<long>(dx) * dx > rest) --dx;
    span(img, h, w, cn, cy + dy, cx - dx, cx + dx, color);
  }
}


// The outline of the rectangle with corners (x1, y1), (x2, y2), as
// cv2.rectangle draws it 8-connected: one-pixel lines for t <= 1; else
// each side a band r = t / 2 + t % 2 pixels either side of it, and a
// filled circle of radius r at each corner (cv2's thick-line caps).
void io_rectangle(uint8_t* img, int h, int w, int cn, int x1, int y1, int x2, int y2, int t,
                  const uint8_t* color) {
  if (t <= 1) {
    io_line(img, h, w, cn, x1, y1, x2, y1, color);
    io_line(img, h, w, cn, x2, y1, x2, y2, color);
    io_line(img, h, w, cn, x2, y2, x1, y2, color);
    io_line(img, h, w, cn, x1, y2, x1, y1, color);
    return;
  }
  const int r = (t + 1) / 2;
  const int xa = std::min(x1, x2), xb = std::max(x1, x2);
  const int ya = std::min(y1, y2), yb = std::max(y1, y2);
  for (const int y : {y1, y2})
    for (int yy = y - r; yy <= y + r; ++yy) span(img, h, w, cn, yy, xa, xb, color);
  for (const int x : {x1, x2})
    for (int yy = ya; yy <= yb; ++yy) span(img, h, w, cn, yy, x - r, x + r, color);
  const int corners[4][2] = {{x1, y1}, {x2, y1}, {x2, y2}, {x1, y2}};
  for (const auto& c : corners) io_fill_circle(img, h, w, cn, c[0], c[1], r, color);
}

// Anti-aliased polyline of n integer vertices (x, y interleaved), closed
// when `closed`, as cv2's LINE_AA draws it: with thickness t > 1 every
// pixel within t / 2 of a segment is solid (the filled band with its
// round caps); the pixels outside it, and all of a one-pixel line, blend
// the colour in by an 8-bit alpha of their distance e beyond the band,
// 256 * 0.91 * exp(-e^2 / 0.7): 232 on a thin line, 55 a pixel off, the
// profile of cv2's LineAA across a line, to 1.75 pixels.  The segments form one shape,
// so a pixel near two of them blends once.
void io_polyline_aa(uint8_t* img, int h, int w, int cn, const int* pts, int n, int closed,
                    int thickness, const uint8_t* color) {
  static const std::vector<int> ramp = [] {
    std::vector<int> t(28);  // to 1.75 pixels beyond the band; cv2 draws nothing at 2
    for (int i = 0; i < 28; ++i) {
      const double e = i / 16.0;
      t[i] = static_cast<int>(std::lround(256 * 0.91 * std::exp(-e * e / 0.7)));
    }
    return t;
  }();
  if (n <= 0) return;
  const double r = thickness > 1 ? thickness / 2.0 : 0.0;
  const int pad = static_cast<int>(std::ceil(r)) + 4;
  const int nseg = n == 1 ? 1 : (closed ? n : n - 1);
  std::vector<int> box(4 * nseg);  // x0, y0, x1, y1 of each segment's reach
  for (int s = 0; s < nseg; ++s) {
    const int a = s, b = (s + 1) % n;
    box[4 * s] = std::max(std::min(pts[2 * a], pts[2 * b]) - pad, 0);
    box[4 * s + 1] = std::max(std::min(pts[2 * a + 1], pts[2 * b + 1]) - pad, 0);
    box[4 * s + 2] = std::min(std::max(pts[2 * a], pts[2 * b]) + pad, w - 1);
    box[4 * s + 3] = std::min(std::max(pts[2 * a + 1], pts[2 * b + 1]) + pad, h - 1);
  }
  auto dist = [&](double px, double py) {
    double best = 1e300;
    for (int s = 0; s < nseg; ++s) {
      const int a = s, b = (s + 1) % n;
      const double ax = pts[2 * a], ay = pts[2 * a + 1];
      const double dx = pts[2 * b] - ax, dy = pts[2 * b + 1] - ay;
      const double len2 = dx * dx + dy * dy;
      double t = len2 > 0 ? ((px - ax) * dx + (py - ay) * dy) / len2 : 0.0;
      t = std::min(std::max(t, 0.0), 1.0);
      const double ex = px - ax - t * dx, ey = py - ay - t * dy;
      best = std::min(best, ex * ex + ey * ey);
    }
    return std::sqrt(best);
  };
  for (int s = 0; s < nseg; ++s)
    for (int y = box[4 * s + 1]; y <= box[4 * s + 3]; ++y)
      for (int x = box[4 * s]; x <= box[4 * s + 2]; ++x) {
        bool seen = false;  // in an earlier segment's reach: drawn there
        for (int j = 0; j < s && !seen; ++j)
          seen = x >= box[4 * j] && x <= box[4 * j + 2] && y >= box[4 * j + 1] && y <= box[4 * j + 3];
        if (seen) continue;
        const double d = dist(x, y);
        uint8_t* p = img + (static_cast<size_t>(y) * w + x) * cn;
        if (thickness > 1 && d <= r) {
          std::memcpy(p, color, cn);
          continue;
        }
        const int i = static_cast<int>(std::lround((d - r) * 16));
        if (i >= static_cast<int>(ramp.size())) continue;
        const int a = ramp[i];
        for (int c = 0; c < cn; ++c) p[c] = static_cast<uint8_t>(p[c] + (((color[c] - p[c]) * a + 127) >> 8));
      }
}

// Text with its baseline's left end at (x, y), as cv2.putText places it;
// `scale` is cv2's fontScale; clipped to the image.  Characters outside
// printable ASCII draw as '?'.
void io_put_text(uint8_t* img, int h, int w, int cn, const char* text, int x, int y,
                 double scale, int thickness, const uint8_t* color) {
  if (!(scale > 0)) return;
  const int grow = std::max(thickness, 1) - 1;
  const int rows = static_cast<int>(std::ceil(kFontRows * scale));
  const int y_top = y - static_cast<int>(std::lround(kFontAscent * scale));
  double pen = x;
  for (const char* p = text; *p; ++p) {
    int c = static_cast<unsigned char>(*p);
    if (c < 32 || c > 126) c = '?';
    const uint32_t* g = kFont[c - 32];
    const int x0 = static_cast<int>(std::lround(pen + kFontLeft * scale));
    const int cols = static_cast<int>(std::ceil(32 * scale));
    for (int dy = 0; dy < rows; ++dy) {
      const int fy0 = static_cast<int>(dy / scale);
      const int fy1 = std::min(kFontRows, std::max(fy0 + 1, static_cast<int>(std::ceil((dy + 1) / scale))));
      uint32_t any = 0;
      for (int fy = fy0; fy < fy1; ++fy) any |= g[1 + fy];
      if (!any) continue;
      for (int dx = 0; dx < cols; ++dx) {
        const int fx0 = static_cast<int>(dx / scale);
        const int fx1 = std::min(32, std::max(fx0 + 1, static_cast<int>(std::ceil((dx + 1) / scale))));
        if (fx0 >= 32) break;
        const uint32_t band = fx1 - fx0 >= 32 ? 0xffffffffu : ((1u << (fx1 - fx0)) - 1u) << fx0;
        if (!(any & band)) continue;
        bool on = false;
        for (int fy = fy0; fy < fy1 && !on; ++fy) on = (g[1 + fy] & band) != 0;
        if (!on) continue;
        for (int yy = y_top + dy; yy <= y_top + dy + grow; ++yy)
          span(img, h, w, cn, yy, x0 + dx, x0 + dx + grow, color);
      }
    }
    pen += g[0] * scale;
  }
}

}  // extern "C"
