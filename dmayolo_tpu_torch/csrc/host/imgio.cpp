// imgio: the port's host image library (decode, encode, resample, colour,
// raster), called through ctypes from dmayolo_tpu_torch/data/imageio.py
// and data/cvops.py.  ctypes releases the GIL around every call, so the
// loader's threads run these loops in parallel.
//
// Pixels are interleaved uint8, BGR for colour images as OpenCV keeps them.
// JPEG goes through the system's libjpeg(-turbo) and is compiled in only
// when <jpeglib.h> is found (IMGIO_JPEG, set by utils/cuda_build.py).
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

}  // namespace

extern "C" {

int io_has_jpeg() {
#ifdef IMGIO_JPEG
  return 1;
#else
  return 0;
#endif
}

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
int io_jpeg_decode(const uint8_t* buf, unsigned long len, uint8_t* out, int h, int w) {
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

}  // extern "C"
