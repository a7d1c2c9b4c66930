// int8 post-training-quantized convolution (K4): bf16 / f32 or s8 NHWC
// input x s8 weights -> s32 sums -> dequantized bf16 or f32 NHWC output,
// and the input quantize.
//
// Replaces no TPU kernel: the JAX package runs its int8 conv as an XLA op
// (dmayolo_tpu/nn/primitives.py::Conv2d._int8_conv, :134-166), and stock
// PyTorch has no int8 convolution for CUDA tensors.  It serves every conv
// that `nn/quant.py` calibrates (g = 1, C1 >= 16, not DFL).
//
// What it computes, as the jitted JAX program rounds it:
//   * x_q = clip(rint(f32(x) * inv), -127, 127), inv = f32(1 / f32(s_x)),
//     because XLA rewrites x / s_x into that product (a true division
//     rounds differently at a few values in a million); rint rounds half to
//     even as jnp.round does.
//   * s32 sums over (ky, kx, c), the pad channels and the spatial pad zero.
//   * The epilogue (`store2`): s32 as it is (for the checks), or the
//     dequant with scale = dt(f32(s_x) * s_w) and bias = dt(bias) from the
//     wrapper, as f32 values.  bf16: each op rounded to bf16 in turn,
//     bf16(f32(acc)), * scale, + bias (s32 -> bf16 through f32, as XLA's
//     convert does: two roundings above 2^24).  f32: f32(acc), then one
//     fused multiply-add with a single rounding, fma(acc, scale, bias): the
//     HLO multiplies and adds, but XLA's CPU code generator contracts the
//     pair into an FMA.  The source builds with -fmad=false, so that no
//     other product and sum is contracted.
//
// What bounds it on the card: a conv does 2*K ops per output (K =
// kh*kw*C1) against 2 bytes an input element (bf16, read once) and 2-4
// bytes an output element; above ~600 ops per byte the int8 tensor cores
// (1979 TOPS dense), not the 3.35 TB/s, are the limit.  The 3x3 convs at
// C1 >= 128 are bound by operations; the 1x1 convs and the 64-channel 3x3
// ones by bytes.
//
// Four routes, chosen by the wrapper from the geometry alone
// (nn/conv_int8.py::plan_int8):
//   (a) 1x1 stride 1, pad 0: a plain GEMM, M = B*H*W pixels, N = C2, K = C1.
//   (b) 3x3 stride 1, pad 1: K1's haloed tile (csrc/conv3x3_s1.cu).
//   (c) 3x3 stride 2, pad 1: four strided loads a chunk, one an input phase.
//   (d) any other geometry (k 5, dilation, other strides or pads):
//       conv_int8_kernel below, mma.sync, on s8 input from quantize_s8.
//
// conv_int8_wgmma_kernel, routes (a)-(c): an implicit GEMM on the tensor
// cores, wgmma.mma_async m64nBNk32 .s32.s8.s8, both operands K-major in
// shared memory in the 128-byte swizzle (a 128-byte row is 128 channels,
// four k32 steps; C1 <= 64 takes one or two of them).
//   * Warp specialised, persistent, one block an SM walking the tiles with
//     N fastest (the C2 slices of one input tile run together and share
//     it in L2).  Warpgroup 0 gives its registers away (setmaxnreg 40):
//     one thread keeps TMA loads in flight on full/empty mbarriers,
//     running ahead across tiles, and its warps 1-3 are the converters
//     (below).  Warpgroups 1 and 2 (setmaxnreg 232) each own MW m64 blocks
//     of the tile's rows and issue wgmma, one K-step in flight (wait_group
//     1) before a lane of each warp frees what it read.  Tiles are 256 rows
//     by BN = 64 (C2 <= 64) or 128 (two m64 blocks a warpgroup), or 128
//     rows by 256 (route (a) at C2 > 128: its input is quantized once a BN
//     slice, the wider the fewer); the s32 sums are 128 registers a thread
//     at most.
//   * B, the weights (C2, kh*kw, C1p) s8, K-major: one TMA load a K-step,
//     box (128 channels, 1 tap, BN), 128-byte swizzle; C2's and C1p's
//     tails zero-filled by TMA.  Where one chunk and one N tile cover the
//     conv (C1 <= 128, C2 <= BN) and the taps' slices fit, they stay
//     resident, loaded once a block.
//   * A, the input, by TMA, in 128-channel chunks (K-steps: chunk, then
//     tap): route (a) a box of the tile's pixels in the (M, C) view; (b)
//     the (TH + 2) x (TW + 2) haloed patch from (h0 - 1, w0 - 1), the tile
//     computed as TH rows of TW + 2 pixels, so that tap (dy, dx) is the
//     same wgmma descriptor moved by dy*(TW + 2) + dx rows (the swizzle
//     follows the address bits, so a shifted view needs no base offset);
//     (c) the same trick on each input phase (dy % 2, dx % 2): a box with
//     element strides 2 along H and W, (TH + 1) x (TW + 1) pixels from
//     (2*h0 - 1 + dy % 2, 2*w0 - 1 + dx % 2), the tile computed as TH rows
//     of TW + 1, and the phase's taps ((0,0) (0,2) (2,0) (2,2), (0,1)
//     (2,1), (1,0) (1,2), (1,1)) its view moved by (dy / 2)*(TW + 1) +
//     dx / 2 rows.  Tiled TMA with element strides, not its im2col mode: it
//     is (b)'s tensor map kind, and four loads a chunk quantize each input
//     element about once, where one load a tap quantized it nine times
//     (and ran slower).  Coordinates past the edges (the conv's zero pad,
//     ragged tiles, channel tails) read as 0.
//   * The quantize folded into the loads (bf16 input): TMA brings the
//     bf16 tile unswizzled (rows of CB = 32, 64 or 128 channels) into a
//     raw ring; the 96 converter threads quantize each load once, in
//     registers, 8 channels a thread and two pieces at a time, with
//     quantize_s8's product, clip and round-half-even (the round as an add
//     of 1.5 * 2^23, whose low byte is then the s8 value: no conversion
//     instruction), into one of two s8 tiles in the swizzle that the wgmma
//     descriptor reads, fence it for the async proxy and arrive on its
//     full barrier; the consumers multiply out of the other.  Route (b)
//     quantizes once a haloed tile, (c) once a phase's tile, (a) once a
//     load.  x_q never goes to global memory.  f32 input (the eval's f32
//     path) and a bf16 row stride that TMA cannot take (C1 % 8) go through
//     quantize_s8 and the s8 form of the same route instead: an f32 tile
//     is twice a bf16 one, and the rings would not fit.
//   * s8 input (conv_int8's entry): TMA writes A straight into its s8 ring
//     in the swizzle; the converters idle.
//   * Epilogue from the registers, masked at the tile's valid rows and at
//     C2 (45 for the Detect convs), the arithmetic of store2.  bf16 with
//     C2 % 8 == 0: a quad's pairs transposed by shuffles so that each lane
//     stores 16 bytes (a warp writes 8 rows of 64 bytes, whole sectors;
//     pairs of 4 bytes write half sectors, which ran several times
//     slower), the bf16 roundings as packed conversions.
//   * Tried and dropped: two-block clusters sharing each weight slice by
//     TMA multicast, whose loads ran slower, not faster: the two blocks'
//     rings coupled through remote releases, four stages deep.
//
// conv_int8_kernel, route (d): an implicit GEMM, M = B*Ho*Wo output
// pixels, N = C2, K = kh*kw*C1p ordered (ky, kx, c), C1p = C1 padded to a
// multiple of 16 (the quantize kernel writes the pad channels as zeros,
// the wrapper pads the weights), so that every 16-byte piece of a K row
// lies in one tap.
//   * Block tile 128 x BN (BN 64 for C2 <= 64, else 128) x 64 bytes of K,
//     eight warps, each a 64 x 32 (BN 128) or 32 x 32 (BN 64) sub-tile of
//     m16n8k32 products (mma.sync s8 x s8 -> s32).
//   * A (the im2col rows) and B (the weights, (C2, K) row-major) are
//     gathered in 16-byte pieces by cp.async, four stages deep; a piece
//     outside the image (the conv's zero pad), past M, past C2 or past K is
//     zero-filled by the copy (src-size 0), as JAX pads x_q with 0.
//   * Shared memory rows of 64 bytes, their four 16-byte pieces XOR-swizzled
//     by (row >> 1) & 3, so that ldmatrix's eight row reads hit distinct
//     banks; ldmatrix.x4 gives the A and B fragments directly (an 8x8 b16
//     matrix is an 8x16 s8 one).
//
// quantize_s8_kernel: x (bf16 or f32, NHWC, C1 channels) -> s8 (C1p
// channels), the quantize above.  One thread writes 8 channels.
//
// The source builds into four libraries side by side, one nvcc each
// (utils/cuda_build.py): CI8_TC_BN = -1 keeps route (d) and the quantize,
// 64, 128 or 256 the wgmma kernel's two instances of that BN (a library
// of all six took twice as long as the slowest part).  Undefined, it keeps
// everything.
#ifndef CI8_TC_BN
#define CI8_TC_BN 0
#endif
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace ci8 {

constexpr int BM = 128;
constexpr int BK = 64;  // bytes (= s8 values) of K a stage
constexpr int STAGES = 4;
constexpr int THREADS = 256;

struct Geom {
  int B, H, W, C1p, Ho, Wo, C2;
  int kh, kw, sh, sw, ph, pw, dh, dw;
  int K;  // kh * kw * C1p
  int M;  // B * Ho * Wo
};

__device__ __forceinline__ int swz(int row, int piece) {
  return row * BK + ((piece ^ ((row >> 1) & 3)) << 4);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// OUT: 0 f32, 1 bf16, 2 s32 (the sums themselves)
template <int OUT>
__device__ __forceinline__ void store2(void* out, size_t idx, int c0, int c1, bool two, bool pair,
                                       const float* scale, const float* bias, int n) {
  if (OUT == 2) {
    int* o = static_cast<int*>(out) + idx;
    if (pair) {
      *reinterpret_cast<int2*>(o) = make_int2(c0, c1);
    } else {
      o[0] = c0;
      if (two) o[1] = c1;
    }
    return;
  }
  float v[2];
  const int acc[2] = {c0, c1};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float s = scale[n + (j && two ? 1 : 0)];
    const float b = bias ? bias[n + (j && two ? 1 : 0)] : 0.f;
    float y = __int2float_rn(acc[j]);
    if (OUT == 1) {
      y = __bfloat162float(__float2bfloat16_rn(y));
      y = __bfloat162float(__float2bfloat16_rn(__fmul_rn(y, s)));
      if (bias) y = __bfloat162float(__float2bfloat16_rn(__fadd_rn(y, b)));
    } else {
      y = bias ? __fmaf_rn(y, s, b) : __fmul_rn(y, s);
    }
    v[j] = y;
  }
  if (OUT == 1) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + idx;
    if (pair) {
      *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v[0], v[1]);
    } else {
      o[0] = __float2bfloat16_rn(v[0]);
      if (two) o[1] = __float2bfloat16_rn(v[1]);
    }
  } else {
    float* o = static_cast<float*>(out) + idx;
    if (pair) {
      *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
    } else {
      o[0] = v[0];
      if (two) o[1] = v[1];
    }
  }
}

template <int BN, int OUT>
__global__ void __launch_bounds__(THREADS)
    conv_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     void* __restrict__ out, const Geom g) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int WARPS_N = BN / 32;
  constexpr int WARPS_M = 8 / WARPS_N;
  constexpr int WM = BM / WARPS_M;  // rows of a warp's sub-tile
  constexpr int MT = WM / 16;
  constexpr int NT = 4;  // 32 columns of a warp's sub-tile, as n8 tiles
  constexpr int A_BYTES = BM * BK;
  constexpr int STAGE_BYTES = (BM + BN) * BK;
  constexpr int A_PIECES = BM * BK / 16 / THREADS;  // 2
  constexpr int B_PIECES = BN * BK / 16 / THREADS;  // 1 or 2

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int piece = tid & 3;  // the thread's 16-byte piece of a 64-byte K slice

  // the thread's A rows (output pixels) and B rows (output channels)
  const int8_t* a_img[A_PIECES];
  int a_iy[A_PIECES], a_ix[A_PIECES];
  bool a_ok[A_PIECES];
#pragma unroll
  for (int i = 0; i < A_PIECES; ++i) {
    const int m = m0 + (tid >> 2) + i * (THREADS / 4);
    a_ok[i] = m < g.M;
    const int mm = a_ok[i] ? m : 0;
    const int hw = g.Ho * g.Wo;
    const int b = mm / hw, r = mm - b * hw;
    const int oy = r / g.Wo, ox = r - oy * g.Wo;
    a_img[i] = x + static_cast<size_t>(b) * g.H * g.W * g.C1p;
    a_iy[i] = oy * g.sh - g.ph;
    a_ix[i] = ox * g.sw - g.pw;
  }
  const int8_t* b_src[B_PIECES];
  bool b_ok[B_PIECES];
#pragma unroll
  for (int i = 0; i < B_PIECES; ++i) {
    const int n = n0 + (tid >> 2) + i * (THREADS / 4);
    b_ok[i] = n < g.C2;
    b_src[i] = w + static_cast<size_t>(b_ok[i] ? n : 0) * g.K;
  }

  const int KT = (g.K + BK - 1) / BK;
  auto load_stage = [&](int stage, int kt) {
    uint8_t* sa = smem + stage * STAGE_BYTES;
    uint8_t* sb = sa + A_BYTES;
    const int k0 = kt * BK + piece * 16;
    const bool k_ok = k0 < g.K;
    const int tap = k0 / g.C1p;
    const int c = k0 - tap * g.C1p;
    const int ky = tap / g.kw, kx = tap - ky * g.kw;
#pragma unroll
    for (int i = 0; i < A_PIECES; ++i) {
      const int iy = a_iy[i] + ky * g.dh, ix = a_ix[i] + kx * g.dw;
      const bool v = a_ok[i] && k_ok && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
      const int8_t* src =
          v ? a_img[i] + (static_cast<size_t>(iy) * g.W + ix) * g.C1p + c : x;
      cp_async16(sa + swz((tid >> 2) + i * (THREADS / 4), piece), src, v);
    }
#pragma unroll
    for (int i = 0; i < B_PIECES; ++i) {
      const bool v = b_ok[i] && k_ok;
      cp_async16(sb + swz((tid >> 2) + i * (THREADS / 4), piece), v ? b_src[i] + k0 : w, v);
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed for every thread; stage kt - 1 is free
    const int nk = kt + STAGES - 1;
    if (nk < KT) load_stage(nk % STAGES, nk);
    cp_async_commit();

    const uint8_t* sa = smem + (kt % STAGES) * STAGE_BYTES;
    const uint8_t* sb = sa + A_BYTES;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int row = wm * WM + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(a[i], sa + swz(row, ks * 2 + (lane >> 4)));
      }
      uint32_t b[NT][2];
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        const int row = wn * 32 + j * 8 + (lane & 7) + (lane >> 4) * 8;
        uint32_t r[4];
        ldmatrix_x4(r, sb + swz(row, ks * 2 + ((lane >> 3) & 1)));
        b[j][0] = r[0], b[j][1] = r[1], b[j + 1][0] = r[2], b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  const int grp = lane >> 2, tig = lane & 3;
  const bool even = (g.C2 & 1) == 0;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * WM + i * 16 + grp + h * 8;
      if (m >= g.M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + wn * 32 + j * 8 + tig * 2;
        if (n >= g.C2) continue;
        const bool two = n + 1 < g.C2;
        store2<OUT>(out, static_cast<size_t>(m) * g.C2 + n, acc[i][j][2 * h],
                    acc[i][j][2 * h + 1], two, two && even, scale, bias, n);
      }
    }
}

template <typename T>
__global__ void quantize_s8_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                                   long long pixels, int C1, int C1p, float inv) {
  const int groups = C1p / 8;
  const long long total = pixels * groups;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; t < total;
       t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long p = t / groups;
    const int c0 = static_cast<int>(t - p * groups) * 8;
    const T* src = x + p * C1;
    uint32_t word[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + j;
      int q = 0;
      if (c < C1) {
        float v;
        if constexpr (sizeof(T) == 2)
          v = __bfloat162float(src[c]);
        else
          v = src[c];
        v = fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f);
        q = static_cast<int>(v);
      }
      word[j >> 2] |= (static_cast<uint32_t>(q) & 0xffu) << ((j & 3) * 8);
    }
    *reinterpret_cast<uint2*>(xq + p * C1p + c0) = make_uint2(word[0], word[1]);
  }
}

template <int BN, int OUT>
int launch(const void* x, const void* w, const void* scale, const void* bias, void* out,
           const Geom& g, cudaStream_t s) {
  constexpr int smem = STAGES * (BM + BN) * BK;
  static bool attr = false;  // the opt-in above 48 KB, once an instance
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_int8_kernel<BN, OUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const dim3 grid((g.M + BM - 1) / BM, (g.C2 + BN - 1) / BN);
  conv_int8_kernel<BN, OUT><<<grid, THREADS, smem, s>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias), out, g);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_out(const void* x, const void* w, const void* scale, const void* bias, void* out,
               const Geom& g, int out_kind, cudaStream_t s) {
  switch (out_kind) {
    case 0: return launch<BN, 0>(x, w, scale, bias, out, g, s);
    case 1: return launch<BN, 1>(x, w, scale, bias, out, g, s);
    case 2: return launch<BN, 2>(x, w, scale, bias, out, g, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace ci8

#if CI8_TC_BN <= 0
// x: s8 (B, H, W, C1p); w: s8 (C2, kh, kw, C1p); scale, bias: f32 (C2,)
// (bias may be null; neither is read for out_kind 2); out: (B, Ho, Wo, C2)
// f32 (out_kind 0), bf16 (1) or s32 (2).  C1p % 16 == 0; pointers 16-byte
// aligned.  Returns the CUDA error of the launch (0: launched).
extern "C" int conv_int8_launch(const void* x, const void* w, const void* scale,
                                const void* bias, void* out, int B, int H, int W, int C1p,
                                int Ho, int Wo, int C2, int kh, int kw, int sh, int sw, int ph,
                                int pw, int dh, int dw, int out_kind, void* stream) {
  const long long M = static_cast<long long>(B) * Ho * Wo;
  const long long K = static_cast<long long>(kh) * kw * C1p;
  if (C1p % 16 || M <= 0 || M > 0x7fffffff || K > 0x7fffffff || C2 <= 0 ||
      (C2 + 63) / 64 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  ci8::Geom g{B, H, W, C1p, Ho, Wo, C2, kh, kw, sh, sw, ph, pw, dh, dw,
              static_cast<int>(K), static_cast<int>(M)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return C2 <= 64 ? ci8::launch_out<64>(x, w, scale, bias, out, g, out_kind, s)
                  : ci8::launch_out<128>(x, w, scale, bias, out, g, out_kind, s);
}

// x: bf16 (in_bf16 = 1) or f32, (pixels, C1) contiguous; xq: s8 (pixels,
// C1p), 8-byte aligned, C1p % 8 == 0; inv = f32(1 / f32(s_x)).
extern "C" int quantize_s8_launch(const void* x, void* xq, long long pixels, int C1, int C1p,
                                  float inv, int in_bf16, void* stream) {
  if (C1p % 8 || C1p < C1 || pixels <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = pixels * (C1p / 8);
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132LL * 32 ? want : 132LL * 32);
  if (in_bf16)
    ci8::quantize_s8_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq), pixels, C1, C1p, inv);
  else
    ci8::quantize_s8_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(xq), pixels, C1, C1p, inv);
  return static_cast<int>(cudaGetLastError());
}
#endif  // CI8_TC_BN <= 0

// ---------------------------------------------------------------------------
// routes (a)-(c): wgmma s8, TMA loads, the quantize folded in
// ---------------------------------------------------------------------------

namespace tc8 {

constexpr int ROW = 128;                  // bytes of an s8 row: 128 channels, four k32 steps
constexpr int CONSUMERS = 256;            // warpgroups 1 and 2 multiply
constexpr int THREADS = CONSUMERS + 128;  // warpgroup 0 loads and quantizes
constexpr int CONVERTERS = 96;            // warps 1-3 of warpgroup 0
constexpr int CONSUMER_WARPS = CONSUMERS / 32;
constexpr int MAX_STAGES = 9;  // nine: a 3x3 conv's resident weight slices
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // setmaxnreg: 40*128 + 232*256 <= 168*384

enum Route { GEMM = 0, HALO = 1, STRIDED = 2 };

// The plan as the wrapper sends it (nn/conv_int8.py::Int8Plan.args), in
// this order, all ints.
struct Plan {
  int route;
  int B, H, W, Cx, C1p;  // the input (Cx: its channels, C1 for bf16, C1p for s8)
  int Ho, Wo, C2;
  int TH, TW, tiles_h, tiles_w;  // (b), (c): the patch a tile computes
  int BN, n_tiles, tiles;        // C2 slices; all tiles
  int chunks, kk, taps, cb;      // 128-channel chunks a tap; k32 steps a chunk; 1 or 9; raw row
  int a_rows;                    // rows one A load brings
  int a_stages, b_stages;
  int a_bytes, raw_bytes;        // one s8 A tile / one raw bf16 tile, multiples of 1024
  int smem;                      // dynamic shared memory, alignment slack included
  int convert;                   // 1: bf16 input quantized in the kernel
  int res;                       // 1: the weights stay resident, loaded once a block
  int s8_tiles;                  // convert: the converters' s8 tiles, 2
  int out_kind;                  // 0 f32, 1 bf16, 2 s32
};
constexpr int PLAN_INTS = sizeof(Plan) / sizeof(int);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// spin until the phase of `bar` with this parity has completed; a load
// that never lands traps after ~10 s instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) break;
    if (clock64() - start > 20000000000ll) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void fence_async_smem() {  // generic-proxy writes -> wgmma
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); LBO is
// unused by this layout, the base offset stays 0.  A k32 slice starts 32
// bytes (2 units) further.
__device__ __forceinline__ uint64_t smem_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define ACC8(i)                                                                         \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),           \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define ACC32(i) ACC8(i), ACC8(i + 8), ACC8(i + 16), ACC8(i + 24)

// D (64 x BN, s32, in registers) += A (64 x 32, s8) * B (32 x BN, s8),
// both K-major in shared memory (the only layout wgmma takes for 8-bit
// operands); integer wgmma has no scale or transpose immediates, and its
// scale-d predicate is always set (the sums start from registers at 0)
template <int BN>
struct Mma;

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(int (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        : ACC32(0)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(int (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
        "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
        "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : ACC32(0), ACC32(32)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<256> {
  static __device__ __forceinline__ void run(int (&d)[128], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
        "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
        "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, "
        "%69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
        "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, "
        "%102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
        "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p;\n}\n"
        : ACC32(0), ACC32(32), ACC32(64), ACC32(96)
        : "l"(a), "l"(b), "r"(1));
  }
};

#undef ACC8
#undef ACC32

// BN output channels of MW m64 blocks a consumer warpgroup: tiles of
// 128 * MW rows; the s32 sums, MW * BN / 2 registers a thread
template <int BN>
struct Shape {
  static constexpr int MW = BN == 256 ? 1 : 2;
  static constexpr int ROWS = 128 * MW;
};

// one K-step: KK k32 products for each of the warpgroup's MW m64 blocks,
// unrolled, so that nothing touches the sums between them (a runtime loop
// makes ptxas fence each one)
template <int BN, int MW, int KK>
__device__ __forceinline__ void mma_step(int (&acc)[MW][BN / 2], uint64_t da, uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int m = 0; m < MW; ++m)  // the next m64 block: +64 rows, +512 in 16-byte units
      Mma<BN>::run(acc[m], da + m * 512 + 2 * kk, db + 2 * kk);
}

// One value's quantize: clip(rint(v * inv), -127, 127) (the clip first:
// the same integer, since the bounds are integers), rounded half to even
// by adding 1.5 * 2^23, where the f32 spacing is 1: the sum's low byte is
// the s8 value in two's complement (NaN clips to -127, as quantize_s8's
// fmaxf does).  No conversion instruction: those run at an eighth of the
// f32 rate.
__device__ __forceinline__ uint32_t q8(float v, float inv) {
  const float y = fminf(fmaxf(__fmul_rn(v, inv), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(y, 12582912.f));
}

// four bf16 (two words) -> four s8 in one word, channel order kept
__device__ __forceinline__ uint32_t quant4(uint32_t w0, uint32_t w1, float inv) {
  const uint32_t a = q8(__uint_as_float(w0 << 16), inv);
  const uint32_t b = q8(__uint_as_float(w0 & 0xffff0000u), inv);
  const uint32_t c = q8(__uint_as_float(w1 << 16), inv);
  const uint32_t d = q8(__uint_as_float(w1 & 0xffff0000u), inv);
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// Rows [r0, r1) of a raw bf16 tile (rows of 2^lg8 pieces of 8 channels,
// dense) quantized into the s8 tile `dst` (rows of 128 bytes in the
// 128-byte swizzle: 16-byte chunk k of row r at chunk k ^ (r % 8)), by
// `n` threads, this one `i`.  A half-warp writes one 128-byte row.  Two
// pieces a thread at a time, loaded before either is converted, so that a
// warp alone on its scheduler has independent work to issue.
__device__ __forceinline__ void quantize_piece(uint8_t* dst, int r, int piece, uint4 v,
                                               float inv) {
  const uint2 q = make_uint2(quant4(v.x, v.y, inv), quant4(v.z, v.w, inv));
  *reinterpret_cast<uint2*>(dst + r * ROW + (((piece >> 1) ^ (r & 7)) << 4) +
                            ((piece & 1) << 3)) = q;
}

__device__ __forceinline__ void quantize_rows(const uint8_t* raw, uint8_t* dst, int r0, int r1,
                                              int lg8, int i, int n, float inv) {
  const int total = (r1 - r0) << lg8, mask = (1 << lg8) - 1;
  const uint8_t* base = raw + (static_cast<size_t>(r0) << (lg8 + 4));
  int e = i;
  for (; e + n < total; e += 2 * n) {
    const uint4 v0 = *reinterpret_cast<const uint4*>(base + (static_cast<size_t>(e) << 4));
    const uint4 v1 = *reinterpret_cast<const uint4*>(base + (static_cast<size_t>(e + n) << 4));
    quantize_piece(dst, r0 + (e >> lg8), e & mask, v0, inv);
    quantize_piece(dst, r0 + ((e + n) >> lg8), (e + n) & mask, v1, inv);
  }
  if (e < total)
    quantize_piece(dst, r0 + (e >> lg8), e & mask,
                   *reinterpret_cast<const uint4*>(base + (static_cast<size_t>(e) << 4)), inv);
}

// one tile's place, N fastest (so that the C2 slices of one input tile
// run together and share it in L2): (a) from m0, (b), (c) the patch (b,
// h0, w0)
struct Tile {
  int n0, m0, b, h0, w0;
  __device__ Tile(const Plan& p, int t, int rows) {
    n0 = (t % p.n_tiles) * p.BN;
    int mt = t / p.n_tiles;
    m0 = mt * rows;
    w0 = (mt % p.tiles_w) * p.TW;
    mt /= p.tiles_w;
    h0 = (mt % p.tiles_h) * p.TH;
    b = mt / p.tiles_h;
  }
};

// The K-steps of a chunk, i = 0 ... taps - 1, and what each reads.
// (a): one, its own A load.  (b): tap i of the haloed tile, the view
// shifted by (i / 3) rows of TW + 2 and i % 3.  (c): the taps in the
// order of their input phase (dy % 2, dx % 2): (0,0) (0,2) (2,0) (2,2) on
// the even rows and columns, (0,1) (2,1), (1,0) (1,2), (1,1); each phase
// one strided load, (TH + 1) x (TW + 1) pixels computed as TH rows of
// TW + 1, so that its taps are the view shifted by (dy / 2) rows and
// dx / 2.
constexpr unsigned long long S2_TAPS = 0x453718620ull;  // 4 bits a step: dy * 3 + dx
constexpr int S2_FIRST = 0x151, S2_LAST = 0x1A8;        // the steps that start / end a phase

__device__ __forceinline__ int step_tap(const Plan& p, int i) {  // the weight slice
  return p.route == STRIDED ? static_cast<int>((S2_TAPS >> (4 * i)) & 15) : i;
}
__device__ __forceinline__ bool step_loads(const Plan& p, int i) {  // a new A tile
  return p.route == GEMM || (p.route == HALO ? i == 0 : (S2_FIRST >> i) & 1);
}
__device__ __forceinline__ bool step_frees(const Plan& p, int i) {  // its A tile's last
  return p.route == GEMM || (p.route == HALO ? i == 8 : (S2_LAST >> i) & 1);
}
__device__ __forceinline__ int step_shift(const Plan& p, int i) {  // rows the view moves
  const int tap = step_tap(p, i);
  if (p.route == HALO) return (tap / 3) * (p.TW + 2) + tap % 3;
  if (p.route == STRIDED) return (tap / 6) * (p.TW + 1) + (tap % 3) / 2;
  return 0;
}

// The output offset (in elements, channel 0) of tile row r, or -1 where r
// is no output: past M, a junk column of route (b), past the patch or the
// image.
__device__ __forceinline__ long long out_row(const Plan& p, const Tile& t, int r) {
  if (p.route == GEMM) {
    const long long m = static_cast<long long>(t.m0) + r;
    return m < static_cast<long long>(p.B) * p.Ho * p.Wo ? m * p.C2 : -1;
  }
  const int tw_full = p.TW + (p.route == HALO ? 2 : 1);  // rows a patch row takes
  const int th = r / tw_full, tw = r - th * tw_full;
  const int h = t.h0 + th, w = t.w0 + tw;
  if (th >= p.TH || tw >= p.TW || h >= p.Ho || w >= p.Wo) return -1;
  return ((static_cast<long long>(t.b) * p.Ho + h) * p.Wo + w) * p.C2;
}

// bf16 of the dequant of two sums, as `store2` rounds it: bf16(f32(acc)),
// * scale -> bf16, + bias -> bf16.  The product of two bf16 values is
// exact in f32, so one bf16x2 multiply rounds it as the f32 product then
// the conversion do; the sum is taken in f32, then rounded (a bf16x2 add
// would round once where f32-then-bf16 may round twice).  Packed
// conversions: one for two values (a conversion runs at an eighth of the
// f32 rate).
__device__ __forceinline__ uint32_t dequant_bf16x2(int a0, int a1, __nv_bfloat162 s, float b0,
                                                   float b1, bool has_bias) {
  __nv_bfloat162 r = __floats2bfloat162_rn(__int2float_rn(a0), __int2float_rn(a1));
  r = __hmul2(r, s);
  if (has_bias) {
    const float2 f = __bfloat1622float2(r);
    r = __floats2bfloat162_rn(__fadd_rn(f.x, b0), __fadd_rn(f.y, b1));
  }
  return *reinterpret_cast<uint32_t*>(&r);
}

// v[k] of lane q of a quad (the four lanes that hold one sum row) is its
// channel pair q of block k; afterwards lane q holds block q's four
// channel pairs in order (a 4x4 transpose across the quad: in round r,
// lane q trades with lane q ^ r)
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&v)[4], int q) {
  uint32_t t[4] = {v[0], v[1], v[2], v[3]};
#pragma unroll
  for (int r = 1; r < 4; ++r) {
    const int k = q ^ r;  // the partner lane, and the block it wants from this one
    const uint32_t send = k & 2 ? (k & 1 ? v[3] : v[2]) : (k & 1 ? v[1] : v[0]);
    const uint32_t got = __shfl_xor_sync(0xffffffffu, send, r);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i == k) t[i] = got;
  }
  // t[i]: lane i's pair of block q; round 0 kept this lane's own
  return make_uint4(t[0], t[1], t[2], t[3]);
}

// The epilogue, as `store2` computes it, of the thread's rows: row half h
// of m64 block m is tile row row0 + 64 m + 8 h; a quad's four lanes hold
// the row's channels 8j + 2q, 8j + 2q + 1.  bf16 with C2 % 8 == 0: the
// quad's pairs transposed so that each lane stores 16 bytes (a warp, 8
// rows x 64 bytes: whole sectors; pairs of 4 bytes leave half sectors);
// the rest two channels at a time.
template <int BN, int MW, int OUT>
__device__ __forceinline__ void epilogue(const Plan& p, const Tile& t,
                                         const int (&acc)[MW][BN / 2], int row0,
                                         const float* __restrict__ scale,
                                         const float* __restrict__ bias, void* __restrict__ out) {
  const int q = threadIdx.x % 4;
  const int cols = p.C2 - t.n0;  // channels of this tile in C2
  long long o[MW][2];
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) o[m][h] = out_row(p, t, row0 + 64 * m + 8 * h);
  if (OUT == 1 && p.C2 % 8 == 0) {
#pragma unroll
    for (int g = 0; g < BN / 32; ++g) {
      if (32 * g >= cols) break;  // uniform across the warp
      __nv_bfloat162 s[4];
      float2 bb[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = t.n0 + 8 * (4 * g + k) + 2 * q;
        const bool in = 8 * (4 * g + k) < cols;
        const float2 sf = in ? *reinterpret_cast<const float2*>(scale + n) : make_float2(0.f, 0.f);
        s[k] = __floats2bfloat162_rn(sf.x, sf.y);  // bf16 values: exact
        bb[k] = in && bias ? *reinterpret_cast<const float2*>(bias + n) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int m = 0; m < MW; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = 4 * g + k;
            v[k] = dequant_bf16x2(acc[m][4 * j + 2 * h], acc[m][4 * j + 2 * h + 1], s[k],
                                  bb[k].x, bb[k].y, bias != nullptr);
          }
          const uint4 w = quad_transpose(v, q);  // every lane, stored or not
          const int c = 8 * (4 * g + q);
          if (o[m][h] >= 0 && c < cols)
            *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + o[m][h] + t.n0 + c) = w;
        }
    }
    return;
  }
  const bool even = (p.C2 & 1) == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = t.n0 + 8 * j + 2 * q;
    if (n >= p.C2) continue;
    const bool two = n + 1 < p.C2, pair = two && even;
    float s0 = 0.f, s1 = 0.f, b0 = 0.f, b1 = 0.f;
    if (OUT != 2) {
      s0 = scale[n], s1 = two ? scale[n + 1] : s0;
      if (bias) b0 = bias[n], b1 = two ? bias[n + 1] : b0;
    }
#pragma unroll
    for (int m = 0; m < MW; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (o[m][h] < 0) continue;
        const size_t idx = static_cast<size_t>(o[m][h]) + n;
        const int a0 = acc[m][4 * j + 2 * h], a1 = acc[m][4 * j + 2 * h + 1];
        if (OUT == 2) {
          int* d = static_cast<int*>(out) + idx;
          if (pair) {
            *reinterpret_cast<int2*>(d) = make_int2(a0, a1);
          } else {
            d[0] = a0;
            if (two) d[1] = a1;
          }
        } else if (OUT == 1) {
          const uint32_t r = dequant_bf16x2(a0, a1, __floats2bfloat162_rn(s0, s1), b0, b1,
                                            bias != nullptr);
          __nv_bfloat16* d = static_cast<__nv_bfloat16*>(out) + idx;
          if (pair) {
            *reinterpret_cast<uint32_t*>(d) = r;
          } else {
            const __nv_bfloat162 rb = *reinterpret_cast<const __nv_bfloat162*>(&r);
            d[0] = rb.x;
            if (two) d[1] = rb.y;
          }
        } else {
          // fma(f32(acc), scale, bias), one rounding
          const float f0 = __int2float_rn(a0), f1 = __int2float_rn(a1);
          const float y0 = bias ? __fmaf_rn(f0, s0, b0) : __fmul_rn(f0, s0);
          const float y1 = bias ? __fmaf_rn(f1, s1, b1) : __fmul_rn(f1, s1);
          float* d = static_cast<float*>(out) + idx;
          if (pair) {
            *reinterpret_cast<float2*>(d) = make_float2(y0, y1);
          } else {
            d[0] = y0;
            if (two) d[1] = y1;
          }
        }
      }
  }
}

template <int BN, bool CONVERT>
__global__ void __launch_bounds__(THREADS, 1)
    conv_int8_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap wmap,
                           const float* __restrict__ scale, const float* __restrict__ bias,
                           void* __restrict__ out, const Plan p, const float inv) {
  constexpr int MW = Shape<BN>::MW;
  constexpr int ROWS = Shape<BN>::ROWS;  // a tile's rows, 64 * MW a warpgroup
  constexpr int B_BYTES = BN * ROW;      // one K-step's weight slice
  extern __shared__ uint8_t smem_raw[];
  // a: the TMA ring of A (s8 tiles, or raw bf16 ones for the converters);
  // q: the converters' s8 tiles; b: the weights
  __shared__ __align__(8) uint64_t a_full[MAX_STAGES], a_empty[MAX_STAGES], q_full[2],
      q_empty[2], b_full[MAX_STAGES], b_empty[MAX_STAGES];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align everything to it
  uint8_t* ring_b = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring_a = ring_b + p.b_stages * B_BYTES;
  uint8_t* ring_q = ring_a + p.a_stages * (CONVERT ? p.raw_bytes : p.a_bytes);
  const int a_tx = p.a_rows * (CONVERT ? 2 * p.cb : ROW);  // the bytes an A load brings

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.a_stages; ++s) {
      mbar_init(&a_full[s], 1);
      // freed by every converter thread (bf16), or by each consumer warp
      mbar_init(&a_empty[s], CONVERT ? CONVERTERS : CONSUMER_WARPS);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&q_full[s], CONVERTERS);
      mbar_init(&q_empty[s], CONSUMER_WARPS);
    }
    for (int s = 0; s < p.b_stages; ++s) {
      mbar_init(&b_full[s], 1);
      mbar_init(&b_empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- warpgroup 0: warp 0's first thread issues every load, running
    // ahead across tiles; warps 1-3 quantize the bf16 input (CONVERT)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int ca = 0, cb = 0;  // A loads and weight slices issued so far
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        const Tile tile(p, t, ROWS);
        for (int chunk = 0; chunk < p.chunks; ++chunk)
          for (int tap = 0; tap < p.taps; ++tap) {
            if (step_loads(p, tap)) {
              const int sa = ca % p.a_stages;
              mbar_wait(&a_empty[sa], ((ca / p.a_stages) & 1) ^ 1);
              mbar_expect_tx(&a_full[sa], a_tx);
              uint8_t* dst = ring_a + sa * (CONVERT ? p.raw_bytes : p.a_bytes);
              const int c = chunk * ROW;
              if (p.route == GEMM)
                tma_load_4d(dst, &xmap, &a_full[sa], c, tile.m0, 0, 0);
              else if (p.route == HALO)
                tma_load_4d(dst, &xmap, &a_full[sa], c, tile.w0 - 1, tile.h0 - 1, tile.b);
              else  // the phase of the step's tap: every second pixel from there
                tma_load_4d(dst, &xmap, &a_full[sa], c, 2 * tile.w0 - 1 + step_tap(p, tap) % 3 % 2,
                            2 * tile.h0 - 1 + step_tap(p, tap) / 3 % 2, tile.b);
              ++ca;
            }
            if (p.res && cb >= p.taps) continue;  // the taps' slices are already there
            const int sb = cb % p.b_stages;
            mbar_wait(&b_empty[sb], ((cb / p.b_stages) & 1) ^ 1);
            mbar_expect_tx(&b_full[sb], B_BYTES);
            tma_load_4d(ring_b + sb * B_BYTES, &wmap, &b_full[sb], chunk * ROW, step_tap(p, tap),
                        tile.n0, 0);
            ++cb;
          }
      }
    } else if (CONVERT && threadIdx.x >= 32) {
      // the converters: each A load, once, into the next of two s8 tiles,
      // while the consumers multiply out of the other (route (a): the
      // tile's rows, loaded or not; (b) the haloed tile, (c) the phase's)
      const int ci = threadIdx.x - 32;
      const int lg8 = 31 - __clz(p.cb / 8);
      const int rows = p.route == GEMM ? ROWS : p.a_rows;
      const int loads = p.chunks * (p.route == GEMM ? 1 : p.route == HALO ? 1 : 4);  // a tile
      int ca = 0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x)
        for (int l = 0; l < loads; ++l, ++ca) {
          const int sa = ca % p.a_stages, sq = ca & 1;
          mbar_wait(&a_full[sa], (ca / p.a_stages) & 1);
          mbar_wait(&q_empty[sq], ((ca >> 1) & 1) ^ 1);
          quantize_rows(ring_a + sa * p.raw_bytes, ring_q + sq * p.a_bytes, 0, rows, lg8, ci,
                        CONVERTERS, inv);
          mbar_arrive(&a_empty[sa]);  // the raw tile is read
          fence_async_smem();         // the s8 tile, for wgmma's async proxy
          mbar_arrive(&q_full[sq]);
        }
    }
  } else {
    // ---- consumers: warpgroup wg owns tile rows 64*MW*wg ... 64*MW*(wg + 1) - 1
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int ct = threadIdx.x - 128;
    const int wg = ct / 128, t128 = ct % 128;
    const bool lead = ct % 32 == 0;                              // frees stages for its warp
    const int wrow = wg * 64 * MW;                               // the warpgroup's first row
    const int row0 = wrow + (t128 / 32) * 16 + (t128 % 32) / 4;  // the thread's first sum row
    // the s8 A tiles the consumers read: the TMA ring, or the converters' pair
    uint64_t* c_full = CONVERT ? q_full : a_full;
    uint64_t* c_empty = CONVERT ? q_empty : a_empty;
    const uint8_t* c_ring = CONVERT ? ring_q : ring_a;
    const int c_stages = CONVERT ? 2 : p.a_stages;
    int ca = 0, cb = 0;
    int free_a = -1, free_b = -1;  // stages read by the wgmma group still in flight
    int sa = 0;
    auto release = [&]() {  // the stages the finished group read
      if (lead && free_b >= 0) mbar_arrive(&b_empty[free_b]);
      if (lead && free_a >= 0) mbar_arrive(&c_empty[free_a]);
    };
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const Tile tile(p, t, ROWS);
      int acc[MW][BN / 2];
#pragma unroll
      for (int m = 0; m < MW; ++m)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[m][i] = 0;
      for (int chunk = 0; chunk < p.chunks; ++chunk)
        for (int tap = 0; tap < p.taps; ++tap) {
          if (step_loads(p, tap)) {
            sa = ca % c_stages;
            mbar_wait(&c_full[sa], (ca / c_stages) & 1);
            ++ca;
          }
          // res: slice s holds tap s for good, and is never freed
          const int sb = p.res ? tap : cb % p.b_stages;
          mbar_wait(&b_full[sb], p.res ? 0 : (cb / p.b_stages) & 1);
          const uint64_t da =
              smem_desc(c_ring + sa * p.a_bytes + (wrow + step_shift(p, tap)) * ROW);
          const uint64_t db = smem_desc(ring_b + sb * B_BYTES);
          wgmma_fence();
          if (p.kk == 4) {
            mma_step<BN, MW, 4>(acc, da, db);
          } else if (p.kk == 2) {
            mma_step<BN, MW, 2>(acc, da, db);
          } else {
            mma_step<BN, MW, 1>(acc, da, db);
          }
          wgmma_commit();
          wgmma_wait<1>();  // the previous group is done: free what it read
          release();
          free_b = p.res ? -1 : sb;
          // the A tile is free once its last K-step's group is done
          free_a = step_frees(p, tap) ? sa : -1;
          ++cb;
        }
      wgmma_wait<0>();
      release();
      free_a = free_b = -1;

      // ---- epilogue from the registers; the producer meanwhile loads the
      // next tile, the converters quantize it
      switch (p.out_kind) {
        case 0: epilogue<BN, MW, 0>(p, tile, acc, row0, scale, bias, out); break;
        case 1: epilogue<BN, MW, 1>(p, tile, acc, row0, scale, bias, out); break;
        default: epilogue<BN, MW, 2>(p, tile, acc, row0, scale, bias, out); break;
      }
    }
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// error codes beyond cudaError_t's range, so the wrapper can tell them apart
constexpr int ERR_NO_ENCODER = 10001;
constexpr int ERR_ENCODE_X = 10002;
constexpr int ERR_ENCODE_W = 10003;
constexpr int ERR_PLAN = 10005;
constexpr int ERR_REGS = 10006;

// a rank-4 tensor map over a dense array: dims, box and element strides
// innermost first
bool encode(CUtensorMap* map, CUtensorMapDataType type, int esize, const void* base,
            const cuuint64_t (&dims)[4], const cuuint32_t (&box)[4],
            const cuuint32_t (&estride)[4], CUtensorMapSwizzle swizzle) {
  cuuint64_t strides[3];  // in bytes, of dims 1 ... 3
  cuuint64_t stride = dims[0] * esize;
  for (int i = 0; i < 3; ++i) strides[i] = stride, stride *= dims[i + 1];
  return encode_tiled()(map, type, 4, const_cast<void*>(base), dims, strides, box, estride,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, bool CONVERT>
int launch(const void* x, const void* w, const void* scale, const void* bias, void* out,
           const Plan& p, float inv, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return ERR_NO_ENCODER;
  auto kernel = conv_int8_wgmma_kernel<BN, CONVERT>;
  // setmaxnreg moves registers between the warpgroups of the block: the
  // kernel must start with the 168 a thread that __launch_bounds__ gives
  // it, or the consumers' increase would wait for registers forever
  static int regs = -1;
  cudaError_t e;
  if (regs < 0) {
    cudaFuncAttributes attr;
    if ((e = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return static_cast<int>(e);
    regs = attr.numRegs;
  }
  if (regs * THREADS < PRODUCER_REGS * 128 + CONSUMER_REGS * CONSUMERS) return ERR_REGS;
  const CUtensorMapDataType in_type =
      CONVERT ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const int esize = CONVERT ? 2 : 1;
  const cuuint32_t cbox = CONVERT ? p.cb : ROW;  // raw rows unswizzled; s8 rows in the swizzle
  const CUtensorMapSwizzle a_swz = CONVERT ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap xmap, wmap;
  const cuuint64_t cx = p.Cx;
  bool ok;
  if (p.route == GEMM) {  // (M, C): a box of the tile's pixels
    const cuuint64_t m = static_cast<cuuint64_t>(p.B) * p.H * p.W;
    ok = encode(&xmap, in_type, esize, x, {cx, m, 1, 1},
                {cbox, static_cast<cuuint32_t>(Shape<BN>::ROWS), 1, 1}, {1, 1, 1, 1}, a_swz);
  } else if (p.route == HALO) {  // (B, H, W, C): the haloed patch
    ok = encode(&xmap, in_type, esize, x,
                {cx, static_cast<cuuint64_t>(p.W), static_cast<cuuint64_t>(p.H),
                 static_cast<cuuint64_t>(p.B)},
                {cbox, static_cast<cuuint32_t>(p.TW + 2), static_cast<cuuint32_t>(p.TH + 2), 1},
                {1, 1, 1, 1}, a_swz);
  } else {  // a phase: every second pixel along W and H, (TW + 1) x (TH + 1) of them
    ok = encode(&xmap, in_type, esize, x,
                {cx, static_cast<cuuint64_t>(p.W), static_cast<cuuint64_t>(p.H),
                 static_cast<cuuint64_t>(p.B)},
                {cbox, static_cast<cuuint32_t>(2 * p.TW + 2), static_cast<cuuint32_t>(2 * p.TH + 2),
                 1},
                {1, 2, 2, 1}, a_swz);
  }
  if (!ok) return ERR_ENCODE_X;
  // w (C2, taps, C1p): one tap's 128-channel chunk of BN output channels
  if (!encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w,
              {static_cast<cuuint64_t>(p.C1p), static_cast<cuuint64_t>(p.taps),
               static_cast<cuuint64_t>(p.C2), 1},
              {ROW, 1, BN, 1}, {1, 1, 1, 1}, CU_TENSOR_MAP_SWIZZLE_128B))
    return ERR_ENCODE_W;
  static int allowed = 0;  // one per template instance: raise its limit as needed
  if (p.smem > allowed) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = p.smem;
  }
  // persistent: one block an SM (the registers allow no second)
  static int seen_dev = -1, sms = 0;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if (dev != seen_dev) {
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return static_cast<int>(e);
    seen_dev = dev;
  }
  const int blocks = p.tiles < sms ? p.tiles : sms;
  kernel<<<blocks, THREADS, p.smem, stream>>>(xmap, wmap, static_cast<const float*>(scale),
                                              static_cast<const float*>(bias), out, p, inv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc8

// Routes (a)-(c).  x: s8 (B, H, W, C1p) (plan convert 0) or bf16 (B, H, W,
// C1) (convert 1; C1 % 8 == 0); w: s8 (C2, kh, kw, C1p); scale, bias: f32
// (C2,) (bias may be null; neither is read for out_kind 2); out: (B, Ho,
// Wo, C2) f32, bf16 or s32; every pointer 16-byte aligned.  `plan`: the
// tc8::Plan's ints, in its order (nn/conv_int8.py::Int8Plan.args); `n`
// their count.  Returns 0, a cudaError_t, or one of tc8::ERR_*.  A library
// built with CI8_TC_BN = 64, 128 or 256 launches that BN only.
#if CI8_TC_BN >= 0
extern "C" int conv_int8_wgmma_launch(const void* x, const void* w, const void* scale,
                                      const void* bias, void* out, const int* plan, int n,
                                      float inv, void* stream) {
  if (n != tc8::PLAN_INTS) return tc8::ERR_PLAN;
  tc8::Plan p;
  memcpy(&p, plan, sizeof(p));
  if (p.route < 0 || p.route > 2 || p.a_stages < 1 || p.a_stages > tc8::MAX_STAGES ||
      p.b_stages < 1 || p.b_stages > tc8::MAX_STAGES || p.tiles <= 0 || p.chunks <= 0 ||
      p.kk < 1 || p.kk > 4 || (p.cb != 32 && p.cb != 64 && p.cb != 128) ||
      p.taps != (p.route == tc8::GEMM ? 1 : 9) || p.out_kind < 0 || p.out_kind > 2 ||
      p.a_bytes % 1024 || p.raw_bytes % 1024 ||
      (p.res && (p.b_stages != p.taps || p.chunks != 1 || p.n_tiles != 1)) ||
      (p.convert && p.s8_tiles != 2))
    return tc8::ERR_PLAN;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.BN) {
#if CI8_TC_BN == 0 || CI8_TC_BN == 64
    case 64:
      return p.convert ? tc8::launch<64, true>(x, w, scale, bias, out, p, inv, s)
                       : tc8::launch<64, false>(x, w, scale, bias, out, p, inv, s);
#endif
#if CI8_TC_BN == 0 || CI8_TC_BN == 128
    case 128:
      return p.convert ? tc8::launch<128, true>(x, w, scale, bias, out, p, inv, s)
                       : tc8::launch<128, false>(x, w, scale, bias, out, p, inv, s);
#endif
#if CI8_TC_BN == 0 || CI8_TC_BN == 256
    case 256:
      return p.convert ? tc8::launch<256, true>(x, w, scale, bias, out, p, inv, s)
                       : tc8::launch<256, false>(x, w, scale, bias, out, p, inv, s);
#endif
  }
  return tc8::ERR_PLAN;
}
#endif  // CI8_TC_BN >= 0
