// int8 post-training-quantized convolution: s8 NHWC input x s8 weights ->
// s32 sums -> dequantized bf16 or f32 NHWC output, and the input quantize.
//
// Replaces no TPU kernel: the JAX package runs its int8 conv as an XLA op
// (dmayolo_tpu/nn/primitives.py::Conv2d._int8_conv, :134-166), and stock
// PyTorch has no int8 convolution for CUDA tensors.  It serves every conv
// that `nn/quant.py` calibrates (g = 1, C1 >= 16, not DFL).
//
// What bounds it on the card: operations at nearly all of the models'
// shapes.  A conv does 2*K flops per output (K = kh*kw*C1), against 1 byte
// an input element and 2-4 bytes an output element; above ~600 ops per byte
// the int8 tensor cores (1979 TOPS dense), not the 3.35 TB/s, are the
// limit.  This first kernel is simple and right, not fast: mma.sync, not
// wgmma (ROADMAP Queue 2 names the levers).
//
// conv_int8_kernel: an implicit GEMM, M = B*Ho*Wo output pixels, N = C2,
// K = kh*kw*C1p ordered (ky, kx, c), C1p = C1 padded to a multiple of 16
// (the quantize kernel writes the pad channels as zeros, the wrapper pads
// the weights), so that every 16-byte piece of a K row lies in one tap.
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
//   * Epilogue from the registers, masked at M and C2: s32 as it is (for
//     the checks), or the dequant as the jitted JAX program rounds it
//     (scale = dt(f32(s_x) * s_w) and bias = dt(bias) come from the
//     wrapper, as f32 values).  bf16: each op rounded to bf16 in turn,
//     bf16(f32(acc)), * scale, + bias (s32 -> bf16 through f32, as XLA's
//     convert does: two roundings above 2^24).  f32: f32(acc), then one
//     fused multiply-add with a single rounding, fma(acc, scale, bias): the
//     HLO multiplies and adds, but XLA's CPU code generator contracts the
//     pair into an FMA.  The source builds with -fmad=false, so that no
//     other product and sum is contracted.
//
// quantize_s8_kernel: x (bf16 or f32, NHWC, C1 channels) -> s8 (C1p
// channels): clip(rint(f32(x) * inv), -127, 127), inv = f32(1 / f32(s_x)),
// because XLA rewrites x / s_x into that product (a true division rounds
// differently at a few values in a million); rint rounds half to even as
// jnp.round does.  One thread writes 8 channels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
