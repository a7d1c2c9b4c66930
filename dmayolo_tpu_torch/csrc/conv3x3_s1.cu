// 3x3, stride-1, pad-1 convolution, NHWC input x HWIO weights, f32 sums.
//
// Replaces the TPU kernel dmayolo_tpu/nn/pallas_conv.py::conv3x3_s1 (body
// _kernel), which DMA'd one haloed spatial tile into VMEM and fed the MXU
// one im2col product per row slab.
//
// What bounds it on the card: operations.  At the flagship's shapes a
// 3x3 conv does 18*C1 flops per output value against a few bytes, far
// above the H100's ~20 (f32) or ~295 (bf16 tensor cores) flops per byte
// of device memory.  This first version is a plain tiled direct
// convolution on the f32 CUDA cores, right before fast:
//   * a block owns an 8x16 output tile of one image for 64 output
//     channels; each of its 256 threads keeps 8 pixels x 4 channels of f32
//     sums in registers;
//   * the input is walked in chunks of 8 channels: the haloed 10x18 input
//     tile and the matching 3x3x8x64 weight slice go to shared memory (as
//     f32), so every loaded value is reused by 32 (input) or 8 (weight)
//     multiply-adds;
//   * ragged tile edges, channel tails and the zero padding are masked at
//     load and store, so any H, W, C1, C2 is taken.
// Tensor cores (wgmma) and TMA loads are later work; until then this
// kernel runs far below the bound at bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TH = 8;    // output rows per block
constexpr int TW = 16;   // output columns per block
constexpr int CK = 8;    // input channels per shared-memory chunk
constexpr int CO = 64;   // output channels per block
constexpr int NT = 256;  // threads per block: TW columns x CO/4 channel lanes

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(NT)
    conv3x3_s1_kernel(const TI* __restrict__ x, const TI* __restrict__ w,
                      TO* __restrict__ out, int H, int W, int C1, int C2,
                      int tiles_w) {
  __shared__ float xs[TH + 2][TW + 2][CK];
  __shared__ float ws[9][CK][CO];

  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * CO;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane_c = tid % (CO / 4);  // this thread's channels: lane_c + 16*j
  const int col = tid / (CO / 4);     // this thread's output column in the tile
  const TI* xb = x + static_cast<size_t>(b) * H * W * C1;

  float acc[TH][4];
#pragma unroll
  for (int r = 0; r < TH; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;

  for (int c0 = 0; c0 < C1; c0 += CK) {
    for (int e = tid; e < (TH + 2) * (TW + 2) * CK; e += NT) {
      const int k = e % CK;
      const int rc = e / CK;
      const int c = rc % (TW + 2);
      const int r = rc / (TW + 2);
      const int h = h0 - 1 + r, ww = w0 - 1 + c, ci = c0 + k;
      float v = 0.0f;
      if (h >= 0 && h < H && ww >= 0 && ww < W && ci < C1)
        v = to_f32(xb[(static_cast<size_t>(h) * W + ww) * C1 + ci]);
      xs[r][c][k] = v;
    }
    for (int e = tid; e < 9 * CK * CO; e += NT) {
      const int o = e % CO;
      const int tk = e / CO;
      const int k = tk % CK;
      const int tap = tk / CK;
      const int ci = c0 + k, co = co0 + o;
      float v = 0.0f;
      if (ci < C1 && co < C2)
        v = to_f32(w[(static_cast<size_t>(tap) * C1 + ci) * C2 + co]);
      ws[tap][k][o] = v;
    }
    __syncthreads();
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
        for (int k = 0; k < CK; ++k) {
          float wv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) wv[j] = ws[dy * 3 + dx][k][lane_c + 16 * j];
#pragma unroll
          for (int r = 0; r < TH; ++r) {
            const float xv = xs[r + dy][col + dx][k];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[r][j] += xv * wv[j];
          }
        }
      }
    }
    __syncthreads();
  }

  const int ww = w0 + col;
  if (ww >= W) return;
#pragma unroll
  for (int r = 0; r < TH; ++r) {
    const int h = h0 + r;
    if (h >= H) break;
    TO* o = out + ((static_cast<size_t>(b) * H + h) * W + ww) * C2;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + lane_c + 16 * j;
      if (co < C2) o[co] = from_f32<TO>(acc[r][j]);
    }
  }
}

template <typename TI, typename TO>
void launch(const void* x, const void* w, void* out, int B, int H, int W,
            int C1, int C2, cudaStream_t stream) {
  const int tiles_w = (W + TW - 1) / TW;
  const dim3 grid(((H + TH - 1) / TH) * tiles_w, (C2 + CO - 1) / CO, B);
  conv3x3_s1_kernel<TI, TO><<<grid, NT, 0, stream>>>(
      static_cast<const TI*>(x), static_cast<const TI*>(w), static_cast<TO*>(out),
      H, W, C1, C2, tiles_w);
}

}  // namespace

// x (B, H, W, C1) and w (3, 3, C1, C2), both f32 or both bf16
// (in_bf16); out (B, H, W, C2) f32 or bf16 (out_bf16).  All contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int conv3x3_s1_launch(const void* x, const void* w, void* out,
                                 int B, int H, int W, int C1, int C2,
                                 int in_bf16, int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    if (out_bf16)
      launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, B, H, W, C1, C2, s);
    else
      launch<__nv_bfloat16, float>(x, w, out, B, H, W, C1, C2, s);
  } else {
    if (out_bf16)
      launch<float, __nv_bfloat16>(x, w, out, B, H, W, C1, C2, s);
    else
      launch<float, float>(x, w, out, B, H, W, C1, C2, s);
  }
  return static_cast<int>(cudaGetLastError());
}
