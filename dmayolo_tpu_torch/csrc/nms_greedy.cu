// Greedy class-offset NMS, one thread block per image.
//
// Replaces the TPU kernel dmayolo_tpu/core/pallas_nms.py::
// pallas_batched_nms_core (body _nms_kernel), which pinned one image's
// candidates in VMEM and ran the max_det-step pick/suppress loop there.
//
// What bounds it on the card: neither bytes (20 B per candidate in, 5 B
// per output slot) nor operations (~15 flops per candidate per pick) —
// the chain of max_det dependent steps is.  Each step is a block-wide
// argmax followed by one parallel suppress pass, so its cost is the
// latency of two barriers and a shuffle reduction.  The design keeps
// that chain short and on one SM:
//   * the candidates (4 coordinates, area, live score, picked flag) sit in
//     shared memory for the whole loop, 28 bytes each;
//   * the argmax is warp shuffles, then one pass over the warp winners;
//   * a pick is written straight to keep_idx[t] (the TPU kernel wrote a
//     rank vector and argsorted it outside);
//   * the loop ends as soon as no live score is left, not after max_det.
// The remaining slots then get the unpicked indices in ascending order,
// so keep_idx equals the JAX function everywhere, padding included.
//
// Two kernels: nms_greedy_kernel holds the candidates in shared memory
// (K <= 1024, the serving path); nms_greedy_stream_kernel streams them
// from global memory for any K (the eval protocol's 30,000).  Both give
// the same output.
//
// Built with -fmad=false: the IoU must round exactly as the CPU reference
// does, or near-threshold pairs flip and keep sets stop being exact.
#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace {

constexpr float kNegInf = -1e10f;  // dropped candidates (core/nms.py NEG_INF)
constexpr unsigned kFull = 0xffffffffu;

// higher score wins; equal scores go to the lower index (jnp.argmax)
__device__ __forceinline__ void take_better(float& s, int& i, float s2, int i2) {
  if (s2 > s || (s2 == s && i2 < i)) {
    s = s2;
    i = i2;
  }
}

__device__ __forceinline__ void warp_argmax(float& s, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float s2 = __shfl_down_sync(kFull, s, off);
    int i2 = __shfl_down_sync(kFull, i, off);
    take_better(s, i, s2, i2);
  }
}

__global__ void nms_greedy_kernel(const float* __restrict__ boxes,
                                  const float* __restrict__ scores, int K,
                                  int max_det, float iou_thres,
                                  int* __restrict__ keep_idx,
                                  unsigned char* __restrict__ keep_valid) {
  extern __shared__ float smem[];
  float* sx1 = smem;
  float* sy1 = sx1 + K;
  float* sx2 = sy1 + K;
  float* sy2 = sx2 + K;
  float* sarea = sy2 + K;
  float* sscore = sarea + K;
  int* spicked = reinterpret_cast<int*>(sscore + K);
  __shared__ float red_s[32];
  __shared__ int red_i[32];
  __shared__ int s_best;
  __shared__ int s_valid;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (nthr + 31) >> 5;
  const float* bx = boxes + static_cast<size_t>(b) * K * 4;
  const float* sc = scores + static_cast<size_t>(b) * K;
  int* out_idx = keep_idx + static_cast<size_t>(b) * max_det;
  unsigned char* out_valid = keep_valid + static_cast<size_t>(b) * max_det;

  for (int i = tid; i < K; i += nthr) {
    const float x1 = bx[4 * i], y1 = bx[4 * i + 1];
    const float x2 = bx[4 * i + 2], y2 = bx[4 * i + 3];
    sx1[i] = x1;
    sy1[i] = y1;
    sx2[i] = x2;
    sy2[i] = y2;
    sarea[i] = (x2 - x1) * (y2 - y1);
    sscore[i] = sc[i];
    spicked[i] = 0;
  }
  __syncthreads();

  int n_picked = 0;
  for (int t = 0; t < max_det; ++t) {
    float bs = -INFINITY;
    int bi = INT_MAX;
    for (int i = tid; i < K; i += nthr) take_better(bs, bi, sscore[i], i);
    warp_argmax(bs, bi);
    if (lane == 0) {
      red_s[warp] = bs;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bs = lane < nwarps ? red_s[lane] : -INFINITY;
      bi = lane < nwarps ? red_i[lane] : INT_MAX;
      warp_argmax(bs, bi);
      if (lane == 0) {
        s_best = bi;
        s_valid = bs > kNegInf * 0.5f;
      }
    }
    __syncthreads();
    if (!s_valid) break;  // no live score left: every later step is empty
    const int best = s_best;
    if (tid == 0) {
      out_idx[t] = best;
      out_valid[t] = 1;
      spicked[best] = 1;
    }
    const float px1 = sx1[best], py1 = sy1[best];
    const float px2 = sx2[best], py2 = sy2[best];
    const float parea = sarea[best];
    for (int i = tid; i < K; i += nthr) {
      const float iw = fmaxf(fminf(px2, sx2[i]) - fmaxf(px1, sx1[i]), 0.0f);
      const float ih = fmaxf(fminf(py2, sy2[i]) - fmaxf(py1, sy1[i]), 0.0f);
      const float inter = iw * ih;
      const float iou = inter / (parea + sarea[i] - inter + 1e-7f);
      if (iou > iou_thres || i == best) sscore[i] = kNegInf;
    }
    n_picked = t + 1;
    __syncthreads();
  }

  // slots after the picks: unpicked indices in ascending order, then
  // (when K < max_det) index 0, all invalid
  if (warp == 0) {
    int count = n_picked;
    for (int base = 0; base < K && count < max_det; base += 32) {
      const int i = base + lane;
      const bool unpicked = i < K && !spicked[i];
      const unsigned mask = __ballot_sync(kFull, unpicked);
      const int pos = count + __popc(mask & ((1u << lane) - 1u));
      if (unpicked && pos < max_det) {
        out_idx[pos] = i;
        out_valid[pos] = 0;
      }
      count += __popc(mask);
    }
    for (int p = count + lane; p < max_det; p += 32) {
      out_idx[p] = 0;
      out_valid[p] = 0;
    }
  }
}

// The streaming variant, for candidate sets larger than one block's shared
// memory (the eval protocol's K = 30,000: 600 KB of boxes and scores an
// image).  The boxes stay in global memory, where the L2 cache holds a
// whole batch (19 MB at B = 32); the live scores go in a (B, K) scratch
// buffer; shared memory keeps only a picked bitmap (K bits).  Each step is
// one strided pass over the candidates: the suppress test of the current
// pick, fused with the argmax for the next one, and the IoU is computed
// only for candidates still live.
constexpr int kStreamThreads = 1024;

__global__ void __launch_bounds__(kStreamThreads)
nms_greedy_stream_kernel(const float* __restrict__ boxes,
                         const float* __restrict__ scores, int K, int max_det,
                         float iou_thres, float* __restrict__ live,
                         int* __restrict__ keep_idx,
                         unsigned char* __restrict__ keep_valid) {
  extern __shared__ unsigned spicked_bits[];
  __shared__ float red_s[32];
  __shared__ int red_i[32];
  __shared__ int s_best;
  __shared__ int s_valid;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (nthr + 31) >> 5;
  const int nbits = (K + 31) >> 5;
  const float4* bx = reinterpret_cast<const float4*>(boxes) + static_cast<size_t>(b) * K;
  const float* sc = scores + static_cast<size_t>(b) * K;
  float* lv = live + static_cast<size_t>(b) * K;
  int* out_idx = keep_idx + static_cast<size_t>(b) * max_det;
  unsigned char* out_valid = keep_valid + static_cast<size_t>(b) * max_det;

  for (int w = tid; w < nbits; w += nthr) spicked_bits[w] = 0u;
  float bs = -INFINITY;
  int bi = INT_MAX;
  for (int i = tid; i < K; i += nthr) {
    const float s = sc[i];
    lv[i] = s;
    take_better(bs, bi, s, i);
  }

  int n_picked = 0;
  for (int t = 0; t < max_det; ++t) {
    // block argmax of this thread's candidates' best
    warp_argmax(bs, bi);
    if (lane == 0) {
      red_s[warp] = bs;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bs = lane < nwarps ? red_s[lane] : -INFINITY;
      bi = lane < nwarps ? red_i[lane] : INT_MAX;
      warp_argmax(bs, bi);
      if (lane == 0) {
        s_best = bi;
        s_valid = bs > kNegInf * 0.5f;
      }
    }
    __syncthreads();
    if (!s_valid) break;  // no live score left: every later step is empty
    const int best = s_best;
    if (tid == 0) {
      out_idx[t] = best;
      out_valid[t] = 1;
      spicked_bits[best >> 5] |= 1u << (best & 31);
    }
    n_picked = t + 1;
    const float4 p = bx[best];
    const float parea = (p.z - p.x) * (p.w - p.y);
    bs = -INFINITY;
    bi = INT_MAX;
    for (int i = tid; i < K; i += nthr) {
      float s = lv[i];
      if (s > kNegInf) {  // a dropped candidate stays dropped: skip its IoU
        const float4 q = bx[i];
        const float iw = fmaxf(fminf(p.z, q.z) - fmaxf(p.x, q.x), 0.0f);
        const float ih = fmaxf(fminf(p.w, q.w) - fmaxf(p.y, q.y), 0.0f);
        const float inter = iw * ih;
        const float iou = inter / (parea + (q.z - q.x) * (q.w - q.y) - inter + 1e-7f);
        if (iou > iou_thres || i == best) {
          s = kNegInf;
          lv[i] = s;
        }
      }
      take_better(bs, bi, s, i);
    }
    // no barrier here: a thread reads and writes only its own candidates'
    // live scores, and the next step's first barrier orders the reuse of
    // red_s, red_i, s_best and s_valid
  }
  __syncthreads();  // the picked bitmap is complete

  // slots after the picks: unpicked indices in ascending order, then
  // (when K < max_det) index 0, all invalid
  if (warp == 0) {
    int count = n_picked;
    for (int base = 0; base < K && count < max_det; base += 32) {
      const int i = base + lane;
      const bool unpicked = i < K && !((spicked_bits[i >> 5] >> (i & 31)) & 1u);
      const unsigned mask = __ballot_sync(kFull, unpicked);
      const int pos = count + __popc(mask & ((1u << lane) - 1u));
      if (unpicked && pos < max_det) {
        out_idx[pos] = i;
        out_valid[pos] = 0;
      }
      count += __popc(mask);
    }
    for (int p = count + lane; p < max_det; p += 32) {
      out_idx[p] = 0;
      out_valid[p] = 0;
    }
  }
}

}  // namespace

// boxes (B, K, 4) f32 xyxy, class offset applied; scores (B, K) f32 with
// dropped candidates at -1e10; keep_idx (B, max_det) int32; keep_valid
// (B, max_det) bool.  Returns cudaGetLastError() after the launch.
extern "C" int nms_greedy_launch(const float* boxes, const float* scores,
                                 int B, int K, int max_det, float iou_thres,
                                 int* keep_idx, unsigned char* keep_valid,
                                 void* stream) {
  int threads = ((K + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 512 ? 512 : threads);
  const size_t shmem = static_cast<size_t>(K) * (6 * sizeof(float) + sizeof(int));
  nms_greedy_kernel<<<B, threads, shmem, static_cast<cudaStream_t>(stream)>>>(
      boxes, scores, K, max_det, iou_thres, keep_idx, keep_valid);
  return static_cast<int>(cudaGetLastError());
}

// The streaming variant, any K: as nms_greedy_launch, plus `live`, a
// (B, K) f32 scratch buffer the kernel overwrites; boxes 16-byte aligned.
extern "C" int nms_greedy_stream_launch(const float* boxes, const float* scores,
                                        int B, int K, int max_det, float iou_thres,
                                        float* live, int* keep_idx,
                                        unsigned char* keep_valid, void* stream) {
  const size_t shmem = static_cast<size_t>((K + 31) / 32) * sizeof(unsigned);
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_greedy_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_greedy_stream_kernel<<<B, kStreamThreads, shmem, static_cast<cudaStream_t>(stream)>>>(
      boxes, scores, K, max_det, iou_thres, live, keep_idx, keep_valid);
  return static_cast<int>(cudaGetLastError());
}
