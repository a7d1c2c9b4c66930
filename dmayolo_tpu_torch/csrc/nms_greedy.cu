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
