// Greedy-NMS keep flags by the suppression-DAG fixpoint, one thread block
// per image, K <= 512 rank-sorted candidates.
//
// Replaces the TPU kernel experiments/exp_pallas_fixpoint.py::
// pallas_fixpoint_keep (body _fixpoint_nms_kernel), which built the
// (K, K) suppression matrix S in VMEM and iterated the fixpoint there as
// MXU matvecs.  Semantics, as core/nms.py::_fixpoint_keep:
//   S_ij = test(i, j) & (i < j) & valid_i   (i suppresses j)
//   T(k)_j = !(exists i: S_ij & k_i) & valid_j
//   lo = T(valid), hi = T(lo); then (lo, hi) = (T(hi), T(lo)) until
//   lo == hi or K steps; keep = lo.
// Two forms of test(i, j), chosen by the caller to match its plain
// version exactly: inter / union > t (divide, the blocked path through
// _pairwise_iou) or inter > t * union (the divide-free _suppression_matrix
// of nms_matrix), union = a_i + a_j - inter + 1e-7.
//
// What bounds it on the card: neither bytes (17 B in and 1 B out per
// candidate) nor the K^2/2 IoU tests (~15 flops each, a few microseconds
// of one SM) but the chain of fixpoint steps, each a block-wide barrier.
// The design keeps each step to a few instructions:
//   * S is bits: thread j holds column j (the suppressors of j), 16 words
//     of 32 bits, in registers; no other thread reads it;
//   * a keep vector is 16 words in shared memory; T(k)_j is 16 ANDs, and
//     the new vector is one warp ballot a word;
//   * both brackets advance in one step, into a second buffer, so a step
//     costs one barrier.  Sums of 0/1 on the MXU become ORs of bits: exact.
//
// Built with -fmad=false: every product and sum of the IoU rounds as in
// the plain PyTorch version and the JAX reference.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 512;
constexpr int kWords = kMaxK / 32;
constexpr unsigned kFull = 0xffffffffu;

template <bool kDivide>
__global__ void __launch_bounds__(kMaxK)
nms_fixpoint_kernel(const float* __restrict__ boxes,
                    const unsigned char* __restrict__ valid, int K,
                    float iou_thres, unsigned char* __restrict__ keep) {
  __shared__ float sx1[kMaxK], sy1[kMaxK], sx2[kMaxK], sy2[kMaxK], sarea[kMaxK];
  __shared__ unsigned svalid[kWords];
  __shared__ unsigned sbuf[2][2][kWords];  // [buffer][lo, hi][word]

  const int b = blockIdx.x;
  const int j = threadIdx.x;  // this thread's column: the candidate suppressed
  const int lane = j & 31;
  const int warp = j >> 5;
  const int nwords = (K + 31) >> 5;  // == blockDim.x / 32

  float jx1 = 0.f, jy1 = 0.f, jx2 = 0.f, jy2 = 0.f, jarea = 0.f;
  bool vj = false;
  if (j < K) {
    const float* bx = boxes + (static_cast<size_t>(b) * K + j) * 4;
    jx1 = bx[0];
    jy1 = bx[1];
    jx2 = bx[2];
    jy2 = bx[3];
    jarea = (jx2 - jx1) * (jy2 - jy1);
    sx1[j] = jx1;
    sy1[j] = jy1;
    sx2[j] = jx2;
    sy2[j] = jy2;
    sarea[j] = jarea;
    vj = valid[static_cast<size_t>(b) * K + j] != 0;
  }
  const unsigned vword = __ballot_sync(kFull, vj);
  if (lane == 0) svalid[warp] = vword;
  __syncthreads();

  // column j of S, as bits over the rows i < j
  unsigned col[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    unsigned word = 0;
    if (w * 32 < j) {
      const unsigned vw = svalid[w];
      const int n = min(32, j - w * 32);
      for (int t = 0; t < n; ++t) {
        if (!((vw >> t) & 1u)) continue;
        const int i = w * 32 + t;
        const float iw = fmaxf(fminf(sx2[i], jx2) - fmaxf(sx1[i], jx1), 0.0f);
        const float ih = fmaxf(fminf(sy2[i], jy2) - fmaxf(sy1[i], jy1), 0.0f);
        const float inter = iw * ih;
        const float uni = sarea[i] + jarea - inter + 1e-7f;
        const bool s = kDivide ? (inter / uni > iou_thres) : (inter > iou_thres * uni);
        word |= static_cast<unsigned>(s) << t;
      }
    }
    col[w] = word;
  }

  // T(k)_j: no kept suppressor of j, and j valid
  auto T = [&](const unsigned* k) {
    unsigned hit = 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w)
      if (w < nwords) hit |= col[w] & k[w];
    return hit == 0 && vj;
  };

  bool t = T(svalid);  // lo0
  unsigned word = __ballot_sync(kFull, t);
  if (lane == 0) sbuf[0][0][warp] = word;
  __syncthreads();
  t = T(sbuf[0][0]);  // hi0
  word = __ballot_sync(kFull, t);
  if (lane == 0) sbuf[0][1][warp] = word;
  __syncthreads();

  int cur = 0;
  for (int it = 0; it < K; ++it) {
    bool differ = false;
    for (int w = 0; w < nwords; ++w) differ |= sbuf[cur][0][w] != sbuf[cur][1][w];
    if (!differ) break;  // the same answer in every thread
    const bool nlo = T(sbuf[cur][1]);  // T(hi) refines lo upward
    const bool nhi = T(sbuf[cur][0]);  // T(lo) refines hi downward
    const unsigned wlo = __ballot_sync(kFull, nlo);
    const unsigned whi = __ballot_sync(kFull, nhi);
    if (lane == 0) {
      sbuf[cur ^ 1][0][warp] = wlo;
      sbuf[cur ^ 1][1][warp] = whi;
    }
    __syncthreads();
    cur ^= 1;
  }
  if (j < K) keep[static_cast<size_t>(b) * K + j] = (sbuf[cur][0][warp] >> lane) & 1u;
}

}  // namespace

// boxes (B, K, 4) f32 xyxy, rank-sorted, class offset applied; valid
// (B, K) bool; keep (B, K) bool; 0 < K <= 512.  divide != 0 selects the
// test inter / union > t, else inter > t * union.  Returns
// cudaGetLastError() after the launch.
extern "C" int nms_fixpoint_launch(const float* boxes, const unsigned char* valid,
                                   int B, int K, float iou_thres, int divide,
                                   unsigned char* keep, void* stream) {
  if (K <= 0 || K > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = ((K + 31) / 32) * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (divide)
    nms_fixpoint_kernel<true><<<B, threads, 0, s>>>(boxes, valid, K, iou_thres, keep);
  else
    nms_fixpoint_kernel<false><<<B, threads, 0, s>>>(boxes, valid, K, iou_thres, keep);
  return static_cast<int>(cudaGetLastError());
}
