// Greedy-NMS keep flags of rank-sorted candidates by the suppression DAG:
// one thread block per image, 1024 threads, blocks of at most 512
// candidates.
//
// Replaces the TPU kernel experiments/exp_pallas_fixpoint.py::
// pallas_fixpoint_keep (body _fixpoint_nms_kernel), which built the
// (K, K) suppression matrix S in VMEM and iterated the fixpoint there as
// MXU matvecs.  Semantics, as core/fixpoint_kernel.py's plain versions:
//   S_ij = test(i, j) & (i < j) & alive_i   (i suppresses j)
//   keep_j = alive_j & !(exists i < j: keep_i & S_ij)
// which is the fixpoint of T(k)_j = !(exists i: S_ij k_i) & alive_j that
// the TPU kernel iterates, and greedy NMS's keep set.  Two forms of
// test(i, j), as the caller's plain version: inter / union > t (divide,
// `_pairwise_iou`) or inter > t * union (the divide-free
// `_suppression_matrix`); iou_test.cuh rounds both exactly.
//
// Two entries share the in-block step (build_rows, then scan_keep):
//   * nms_fixpoint_kernel: K <= 512, one block of candidates an image
//     (`nms_matrix`, serving);
//   * nms_fixpoint_blocked_kernel: any K, the blocked path of
//     `nms_matrix_blocked` in one launch.  It walks the image's blocks in
//     rank order; a candidate is alive when valid and no earlier keeper
//     suppresses it (the cross test, divide form, keeper first); the
//     block's keepers join a keeper list.  It stops at max_det keepers:
//     for rank-sorted candidates the outputs hold only the first max_det
//     keepers in index order, so later flags come back false and the
//     list never holds more than max_det boxes.  It also writes
//     `nms_matrix_blocked`'s outputs, keep_idx (the keepers in index
//     order, then the other indices ascending) and keep_valid, which for
//     rank-sorted candidates is the order of the stable sort by score.
//
// What bounds it on the card: neither bytes (18 B a candidate) nor the
// IoU tests (~15 flops each, microseconds of the card) but the latency of
// one SM working through an image.  The design keeps that short:
//   * S is bits in shared memory, row-major (row i: whom i suppresses, 16
//     words).  Its upper triangle is built as 32x32 tiles dealt over the
//     32 warps: each lane makes one word per tile, at most 5 tiles a warp,
//     so no thread does more than 160 tests (one thread a column would
//     leave the last warp 511 serial tests);
//   * the divide test divides only within 2^-18 of the threshold
//     (iou_test.cuh), and a pair that does not intersect costs no
//     quotient at all;
//   * the keep flags come from one warp's greedy scan over the words: for
//     word I, the candidates not yet removed are resolved against the
//     32x32 diagonal tile in registers, and the keepers' rows are ORed
//     into the removed mask, lane w holding word w.  16 steps, no block
//     barrier (the bracket fixpoint takes one barrier a step, up to K).
//     Each warp computes its own tile numbers, and the scan reads the
//     diagonal into registers: walking all 136 tile numbers in every warp,
//     or shuffling the diagonal one bit at a time, cost more than the
//     tests themselves.
//
// Built with -fmad=false: every product and sum of the IoU rounds as in
// the plain PyTorch version and the JAX reference.
#include <cuda_runtime.h>

#include "iou_test.cuh"

namespace {

using iou_test::Thres;

constexpr int kMaxK = 512;  // candidates of one block
constexpr int kWords = kMaxK / 32;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// keeper boxes the blocked kernel holds in shared memory beside S (20 B
// each); a larger max_det keeps its list in a global scratch buffer
constexpr int kSharedListMax = 8192;

struct Block {
  float4 box[kMaxK];
  float area[kMaxK];
  unsigned row[kMaxK][kWords];  // S: bit b of row[i][w] = i suppresses 32w + b
  unsigned alive[kWords];       // candidates that may be kept
  unsigned keep[kWords];        // the keep flags
  int before[kWords];           // keepers in the words before each word
  unsigned sup[kWords];         // suppressed by an earlier block's keeper
  int kept;                     // keepers of the block
};

// Loads candidates [0, n) of one block: boxes, areas, and `valid` as
// alive words.  Needs a barrier before use.
__device__ __forceinline__ void load_block(Block& s, const float4* __restrict__ boxes,
                                           const unsigned char* __restrict__ valid, int n) {
  const int tid = threadIdx.x;
  bool v = false;
  if (tid < n) {
    const float4 bx = boxes[tid];
    s.box[tid] = bx;
    s.area[tid] = iou_test::area(bx);
    v = valid[tid] != 0;
  }
  const unsigned word = __ballot_sync(kFull, v);
  if ((tid & 31) == 0 && (tid >> 5) < kWords) {
    s.alive[tid >> 5] = word;
    s.sup[tid >> 5] = 0u;
  }
}

// S over the alive candidates of nw words: the nw (nw + 1) / 2 tiles
// (I, J), I <= J, of the upper triangle, numbered column by column and
// dealt round-robin over the warps.  Lane l of the warp builds row 32I + l
// of the tile; the column loop runs over alive j only and is the same in
// every lane, so the column box is one broadcast read.  In the divide
// form with t >= 0 a column that meets no row of the warp is decided
// without a quotient (0 / union is never above t).  Words left of the
// diagonal are never read.
template <bool kDivide>
__device__ void build_rows(Block& s, int nw, const Thres& th) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool skip_disjoint = kDivide && th.t >= 0.0f;
  for (int tile = warp; tile < nw * (nw + 1) / 2; tile += kWarps) {
    int J = static_cast<int>((sqrtf(8.0f * tile + 1.0f) - 1.0f) * 0.5f);
    if ((J + 1) * (J + 2) / 2 <= tile) ++J;
    if (J * (J + 1) / 2 > tile) --J;
    const int I = tile - J * (J + 1) / 2;
    const int i = I * 32 + lane;
    const bool row_alive = (s.alive[I] >> lane) & 1u;
    const unsigned later = I < J ? kFull : ~((2u << lane) - 1u);  // j > i
    const float4 bi = s.box[i];
    const float ai = s.area[i];
    unsigned cols = __any_sync(kFull, row_alive) ? s.alive[J] : 0u;
    unsigned word = 0;
    while (cols) {
      const int b = __ffs(cols) - 1;
      cols &= cols - 1;
      const int j = J * 32 + b;
      const float inter = iou_test::intersection(bi, s.box[j]);
      if (skip_disjoint && !__any_sync(kFull, row_alive && inter != 0.0f)) continue;
      if (row_alive && iou_test::above<kDivide>(inter, ai, s.area[j], th)) word |= 1u << b;
    }
    s.row[i][J] = word & later;
  }
}

// The greedy keep flags of the block from S, in warp 0: at most `limit`
// keepers, the first in index order.  Writes s.keep, s.before, s.kept.
// Word I's candidates are resolved against the diagonal tile held in
// registers (broadcast reads), then every lane ORs the keepers' rows into
// its word of the removed mask, branch-free.
__device__ void scan_keep(Block& s, int nw, int limit) {
  const int lane = threadIdx.x & 31;
  const unsigned alive = lane < nw ? s.alive[lane] : 0u;
  unsigned removed = 0;  // lane w: word w of the candidates a keeper suppresses
  int count = 0;
  if (lane < kWords) s.keep[lane] = 0u;
  __syncwarp();
  for (int I = 0; I < nw && count < limit; ++I) {
    unsigned cand = __shfl_sync(kFull, alive & ~removed, I);
    unsigned kept = 0;
#pragma unroll
    for (int h = 0; h < 32; h += 16) {
      unsigned d[16];  // whom 32I + h + b suppresses in word I
#pragma unroll
      for (int b = 0; b < 16; ++b) d[b] = s.row[I * 32 + h + b][I];
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        const unsigned bit = 1u << (h + b);
        const bool k = cand & bit;
        kept |= k ? bit : 0u;
        cand &= k ? ~d[b] : kFull;
      }
    }
    while (__popc(kept) > limit - count) kept &= ~(0x80000000u >> __clz(kept));
    if (lane == 0) {
      s.keep[I] = kept;
      s.before[I] = count;
    }
    count += __popc(kept);
    unsigned hit = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const unsigned r = s.row[I * 32 + b][lane & (kWords - 1)];
      hit |= (kept >> b) & 1u ? r : 0u;
    }
    removed |= hit;
  }
  if (lane == 0) s.kept = count;
}

template <bool kDivide>
__global__ void __launch_bounds__(kThreads, 1)
nms_fixpoint_kernel(const float4* __restrict__ boxes, const unsigned char* __restrict__ valid,
                    int K, float iou_thres, unsigned char* __restrict__ keep) {
  __shared__ Block s;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nw = (K + 31) >> 5;
  const Thres th = iou_test::make_thres(iou_thres);
  load_block(s, boxes + static_cast<size_t>(b) * K, valid + static_cast<size_t>(b) * K, K);
  __syncthreads();
  build_rows<kDivide>(s, nw, th);
  __syncthreads();
  if (tid < 32) scan_keep(s, nw, K);
  __syncthreads();
  if (tid < K) keep[static_cast<size_t>(b) * K + tid] = (s.keep[tid >> 5] >> (tid & 31)) & 1u;
}

// The blocked path, divide form.  The keeper list is in dynamic shared
// memory (kSharedList) or in the global scratch list_box / list_area at
// max_det entries an image.
template <bool kSharedList>
__global__ void __launch_bounds__(kThreads, 1)
nms_fixpoint_blocked_kernel(const float4* __restrict__ boxes,
                            const unsigned char* __restrict__ valid, int K, int block,
                            int max_det, float iou_thres, float4* __restrict__ list_box,
                            float* __restrict__ list_area, unsigned char* __restrict__ keep,
                            int* __restrict__ walked, int* __restrict__ keep_idx,
                            unsigned char* __restrict__ keep_valid) {
  __shared__ Block s;
  extern __shared__ float4 list_smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const Thres th = iou_test::make_thres(iou_thres);
  float4* kbox = kSharedList ? list_smem : list_box + static_cast<size_t>(b) * max_det;
  float* karea = kSharedList ? reinterpret_cast<float*>(list_smem + max_det)
                             : list_area + static_cast<size_t>(b) * max_det;
  const float4* bx = boxes + static_cast<size_t>(b) * K;
  const unsigned char* vd = valid + static_cast<size_t>(b) * K;
  unsigned char* out = keep + static_cast<size_t>(b) * K;
  int* out_idx = keep_idx + static_cast<size_t>(b) * max_det;
  unsigned char* out_valid = keep_valid + static_cast<size_t>(b) * max_det;

  int count = 0;  // keepers so far; the same in every thread
  int start = 0;
  for (; start < K && count < max_det; start += block) {
    const int n = min(block, K - start);
    const int nw = (n + 31) >> 5;
    load_block(s, bx + start, vd + start, n);
    __syncthreads();
    if (count > 0) {
      // cross test: candidate c against keepers c_half, c_half + 2, ...
      const int c = tid & (kMaxK - 1);
      bool hit = false;
      if (c < n && ((s.alive[c >> 5] >> (c & 31)) & 1u)) {
        const float4 q = s.box[c];
        const float qa = s.area[c];
        for (int k = tid / kMaxK; k < count; k += kThreads / kMaxK)
          if (iou_test::suppresses<true>(kbox[k], karea[k], q, qa, th)) {
            hit = true;
            break;
          }
      }
      const unsigned word = __ballot_sync(kFull, hit);
      if (lane == 0 && word) atomicOr(&s.sup[(c >> 5)], word);
      __syncthreads();
      if (tid < nw) s.alive[tid] &= ~s.sup[tid];
      __syncthreads();
    }
    build_rows<true>(s, nw, th);
    __syncthreads();
    if (tid < 32) scan_keep(s, nw, max_det - count);
    __syncthreads();
    if (tid < n) {
      const unsigned w = s.keep[tid >> 5];
      const bool k = (w >> (tid & 31)) & 1u;
      out[start + tid] = k;
      if (k) {
        const int pos = count + s.before[tid >> 5] + __popc(w & ((1u << (tid & 31)) - 1u));
        kbox[pos] = s.box[tid];
        karea[pos] = s.area[tid];
        out_idx[pos] = start + tid;
        out_valid[pos] = 1;
      }
    }
    count += s.kept;
    __syncthreads();  // the list is complete; s is free for the next block
  }
  for (int j = start + tid; j < K; j += kThreads) out[j] = 0;
  if (tid == 0) walked[b] = (start + block - 1) / block;
  // slots after the keepers: the other indices in ascending order, then
  // (when K < max_det) index 0, all invalid.  The flags of the walked
  // blocks are this block's own writes, ordered by the loop's barrier.
  if (tid < 32) {
    int pos = count;
    for (int base = 0; base < K && pos < max_det; base += 32) {
      const int j = base + lane;
      const bool other = j < K && (j >= start || !out[j]);
      const unsigned mask = __ballot_sync(kFull, other);
      const int p = pos + __popc(mask & ((1u << lane) - 1u));
      if (other && p < max_det) {
        out_idx[p] = j;
        out_valid[p] = 0;
      }
      pos += __popc(mask);
    }
    for (int p = pos + lane; p < max_det; p += 32) {
      out_idx[p] = 0;
      out_valid[p] = 0;
    }
  }
}

}  // namespace

// boxes (B, K, 4) f32 xyxy, 16-byte aligned, rank-sorted, class offset
// applied; valid (B, K) bool; keep (B, K) bool; 0 < K <= 512.  divide != 0
// selects the test inter / union > t, else inter > t * union.  Returns
// cudaGetLastError() after the launch.
extern "C" int nms_fixpoint_launch(const float* boxes, const unsigned char* valid,
                                   int B, int K, float iou_thres, int divide,
                                   unsigned char* keep, void* stream) {
  if (K <= 0 || K > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* bx = reinterpret_cast<const float4*>(boxes);
  if (divide)
    nms_fixpoint_kernel<true><<<B, kThreads, 0, s>>>(bx, valid, K, iou_thres, keep);
  else
    nms_fixpoint_kernel<false><<<B, kThreads, 0, s>>>(bx, valid, K, iou_thres, keep);
  return static_cast<int>(cudaGetLastError());
}

// The blocked path in one launch, divide form: blocks of `block` (1 to
// 512) candidates, at most max_det (>= 0) keepers an image.  As
// nms_fixpoint_launch, plus walked (B,) int32, the blocks walked an image,
// and keep_idx (B, max_det) int32, keep_valid (B, max_det) bool.
// max_det above nms_fixpoint_shared_list_max() needs list_box (B,
// max_det, 4) and list_area (B, max_det) f32 scratch; below it they may
// be null.
extern "C" int nms_fixpoint_blocked_launch(const float* boxes, const unsigned char* valid,
                                           int B, int K, int block, int max_det,
                                           float iou_thres, float* list_box, float* list_area,
                                           unsigned char* keep, int* walked, int* keep_idx,
                                           unsigned char* keep_valid, void* stream) {
  if (K <= 0 || block <= 0 || block > kMaxK || max_det < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* bx = reinterpret_cast<const float4*>(boxes);
  if (max_det <= kSharedListMax) {
    const size_t shmem = static_cast<size_t>(max_det) * (sizeof(float4) + sizeof(float));
    const cudaError_t err = cudaFuncSetAttribute(nms_fixpoint_blocked_kernel<true>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(shmem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // leave no error behind for the next launch's check
      return static_cast<int>(err);
    }
    nms_fixpoint_blocked_kernel<true><<<B, kThreads, shmem, s>>>(
        bx, valid, K, block, max_det, iou_thres, nullptr, nullptr, keep, walked, keep_idx,
        keep_valid);
  } else {
    if (list_box == nullptr || list_area == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    nms_fixpoint_blocked_kernel<false><<<B, kThreads, 0, s>>>(
        bx, valid, K, block, max_det, iou_thres, reinterpret_cast<float4*>(list_box),
        list_area, keep, walked, keep_idx, keep_valid);
  }
  return static_cast<int>(cudaGetLastError());
}

// The largest max_det whose keeper list the blocked kernel holds in
// shared memory.
extern "C" int nms_fixpoint_shared_list_max() { return kSharedListMax; }
