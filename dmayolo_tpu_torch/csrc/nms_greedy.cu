// Greedy class-offset NMS, one thread block per image.
//
// Replaces the TPU kernel dmayolo_tpu/core/pallas_nms.py::
// pallas_batched_nms_core (body _nms_kernel), which pinned one image's
// candidates in VMEM and ran the max_det-step pick/suppress loop there.
//
// What bounds it on the card: neither bytes (20 B per candidate in, 5 B
// per output slot) nor operations (~15 flops per candidate per pick) —
// the chain of max_det dependent steps is.  Each step is an argmax over
// the image's live scores and a suppress pass against the pick, so a
// step costs the latency of its reduction and its barriers plus the pass.
//   * a pick is written straight to keep_idx[t] (the TPU kernel wrote a
//     rank vector and argsorted it outside);
//   * the loop ends as soon as no live score is left, not after max_det;
//   * the suppress pass for pick t is fused with the argmax for pick t + 1,
//     and skips candidates already dropped.
// The remaining slots then get the unpicked indices in ascending order,
// so keep_idx equals the JAX function everywhere, padding included.
//
// Three kernels, routed by K:
//   * nms_greedy_group_kernel (K <= 1024, the serving path): a block of
//     four warps owns one image.  Each lane keeps its PER <= 8 candidates
//     (box, area, and the live score as an order-preserving integer key)
//     in registers, so a step has one block barrier: the argmax is
//     `__reduce_max_sync` on the key, then `__reduce_min_sync` on the
//     index among the lanes with that key (higher score, then lower index,
//     as `jnp.argmax`); the four warps' winners meet in shared memory,
//     double-buffered by step parity.  The pick's box is one broadcast
//     read of a copy of the boxes in shared memory (a register array
//     indexed by the pick would spill).  The pass is straight-line over a
//     lane's slots, the IoU test decided by two products (`quick_above`),
//     so the slots' tests overlap.  One or two warps an image, with twice
//     or four times the slots a lane, ran slower at every shape timed.
//   * nms_greedy_cluster_kernel spreads the candidates over the shared
//     memory of a thread-block cluster (up to about 90,000; the eval
//     protocol's 30,000);
//   * nms_greedy_stream_kernel streams them from global memory for any K.
// All three give the same output.
//
// Built with -fmad=false: the IoU must round exactly as the CPU reference
// does, or near-threshold pairs flip and keep sets stop being exact.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>
#include <cmath>

#include "iou_test.cuh"

namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------------------
// K <= 1024: four warps an image, the candidates in registers
// ---------------------------------------------------------------------------

constexpr int kGroupWarps = 4;
constexpr int kGroupThreads = 32 * kGroupWarps;  // a block, an image
constexpr int kMaxPerLane = 8;                   // candidates a lane keeps: 1024 / 128

// An order-preserving key of a score: key(a) > key(b) exactly when a > b
// as floats, with -0 and +0 one key, as a float compare has them equal
// (every key of a number is above 0).
__device__ __forceinline__ unsigned score_key(float s) {
  unsigned u = __float_as_uint(s);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// rn(inter / uni) > t as far as two products tell it, without a branch: 1
// or 0, or -1 where only the IEEE quotient can.  With inter in [+0, 2^60],
// uni in [2^-60, 2^60] and t normal, hi * uni neither overflows nor
// underflows and rounds within 2^-24 of the exact product, so inter above
// it puts the exact quotient Q above t (1 + 2^-19), more than 16 ulps of
// t, and rn(Q) > t; inter below lo * uni puts rn(Q) below t.  (The range
// checks compare the bits: +0 up to 2^60, and 2^-60 up to 2^60.)
__device__ __forceinline__ int quick_above(float inter, float uni, const iou_test::Thres& th) {
  const unsigned ii = __float_as_uint(inter), ui = __float_as_uint(uni);
  const bool in_range = ii <= 0x5d800000u && ui - 0x21800000u <= 0x5d800000u - 0x21800000u;
  return in_range && inter > th.hi * uni ? 1 : (in_range && inter < th.lo * uni ? 0 : -1);
}

// Lane `tid` of the block holds candidates tid, tid + 128, ..., PER of them
// (slots past K hold a -inf score); shared memory keeps a copy of every
// box, for the pick's, and a picked flag each, for the tail.
template <int PER>
__global__ void __launch_bounds__(kGroupThreads)
nms_greedy_group_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores, int K,
                        int max_det, float iou_thres, int* __restrict__ keep_idx,
                        unsigned char* __restrict__ keep_valid) {
  constexpr int KP = kGroupThreads * PER;  // candidate slots of the block
  __shared__ float4 sbox[KP];
  __shared__ unsigned char spicked[KP];
  __shared__ uint2 winners[2][kGroupWarps];  // (key, index) a warp, by step parity
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x;
  const float4* bx = boxes + static_cast<size_t>(b) * K;
  const float* sc = scores + static_cast<size_t>(b) * K;
  int* out_idx = keep_idx + static_cast<size_t>(b) * max_det;
  unsigned char* out_valid = keep_valid + static_cast<size_t>(b) * max_det;
  const iou_test::Thres th = iou_test::make_thres(iou_thres);
  const unsigned dead = score_key(kNegInf);             // a dropped candidate's key
  const unsigned live_key = score_key(kNegInf * 0.5f);  // a pick needs a key above it

  // the live scores as keys: a lane's best is its first slot (lowest
  // index) with the highest key
  float4 q[PER];
  float qa[PER];
  unsigned s[PER];
  unsigned key = 0u;
  int bi = INT_MAX;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = j * kGroupThreads + tid;
    q[j] = i < K ? bx[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    s[j] = score_key(i < K ? sc[i] : -INFINITY);
    qa[j] = iou_test::area(q[j]);
    sbox[i] = q[j];
    spicked[i] = 0;
    if (s[j] > key) key = s[j], bi = i;
  }
  __syncthreads();

  int n_picked = 0;
  for (int t = 0; t < max_det; ++t) {
    // the block's best of the lanes' bests: the highest key, then the
    // lowest index among the lanes holding it.  One barrier a step: a
    // warp writes this step's winner in the buffer of its parity, which
    // every warp read before the barrier of the step in between.
    unsigned best_key = __reduce_max_sync(kFull, key);
    unsigned best = __reduce_min_sync(kFull, key == best_key ? static_cast<unsigned>(bi) : UINT_MAX);
    if (lane == 0) winners[t & 1][warp] = make_uint2(best_key, best);
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kGroupWarps; ++w) {
      const uint2 o = winners[t & 1][w];
      if (o.x > best_key || (o.x == best_key && o.y < best)) {
        best_key = o.x;
        best = o.y;
      }
    }
    if (best_key <= live_key) break;  // no live score left: every later step is empty
    if (tid == 0) {
      out_idx[t] = static_cast<int>(best);
      out_valid[t] = 1;
      spicked[best] = 1;
    }
    n_picked = t + 1;
    const float4 p = sbox[best];
    const float parea = iou_test::area(p);
    // the suppress pass, straight-line over the lane's slots so their
    // tests overlap: two products decide (quick_above); the few pairs
    // within 2^-18 of the threshold divide after it, in a branch the warp
    // takes only when one of its lanes has such a pair.  A dropped
    // candidate stays dropped whatever its test says.
    unsigned undecided = 0u;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = j * kGroupThreads + tid;
      const float inter = iou_test::intersection(p, q[j]);
      const int quick = quick_above(inter, parea + qa[j] - inter + 1e-7f, th);
      const bool live = s[j] > dead;
      s[j] = live && (i == static_cast<int>(best) || quick == 1) ? dead : s[j];
      undecided |= static_cast<unsigned>(live && i != static_cast<int>(best) && quick < 0) << j;
    }
    if (__any_sync(kFull, undecided != 0u)) {
#pragma unroll
      for (int j = 0; j < PER; ++j)
        if ((undecided >> j) & 1u) {
          const float inter = iou_test::intersection(p, q[j]);
          if (__fdiv_rn(inter, parea + qa[j] - inter + 1e-7f) > th.t) s[j] = dead;
        }
    }
    key = 0u;
    bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (s[j] > key) key = s[j], bi = j * kGroupThreads + tid;
  }
  __syncthreads();  // the picked flags are complete

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

template <int PER>
int launch_group(const float* boxes, const float* scores, int B, int K, int max_det,
                 float iou_thres, int* keep_idx, unsigned char* keep_valid, cudaStream_t stream) {
  nms_greedy_group_kernel<PER><<<B, kGroupThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(boxes), scores, K, max_det, iou_thres, keep_idx,
      keep_valid);
  return static_cast<int>(cudaGetLastError());
}

// The global-memory variant, for candidate sets larger than a cluster's
// shared memory holds (above about 90,000; 20 bytes of box and score a
// candidate).  The boxes stay in global memory, where the L2 cache holds
// a whole batch (19 MB at B = 32, K = 30,000); the live scores go in a
// (B, K) scratch buffer; shared memory keeps only a picked bitmap (K bits).  Each step is
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

// The cluster variant: one cluster of C blocks an image (C = 1-8, picked
// by the host from B, K and the card's occupancy).  Block r holds the
// contiguous slice [r * slice, (r + 1) * slice) of the candidates in its
// shared memory, 20 bytes each (the float4 box and the live score), plus
// a picked bitmap; nothing is written to global memory until the picks.
// Each step, every block runs the fused suppress pass and argmax over its
// slice, then pushes its winner (box, score, index) into an inbox in the
// shared memory of every block of the cluster, itself included, by
// `st.async`, which completes the bytes on the receiver's mbarrier.  A
// block waits on its own mbarrier for the C winners and takes the same
// best as every other block.  So a step costs one block barrier and one
// remote store's latency; a `barrier.cluster` a step, with the winners
// read remotely after it, cost more than the pass over 7,500 candidates.
// At B = 32 and K = 30,000 the host picks C = 3 (10,000 candidates,
// 200 KB, a block; 96 SMs in one wave).
constexpr int kClusterThreads = 1024;
constexpr int kMaxCluster = 8;
constexpr int kWinnerBytes = 24;  // the box (16) and score, index (8) of a winner

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the address `addr` of this block's shared memory has in block `rank`'s
__device__ __forceinline__ unsigned map_rank(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// this block's one arrival a phase, expecting `bytes` of remote stores
__device__ __forceinline__ void mbar_expect(unsigned bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// a winner into the inbox entry `dst` of another block (cluster address),
// completing its 24 bytes on that block's mbarrier `bar`
__device__ __forceinline__ void push_winner(unsigned dst, unsigned bar, float4 box, float score,
                                            int index) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(dst), "f"(box.x), "f"(box.y), "f"(box.z), "f"(box.w), "r"(bar)
      : "memory");
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];"
               ::"r"(dst + 16), "r"(__float_as_uint(score)), "r"(index), "r"(bar)
               : "memory");
}

struct __align__(16) Winner {
  float4 box;
  float score;
  int index;
  int pad[2];
};

// every lane ends with the best of the warp's (s, i)
__device__ __forceinline__ void warp_argmax_all(float& s, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float s2 = __shfl_xor_sync(kFull, s, off);
    const int i2 = __shfl_xor_sync(kFull, i, off);
    take_better(s, i, s2, i2);
  }
}

__global__ void __launch_bounds__(kClusterThreads, 1)
nms_greedy_cluster_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
                          int K, int slice, int max_det, float iou_thres,
                          int* __restrict__ keep_idx, unsigned char* __restrict__ keep_valid) {
  extern __shared__ float4 sbox[];  // [slice], then the scores, then the bitmap
  float* sscore = reinterpret_cast<float*>(sbox + slice);
  unsigned* spicked = reinterpret_cast<unsigned*>(sscore + slice);
  __shared__ float red_s[32];
  __shared__ int red_i[32];
  __shared__ Winner inbox[2][kMaxCluster];  // [step & 1][sender's rank]
  __shared__ __align__(8) unsigned long long full[2];  // the inboxes' mbarriers
  __shared__ int s_unpicked;

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lo = rank * slice;
  const int n = max(0, min(slice, K - lo));
  const int nbits = (n + 31) >> 5;
  const float4* bx = boxes + static_cast<size_t>(b) * K + lo;
  const float* sc = scores + static_cast<size_t>(b) * K + lo;
  int* out_idx = keep_idx + static_cast<size_t>(b) * max_det;
  unsigned char* out_valid = keep_valid + static_cast<size_t>(b) * max_det;
  const iou_test::Thres th = iou_test::make_thres(iou_thres);

  if (tid == 0) {
    mbar_init(smem_addr(&full[0]), 1);
    mbar_init(smem_addr(&full[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int w = tid; w < nbits; w += kClusterThreads) spicked[w] = 0u;
  float bs = -INFINITY;
  int bi = INT_MAX;
  for (int i = tid; i < n; i += kClusterThreads) {
    sbox[i] = bx[i];
    const float s = sc[i];
    sscore[i] = s;
    take_better(bs, bi, s, lo + i);
  }
  cluster.sync();  // every block's mbarriers are ready before the first push

  int n_picked = 0;
  for (int t = 0; t < max_det; ++t) {
    const int buf = t & 1;
    // this block's winner, pushed to every block's inbox[buf][rank]
    warp_argmax(bs, bi);
    if (lane == 0) {
      red_s[warp] = bs;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bs = red_s[lane];
      bi = red_i[lane];
      warp_argmax_all(bs, bi);
      if (lane == 0) mbar_expect(smem_addr(&full[buf]), C * kWinnerBytes);
      if (lane < C) {
        const float4 wb = bi >= lo && bi < lo + n ? sbox[bi - lo] : make_float4(0.f, 0.f, 0.f, 0.f);
        push_winner(map_rank(smem_addr(&inbox[buf][rank]), lane),
                    map_rank(smem_addr(&full[buf]), lane), wb, bs, bi);
      }
    }
    // the C winners of step t; the inbox of step t - 1 was read by every
    // thread of every block before any push of step t + 1 could land
    mbar_wait(smem_addr(&full[buf]), (t >> 1) & 1);
    float cs = -INFINITY;
    int ci = INT_MAX;
    if (lane < C) {
      cs = inbox[buf][lane].score;
      ci = inbox[buf][lane].index;
    }
    float bs2 = cs;
    int bi2 = ci;
    warp_argmax_all(bs2, bi2);
    if (!(bs2 > kNegInf * 0.5f)) break;  // no live score left in the image
    const int best = bi2;
    const int from = __ffs(__ballot_sync(kFull, ci == best && lane < C)) - 1;
    const float4 p = inbox[buf][from].box;
    if (tid == 0) {
      if (rank == 0) {
        out_idx[t] = best;
        out_valid[t] = 1;
      }
      if (best >= lo && best < lo + n) spicked[(best - lo) >> 5] |= 1u << ((best - lo) & 31);
    }
    n_picked = t + 1;
    const float parea = iou_test::area(p);
    bs = -INFINITY;
    bi = INT_MAX;
    for (int i = tid; i < n; i += kClusterThreads) {
      float s = sscore[i];
      if (s > kNegInf) {  // a dropped candidate stays dropped: skip its IoU
        const float4 q = sbox[i];
        if (lo + i == best || iou_test::suppresses<true>(p, parea, q, iou_test::area(q), th)) {
          s = kNegInf;
          sscore[i] = s;
        }
      }
      take_better(bs, bi, s, lo + i);
    }
  }
  __syncthreads();  // the picked bitmap is complete

  // slots after the picks: the unpicked indices in ascending order, block
  // by block, then (when K < max_det) index 0, all invalid
  if (warp == 0) {
    int count = 0;
    for (int w = lane; w < nbits; w += 32) {
      const unsigned in_slice = w * 32 + 32 <= n ? kFull : (1u << (n & 31)) - 1u;
      count += __popc(~spicked[w] & in_slice);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) count += __shfl_xor_sync(kFull, count, off);
    if (lane == 0) s_unpicked = count;
  }
  cluster.sync();
  if (warp == 0) {
    int count = n_picked;
    for (int r = 0; r < rank; ++r) count += *cluster.map_shared_rank(&s_unpicked, r);
    for (int base = 0; base < n && count < max_det; base += 32) {
      const int i = base + lane;
      const bool unpicked = i < n && !((spicked[i >> 5] >> (i & 31)) & 1u);
      const unsigned mask = __ballot_sync(kFull, unpicked);
      const int pos = count + __popc(mask & ((1u << lane) - 1u));
      if (unpicked && pos < max_det) {
        out_idx[pos] = lo + i;
        out_valid[pos] = 0;
      }
      count += __popc(mask);
    }
  }
  if (rank == C - 1 && warp == 1)
    for (int p = K + lane; p < max_det; p += 32) {
      out_idx[p] = 0;
      out_valid[p] = 0;
    }
  cluster.sync();  // no block leaves while another may read its s_unpicked
}

size_t cluster_smem(int slice) {
  return static_cast<size_t>(slice) * (sizeof(float4) + sizeof(float)) +
         static_cast<size_t>((slice + 31) / 32) * sizeof(unsigned);
}

cudaLaunchConfig_t cluster_config(int B, int cluster, size_t shmem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cluster);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = shmem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// A refused size leaves no error behind for the next launch's check.
cudaError_t set_cluster_smem(size_t shmem) {
  const cudaError_t err = cudaFuncSetAttribute(nms_greedy_cluster_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(shmem));
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace

// boxes (B, K, 4) f32 xyxy, class offset applied, 16-byte aligned; scores
// (B, K) f32 with dropped candidates at -1e10; keep_idx (B, max_det)
// int32; keep_valid (B, max_det) bool.  K is 1 to 1024; each lane holds
// the next power of two at or above ceil(K / 128) candidate slots.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a K the group kernel cannot hold.
extern "C" int nms_greedy_launch(const float* boxes, const float* scores, int B, int K,
                                 int max_det, float iou_thres, int* keep_idx,
                                 unsigned char* keep_valid, void* stream) {
  const int need = (K + kGroupThreads - 1) / kGroupThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 0 || need > kMaxPerLane) return static_cast<int>(cudaErrorInvalidValue);
  if (need <= 1) return launch_group<1>(boxes, scores, B, K, max_det, iou_thres, keep_idx, keep_valid, s);
  if (need <= 2) return launch_group<2>(boxes, scores, B, K, max_det, iou_thres, keep_idx, keep_valid, s);
  if (need <= 4) return launch_group<4>(boxes, scores, B, K, max_det, iou_thres, keep_idx, keep_valid, s);
  return launch_group<8>(boxes, scores, B, K, max_det, iou_thres, keep_idx, keep_valid, s);
}

// The streaming variant, any K: the arguments of nms_greedy_launch, plus
// `live`, a (B, K) f32 scratch buffer the kernel overwrites.
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

// The cluster variant: the arguments of nms_greedy_launch, with clusters
// of `cluster` (1-8) blocks an image, each block
// holding ceil(K / cluster) candidates in shared memory.  A refused launch returns its
// error; nothing gives way to another kernel.
extern "C" int nms_greedy_cluster_launch(const float* boxes, const float* scores, int B, int K,
                                         int max_det, float iou_thres, int cluster,
                                         int* keep_idx, unsigned char* keep_valid,
                                         void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slice = (K + cluster - 1) / cluster;
  const size_t shmem = cluster_smem(slice);
  cudaError_t err = set_cluster_smem(shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(B, cluster, shmem, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, nms_greedy_cluster_kernel, reinterpret_cast<const float4*>(boxes),
                           scores, K, slice, max_det, iou_thres, keep_idx, keep_valid);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of `cluster` blocks, each with the shared memory of
// ceil(K / cluster) candidates, the card holds at once
// (cudaOccupancyMaxActiveClusters); 0 when none fits.
extern "C" int nms_greedy_cluster_occupancy(int K, int cluster, int* max_clusters) {
  if (cluster < 1 || cluster > kMaxCluster || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t shmem = cluster_smem((K + cluster - 1) / cluster);
  cudaError_t err = set_cluster_smem(shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, cluster, shmem, nullptr, &attr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(max_clusters, nms_greedy_cluster_kernel, &cfg));
}

// The current device's SM count and the shared memory a block may opt
// into, in bytes.
extern "C" int nms_greedy_device_limits(int* n_sm, int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(err);
}
