// 3x3, stride-1, pad-1 convolution, NHWC input x HWIO weights, f32 sums.
//
// Replaces the TPU kernel dmayolo_tpu/nn/pallas_conv.py::conv3x3_s1 (body
// _kernel, pallas_call at :102), which DMA'd one haloed spatial tile into
// VMEM and fed the MXU one (rows*TW, 9*C1) x (9*C1, C2) im2col product.
//
// What bounds it on the card: operations at every 3x3 stride-1 shape of the
// flagship but the 64-channel ones (320x320, 160x160, 80x80 x 64), which are
// bound by bytes.  A 3x3 conv does 18*C1 flops per output value against a
// few bytes; at C1 >= 128 that is above the ~295 flops per byte at which
// the bf16 tensor cores, not the 3.35 TB/s of device memory, are the limit.
//
// bf16 inputs (either output dtype): an implicit GEMM on the tensor cores.
//   * GEMM view: M = output pixels, N = C2, K = 9*C1p ordered (tap, c1),
//     C1p = C1 padded to a multiple of 8 by the wrapper (TMA strides are
//     multiples of 16 bytes).  A K-step is one tap's 64 input channels.
//   * A is never materialised, and is loaded once per 64-channel chunk, not
//     once per tap.  A tile is a TH x TW patch of one image computed as TH
//     rows of TW + 2 pixels (two junk columns).  One TMA load, over a 4-D
//     tensor map of x (C1p, W, H, B) with the 128-byte swizzle, brings the
//     haloed patch, (TH + 2) x (TW + 2) pixels from (w0 - 1, h0 - 1), as
//     rows of 128 bytes.  TMA fills coordinates before 0 or past the end
//     with zeros: the conv's zero pad, the ragged edge and the channel tail.
//     Output row r = th*(TW + 2) + tw then reads, for tap (dy, dx), row
//     r + dy*(TW + 2) + dx of that tile: every tap is the same wgmma
//     descriptor moved by a whole number of rows.  (The swizzle follows the
//     shared-memory address bits, so a view that starts mid-pattern needs
//     no base offset; one set to the row phase gives wrong sums.)
//   * B is the weights, reordered by the wrapper to K-major (C2, 9, C1p),
//     through a 3-D tensor map, box (64, 1, BN); C2's tail is zero-filled.
//   * A persistent grid, one block per SM, each walking tiles with N
//     fastest.  Warp 8 is the producer: one thread keeps TMA loads in
//     flight on full/empty mbarriers, two haloed tiles and four weight
//     slices deep, running ahead into the next tile.  Warpgroups 0 and 1
//     each own half of the tile's rows and issue wgmma.mma_async
//     m64nBNk16 (bf16 x bf16 -> f32), one m64 block each (128-row tiles)
//     or two (256-row tiles at BN 128, which halve the weight reads an
//     output), one K-step in flight (wait_group 1) before they free the
//     stages it read.
//   * Epilogue, bf16 out with C2 % 8 == 0: the consumers write the tile
//     into a shared staging tile in the 128-byte swizzle and one thread
//     sends it out with TMA stores, which clip rows past H or W and
//     channels past C2; the consumers go straight on to the next tile's
//     products.  Other outputs are stored from the registers, masked.
//   * C1, C2 <= 64 (one chunk, one N tile of 64): the block keeps all nine
//     weight slices for good, loaded once, beside one haloed-tile stage.
//   * Tile shape and BN (64 for C2 <= 64, else 128) are chosen per shape by
//     the wrapper (nn/conv3x3.py::plan_tc), to cover each image with the
//     fewest tiles.
//   * Tiled TMA (not its im2col mode, not cp.async gathers) because its zero
//     fill gives the pad and the edges for free and keeps the producer to
//     one thread; the costs are the junk columns (2 of TW + 2) and the
//     halo rows.
//
// f32 inputs: the same pipeline on the TF32 tensor cores, as 3xTF32.
//   * Plain TF32 rounds each operand to 11 bits, about 2^-11 a product,
//     which breaks the 1e-4 tolerance against the f32 reference.  So each
//     operand v is split into hi = tf32(v) and lo = tf32(v - hi) (v - hi
//     is exact in f32; tf32() rounds to nearest, ties away from zero, and
//     clears the low 13 bits, as `cvt.rna.tf32.f32` does), and the sum
//     takes hi*hi + hi*lo + lo*hi, in f32, with `wgmma.mma_async
//     m64nBNk8 .tf32`; only lo*lo, about 2^-22 relatively, is dropped.
//   * tf32 wgmma reads both operands K-major from shared memory: a
//     128-byte swizzled row holds 32 channels, so a K-step is one tap's
//     32 channels, and the haloed patch, the row shifts and the
//     descriptors are those of the bf16 route with BK = 32.
//   * The weights are split on the host, once a call, into two K-major
//     (C2, 9, C1p) tensors stacked as (2, C2, 9, C1p), C1p = C1 padded to
//     a multiple of 4 (16-byte TMA strides); each tap's slice arrives as
//     a hi and a lo tile on one mbarrier.
//   * The activations are split in the kernel: when a haloed patch lands,
//     the 256 consumer threads rewrite it in place as hi and write lo into
//     a second buffer of the stage at the same offset, so the swizzle and
//     the row-shift descriptors hold for both; then a proxy fence and one
//     consumer barrier, once a 32-channel chunk (nine taps, 108 wgmma).
//   * 128-row tiles only (shared memory: two A stages and three or four
//     weight stages, each doubled by its lo part), and outputs stored from
//     the registers, masked.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// implicit GEMM, TMA loads, wgmma: bf16, or f32 as 3xTF32
// ---------------------------------------------------------------------------

namespace tc {

constexpr int ROW = 128;                 // bytes of a K-step's row: one tap's BK channels
constexpr int CONSUMERS = 256;           // warpgroups 0-1 multiply
constexpr int THREADS = CONSUMERS + 32;  // warp 8 loads

// What the input type sets: BK, the channels of a K-step (one 128-byte
// row), and PARTS, the operand parts (bf16: one; f32: the TF32 hi and lo).
template <typename TI>
struct In {
  static constexpr bool F32 = sizeof(TI) == 4;
  static constexpr int BK = ROW / static_cast<int>(sizeof(TI));
  static constexpr int PARTS = F32 ? 2 : 1;
};

// Ring depths: haloed tiles (A) and one tap's BK x BN weight slice each
// (B), each stage holding every part.  RES: a bf16 conv with one 64-channel
// chunk and one N tile of 64 keeps all nine weight slices for good beside
// one A stage.  f32 at BN 128 keeps three B stages to fit 227 KB.
template <bool RES>
__host__ __device__ constexpr int a_stages() { return RES ? 1 : 2; }
template <typename TI, int BN, bool RES>
__host__ __device__ constexpr int b_stages() {
  return RES ? 9 : (In<TI>::F32 && BN == 128 ? 3 : 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
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
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) break;
    if (clock64() - start > 20000000000ll) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3)
      : "memory");
}

__device__ __forceinline__ void consumers_sync() {  // the 256 consumer threads only
  asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMERS) : "memory");
}

// f32 to TF32: round to nearest, ties away from zero, low 13 bits cleared
// (what `cvt.rna.tf32.f32` rounds to; nn/conv3x3.py::split_tf32 on the host)
__device__ __forceinline__ uint32_t tf32_bits(uint32_t u) { return (u + 0x1000u) & 0xffffe000u; }

__device__ __forceinline__ uint32_t split_lo(uint32_t v, uint32_t hi) {
  return tf32_bits(__float_as_uint(__uint_as_float(v) - __uint_as_float(hi)));
}

// The f32 patch at `hi`, n16 16-byte chunks, rewritten in place as its
// TF32 hi part, its lo part written at the same offsets of `lo`; the
// split is elementwise, so both keep TMA's swizzle.
__device__ __forceinline__ void split_tf32(uint8_t* hi, uint8_t* lo, int n16) {
  for (int e = threadIdx.x; e < n16; e += CONSUMERS) {
    const uint4 v = reinterpret_cast<const uint4*>(hi)[e];
    const uint4 h = make_uint4(tf32_bits(v.x), tf32_bits(v.y), tf32_bits(v.z), tf32_bits(v.w));
    reinterpret_cast<uint4*>(hi)[e] = h;
    reinterpret_cast<uint4*>(lo)[e] =
        make_uint4(split_lo(v.x, h.x), split_lo(v.y, h.y), split_lo(v.z, h.z), split_lo(v.w, h.w));
  }
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle
// that TMA wrote: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO);
// LBO is unused by this layout, the base offset stays 0.  A k16 slice
// (bf16) or k8 slice (tf32) starts 32 bytes further.
__device__ __forceinline__ uint64_t smem_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

#define ACC8(i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),          \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define REGS32                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "            \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
#define REGS64                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "            \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "   \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "   \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "

// D (64 x BN, f32, in registers) = A (64 x k) * B (k x BN) + (accumulate ?
// D : 0), both K-major in shared memory: bf16 k16, or (TF32) tf32 k8; no
// negation, no transpose
template <int BN>
struct Mma;

template <>
struct Mma<64> {
  template <bool TF32>
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate = 1) {
    if constexpr (TF32) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " REGS32 "%32, %33, p, 1, 1;\n}\n"
          : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
          : "l"(a), "l"(b), "r"(accumulate));
    } else {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
          "%32, %33, p, 1, 1, 0, 0;\n}\n"
          : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
          : "l"(a), "l"(b), "r"(accumulate));
    }
  }
};

template <>
struct Mma<128> {
  template <bool TF32>
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b,
                                             int accumulate = 1) {
    if constexpr (TF32) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " REGS64 "%64, %65, p, 1, 1;\n}\n"
          : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
          : "l"(a), "l"(b), "r"(accumulate));
    } else {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
          "%64, %65, p, 1, 1, 0, 0;\n}\n"
          : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
          : "l"(a), "l"(b), "r"(accumulate));
    }
  }
};

#undef ACC8
#undef REGS32
#undef REGS64

struct Geometry {
  int H, W, C2;
  int TH, TW;            // the patch: TH x TW outputs, computed TW + 2 wide
  int tiles_h, tiles_w;  // patches per image
  int n_tiles;           // BN-wide slices of C2
  int tiles;             // B * tiles_h * tiles_w * n_tiles
  int chunks;            // ceil(C1p / BK)
  int a_bytes;           // one part of a haloed-tile stage, a multiple of 1024
  int stage_out;         // 1: bf16 tiles leave through shared memory and TMA stores
};

// an A stage's part: the haloed tile's (TH + 2) * (TW + 2) rows, and what
// the shifted views of a bm-row tile read beyond them: bm + 2*(TW + 2) + 2
// rows
__host__ __device__ inline int a_stage_bytes(int tw, int bm) {
  return ((bm + 2 * (tw + 2) + 2 + 7) / 8) * 8 * ROW;
}

// one tile's place: n fastest, so the C2 slices of one patch run together
// and share its input in L2
struct Tile {
  int b, h0, w0, n0;
  __device__ Tile(const Geometry& g, int t, int bn) {
    n0 = (t % g.n_tiles) * bn;
    t /= g.n_tiles;
    w0 = (t % g.tiles_w) * g.TW;
    t /= g.tiles_w;
    h0 = (t % g.tiles_h) * g.TH;
    b = t / g.tiles_h;
  }
};

// Direct epilogue: one accumulator row (row half hr of the m64 fragment)
// into o[0, BN), channels at or past `cols` dropped.  A quad's four lanes
// hold the row's channels 8j + 2q, 8j + 2q + 1 for every 8-channel block j;
// `pairs` (C2 even) writes them two at a time.
template <int BN, typename TO>
__device__ __forceinline__ void store_row(const float (&acc)[BN / 2], int hr, TO* o, int cols,
                                          bool pairs) {
  const int q = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * q;
    const float v0 = acc[4 * j + 2 * hr], v1 = acc[4 * j + 2 * hr + 1];
    if (pairs && c + 1 < cols) {
      if constexpr (sizeof(TO) == 4) {
        *reinterpret_cast<float2*>(o + c) = make_float2(v0, v1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(o + c) = __floats2bfloat162_rn(v0, v1);
      }
    } else {
      if (c < cols) o[c] = from_f32<TO>(v0);
      if (c + 1 < cols) o[c + 1] = from_f32<TO>(v1);
    }
  }
}

// Staged epilogue (bf16 out): the same row into the staging tile, BN/64
// sub-tiles of [pixel][64 channels] in the 128-byte swizzle that the TMA
// store reads (16-byte chunk k of pixel p at chunk k ^ (p % 8)), so the 8
// rows a warp writes at once fall in different banks.
template <int BN>
__device__ __forceinline__ void stage_row(const float (&acc)[BN / 2], int hr, uint8_t* staging,
                                          int sub_bytes, int p) {
  const int q = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    uint8_t* dst = staging + (j / 8) * sub_bytes + p * 128 + (((j % 8) ^ (p & 7)) * 16) + 4 * q;
    *reinterpret_cast<__nv_bfloat162*>(dst) =
        __floats2bfloat162_rn(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
  }
}

// TI the input type (bf16, or f32 as 3xTF32); BN output channels a tile;
// MW m64 row blocks a consumer warpgroup (tile rows 128 * MW); TO the
// output type; RES resident weights
template <typename TI, int BN, int MW, typename TO, bool RES>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_s1_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap wmap,
                            const __grid_constant__ CUtensorMap omap, TO* __restrict__ out,
                            const Geometry g) {
  constexpr bool F32 = In<TI>::F32;
  constexpr int BK = In<TI>::BK;
  constexpr int PARTS = In<TI>::PARTS;
  constexpr int B_BYTES = BN * ROW;  // one part of a weight slice
  constexpr int AS = a_stages<RES>();
  constexpr int BS = b_stages<TI, BN, RES>();
  constexpr int SUB_BYTES = MW * 128 * 128;  // a 64-channel sub-tile of the staging tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t a_full[AS], a_empty[AS], b_full[BS], b_empty[BS];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align everything to it
  uint8_t* ring_b = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring_a = ring_b + BS * PARTS * B_BYTES;
  uint8_t* staging = ring_a + AS * PARTS * g.a_bytes;  // BN / 64 sub-tiles, if stage_out
  const int twp = g.TW + 2;
  const int a_tx = (g.TH + 2) * twp * ROW;  // the bytes a haloed tile's TMA load brings

  if (threadIdx.x == 0) {
    for (int s = 0; s < AS; ++s) {
      mbar_init(&a_full[s], 1);
      mbar_init(&a_empty[s], CONSUMERS);  // every consumer thread frees a stage
    }
    for (int s = 0; s < BS; ++s) {
      mbar_init(&b_full[s], 1);
      mbar_init(&b_empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: one thread issues every load, running ahead across tiles
    if (threadIdx.x == CONSUMERS) {
      int ca = 0, cb = 0;  // haloed tiles and weight slices issued so far
      for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
        const Tile tile(g, t, BN);
        for (int chunk = 0; chunk < g.chunks; ++chunk, ++ca) {
          const int sa = ca % AS;
          mbar_wait(&a_empty[sa], ((ca / AS) & 1) ^ 1);
          mbar_expect_tx(&a_full[sa], a_tx);
          tma_load_4d(ring_a + sa * PARTS * g.a_bytes, &xmap, &a_full[sa], chunk * BK,
                      tile.w0 - 1, tile.h0 - 1, tile.b);
          if (RES && cb > 0) continue;  // the nine slices are already there
          for (int tap = 0; tap < 9; ++tap, ++cb) {
            const int sb = cb % BS;
            mbar_wait(&b_empty[sb], ((cb / BS) & 1) ^ 1);
            mbar_expect_tx(&b_full[sb], PARTS * B_BYTES);
            for (int part = 0; part < PARTS; ++part)  // (f32: the hi, then the lo weights)
              tma_load_4d(ring_b + (sb * PARTS + part) * B_BYTES, &wmap, &b_full[sb], chunk * BK,
                          tap, tile.n0, part);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup `half` owns the tile's m64 row blocks
  // half*MW ... half*MW + MW - 1
  const int half = threadIdx.x / 128;
  const int t128 = threadIdx.x % 128;
  int ca = 0, cb = 0;
  int free_a = -1, free_b = -1;  // stages read by the wgmma group still in flight
  for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    const Tile tile(g, t, BN);
    float acc[MW][BN / 2];
    // f32: the tensor cores' sum of one chunk, added into acc after it
    // (the cores' accumulation truncates: its error grows with the terms
    // it adds, where acc rounds to nearest once a chunk)
    float part[MW][F32 ? BN / 2 : 1];
#pragma unroll
    for (int m = 0; m < MW; ++m)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        acc[m][i] = 0.0f;
        if constexpr (F32) part[m][i] = 0.0f;
      }

    for (int chunk = 0; chunk < g.chunks; ++chunk, ++ca) {
      const int sa = ca % AS;
      mbar_wait(&a_full[sa], (ca / AS) & 1);
      uint8_t* a_stage = ring_a + sa * PARTS * g.a_bytes;
      if constexpr (F32) {
        // hi in place, lo into the stage's second part; the generic-proxy
        // writes made visible to wgmma's async proxy, then to both warpgroups
        split_tf32(a_stage, a_stage + g.a_bytes, a_tx / 16);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        consumers_sync();
      }
      const uint8_t* a = a_stage + half * MW * 64 * ROW;
      for (int tap = 0; tap < 9; ++tap, ++cb) {
        // RES: slice s holds tap s for good, and is never freed
        const int sb = RES ? tap : cb % BS;
        mbar_wait(&b_full[sb], RES ? 0 : (cb / BS) & 1);
        const uint64_t da = smem_desc(a + ((tap / 3) * twp + tap % 3) * ROW);
        const uint64_t db = smem_desc(ring_b + sb * PARTS * B_BYTES);
        wgmma_fence();
        // a K slice: +32 bytes, +2 in 16-byte units; the next m64 block:
        // +64 rows, +512 units; a lo part: +a_bytes or +B_BYTES
#pragma unroll
        for (int kk = 0; kk < BK / (F32 ? 8 : 16); ++kk)
#pragma unroll
          for (int m = 0; m < MW; ++m) {
            const uint64_t am = da + m * 512 + 2 * kk, bk = db + 2 * kk;
            if constexpr (F32) {  // the chunk's first product overwrites part
              Mma<BN>::template run<true>(part[m], am, bk + (B_BYTES >> 4),
                                          tap > 0 || kk > 0);                 // hi * lo
              Mma<BN>::template run<true>(part[m], am + (g.a_bytes >> 4), bk);  // lo * hi
              Mma<BN>::template run<true>(part[m], am, bk);                   // hi * hi
            } else {
              Mma<BN>::template run<false>(acc[m], am, bk);
            }
          }
        wgmma_commit();
        wgmma_wait<1>();  // the previous group is done: free what it read
        if (free_b >= 0) mbar_arrive(&b_empty[free_b]);
        if (free_a >= 0) mbar_arrive(&a_empty[free_a]);
        free_b = RES ? -1 : sb;
        free_a = tap == 8 ? sa : -1;
      }
      if constexpr (F32) {
        wgmma_wait<0>();
        if (free_b >= 0) mbar_arrive(&b_empty[free_b]);
        if (free_a >= 0) mbar_arrive(&a_empty[free_a]);
        free_a = free_b = -1;
#pragma unroll
        for (int m = 0; m < MW; ++m)
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc[m][i] += part[m][i];
      }
    }
    wgmma_wait<0>();
    if (free_b >= 0) mbar_arrive(&b_empty[free_b]);
    if (free_a >= 0) mbar_arrive(&a_empty[free_a]);
    free_a = free_b = -1;

    // ---- epilogue: fragment row r is patch pixel (r / (TW + 2), r % (TW + 2));
    // junk columns dropped.  The producer meanwhile loads the next tile.
    if constexpr (sizeof(TO) == 2) {
      if (g.stage_out) {
        // the previous tile's TMA stores have read the staging tile
        if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        consumers_sync();
#pragma unroll
        for (int mr = 0; mr < 2 * MW; ++mr) {
          const int r = (half * MW + mr / 2) * 64 + (t128 / 32) * 16 + (t128 % 32) / 4 + 8 * (mr % 2);
          if (r < g.TH * twp && r % twp < g.TW)
            stage_row<BN>(acc[mr / 2], mr % 2, staging, SUB_BYTES, (r / twp) * g.TW + r % twp);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        consumers_sync();
        if (threadIdx.x == 0) {  // TMA clips rows past H or W and channels past C2
          for (int sub = 0; sub < BN / 64; ++sub)
            tma_store_4d(&omap, staging + sub * SUB_BYTES, tile.n0 + 64 * sub, tile.w0, tile.h0,
                         tile.b);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
        continue;
      }
    }
#pragma unroll
    for (int mr = 0; mr < 2 * MW; ++mr) {
      const int r = (half * MW + mr / 2) * 64 + (t128 / 32) * 16 + (t128 % 32) / 4 + 8 * (mr % 2);
      const int tw = r % twp;
      const int h = tile.h0 + r / twp, w = tile.w0 + tw;
      if (r >= g.TH * twp || tw >= g.TW || h >= g.H || w >= g.W) continue;
      TO* o = out + ((static_cast<size_t>(tile.b) * g.H + h) * g.W + w) * g.C2 + tile.n0;
      store_row<BN>(acc[mr / 2], mr % 2, o, g.C2 - tile.n0, g.C2 % 2 == 0);
    }
  }
  // the block's shared memory must outlive its last TMA store
  if (threadIdx.x == 0 && g.stage_out) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// error codes beyond cudaError_t's range, so the wrapper can tell them apart
constexpr int ERR_NO_ENCODER = 10001;
constexpr int ERR_ENCODE_X = 10002;
constexpr int ERR_ENCODE_W = 10003;
constexpr int ERR_ENCODE_OUT = 10004;

// a 128-byte-swizzled tensor map over a dense array of T (bf16 or f32):
// dims and box innermost first
template <typename T, int R>
bool encode(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[R],
            const cuuint32_t (&box)[R], CUtensorMapL2promotion l2) {
  cuuint64_t strides[R - 1];  // in bytes, of dims 1 ... R-1
  cuuint64_t stride = dims[0] * sizeof(T);
  for (int i = 0; i < R - 1; ++i) strides[i] = stride, stride *= dims[i + 1];
  cuuint32_t elem[R];
  for (int i = 0; i < R; ++i) elem[i] = 1;
  const CUtensorMapDataType type =
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode_tiled()(map, type, R, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, l2,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TI, int BN, int MW, typename TO, bool RES = false>
int launch(const void* x, const void* wk, void* out, int B, int C1p, const Geometry& g,
           cudaStream_t stream) {
  constexpr int BK = In<TI>::BK;
  constexpr int PARTS = In<TI>::PARTS;
  if (encode_tiled() == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t c1p = C1p, W = g.W, H = g.H, nb = B, C2 = g.C2;
  const cuuint32_t tw = g.TW, th = g.TH;
  CUtensorMap xmap, wmap, omap = {};
  // x (B, H, W, C1p): the haloed patch, TW + 2 columns by TH + 2 rows
  if (!encode<TI, 4>(&xmap, x, {c1p, W, H, nb}, {BK, tw + 2, th + 2, 1},
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B))
    return ERR_ENCODE_X;
  // wk (PARTS, C2, 9, C1p): one tap's BK x BN slice of one part
  if (!encode<TI, 4>(&wmap, wk, {c1p, 9, C2, PARTS}, {BK, 1, BN, 1},
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B))
    return ERR_ENCODE_W;
  // out (B, H, W, C2) bf16: one 64-channel sub-tile of the staging tile
  if (g.stage_out && !encode<__nv_bfloat16, 4>(&omap, out, {C2, W, H, nb}, {64, tw, th, 1},
                                               CU_TENSOR_MAP_L2_PROMOTION_NONE))
    return ERR_ENCODE_OUT;
  // the rings, the staging tile and 1024 bytes of alignment slack
  const int smem = b_stages<TI, BN, RES>() * PARTS * BN * ROW +
                   a_stages<RES>() * PARTS * g.a_bytes + (g.stage_out ? MW * 128 * BN * 2 : 0) +
                   1024;
  auto kernel = conv3x3_s1_wgmma_kernel<TI, BN, MW, TO, RES>;
  static int allowed = 0;  // one per template instance: raise its limit as needed
  cudaError_t e = cudaSuccess;
  if (smem > allowed) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = smem;
  }
  // persistent: as many blocks as fit on the card at once, each walking
  // tiles blockIdx.x, + gridDim.x, ...; the card's room for them is asked
  // once per device and shared-memory size
  static int seen_dev = -1, seen_smem = -1, room = 0;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if (dev != seen_dev || smem != seen_smem) {
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
            cudaSuccess)
      return static_cast<int>(e);
    seen_dev = dev, seen_smem = smem, room = sms * per_sm;
  }
  const int blocks = g.tiles < room ? g.tiles : room;
  kernel<<<blocks, THREADS, smem, stream>>>(xmap, wmap, omap, static_cast<TO*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// x (B, H, W, C1p) and wk (PARTS, C2, 9, C1p), K-major, both 16-byte
// aligned, in the input type: bf16 (in_f32 0; PARTS 1; C1p a multiple of
// 8), or f32 (in_f32 1; PARTS 2, the weights' TF32 hi and lo parts; C1p a
// multiple of 4, bm 128); out (B, H, W, C2) f32 or bf16.  The patch (th,
// tw: th * (tw + 2) <= bm), the tile's rows bm (128, or 256 at bn 128) and
// channels bn (64 or 128) and the patch counts come from the wrapper's
// plan.  Returns 0, a cudaError_t, or one of tc::ERR_* when a tensor map
// cannot be made.
extern "C" int conv3x3_s1_wgmma_launch(const void* x, const void* wk, void* out, int B, int H,
                                       int W, int C1p, int C2, int th, int tw, int tiles_h,
                                       int tiles_w, int bm, int bn, int in_f32, int out_bf16,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (C2 + bn - 1) / bn;
  const long long tiles = static_cast<long long>(B) * tiles_h * tiles_w * n_tiles;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int bk = in_f32 ? tc::In<float>::BK : tc::In<__nv_bfloat16>::BK;
  const int chunks = (C1p + bk - 1) / bk;
  const bool bf = out_bf16 != 0;
  const bool res = !in_f32 && bm == 128 && bn == 64 && chunks == 1 && n_tiles == 1;
  tc::Geometry g;
  g.H = H, g.W = W, g.C2 = C2, g.TH = th, g.TW = tw, g.tiles_h = tiles_h, g.tiles_w = tiles_w;
  g.n_tiles = n_tiles, g.tiles = static_cast<int>(tiles), g.chunks = chunks;
  g.a_bytes = tc::a_stage_bytes(tw, bm);
  // TMA strides are multiples of 16 bytes; the f32 route has no room for
  // the staging tile
  g.stage_out = bf && !in_f32 && !res && C2 % 8 == 0;
  using bf16 = __nv_bfloat16;
  if (in_f32) {
    if (bm == 128 && bn == 64)
      return bf ? tc::launch<float, 64, 1, bf16>(x, wk, out, B, C1p, g, s)
                : tc::launch<float, 64, 1, float>(x, wk, out, B, C1p, g, s);
    if (bm == 128 && bn == 128)
      return bf ? tc::launch<float, 128, 1, bf16>(x, wk, out, B, C1p, g, s)
                : tc::launch<float, 128, 1, float>(x, wk, out, B, C1p, g, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (res)
    return bf ? tc::launch<bf16, 64, 1, bf16, true>(x, wk, out, B, C1p, g, s)
              : tc::launch<bf16, 64, 1, float, true>(x, wk, out, B, C1p, g, s);
  if (bm == 128 && bn == 64)
    return bf ? tc::launch<bf16, 64, 1, bf16>(x, wk, out, B, C1p, g, s)
              : tc::launch<bf16, 64, 1, float>(x, wk, out, B, C1p, g, s);
  if (bm == 128 && bn == 128)
    return bf ? tc::launch<bf16, 128, 1, bf16>(x, wk, out, B, C1p, g, s)
              : tc::launch<bf16, 128, 1, float>(x, wk, out, B, C1p, g, s);
  if (bm == 256 && bn == 128)
    return bf ? tc::launch<bf16, 128, 2, bf16>(x, wk, out, B, C1p, g, s)
              : tc::launch<bf16, 128, 2, float>(x, wk, out, B, C1p, g, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
