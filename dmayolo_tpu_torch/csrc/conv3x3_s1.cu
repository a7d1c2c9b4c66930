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
// f32 inputs keep a direct convolution on the CUDA cores: TF32 wgmma would
// break the 1e-4 tolerance against the f32 JAX reference, and f32 is the
// test dtype, not the serving one.  A block owns an 8x16 output tile for 64
// output channels; the input is walked in chunks of 8 channels through
// shared memory; ragged edges and channel tails are masked.
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
// f32 inputs: direct convolution on the CUDA cores
// ---------------------------------------------------------------------------

namespace direct {

constexpr int TH = 8;    // output rows per block
constexpr int TW = 16;   // output columns per block
constexpr int CK = 8;    // input channels per shared-memory chunk
constexpr int CO = 64;   // output channels per block
constexpr int NT = 256;  // threads per block: TW columns x CO/4 channel lanes

template <typename TO>
__global__ void __launch_bounds__(NT)
    conv3x3_s1_kernel(const float* __restrict__ x, const float* __restrict__ w,
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
  const float* xb = x + static_cast<size_t>(b) * H * W * C1;

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
        v = xb[(static_cast<size_t>(h) * W + ww) * C1 + ci];
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
        v = w[(static_cast<size_t>(tap) * C1 + ci) * C2 + co];
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

template <typename TO>
void launch(const float* x, const float* w, void* out, int B, int H, int W,
            int C1, int C2, cudaStream_t stream) {
  const int tiles_w = (W + TW - 1) / TW;
  const dim3 grid(((H + TH - 1) / TH) * tiles_w, (C2 + CO - 1) / CO, B);
  conv3x3_s1_kernel<TO><<<grid, NT, 0, stream>>>(
      x, w, static_cast<TO*>(out), H, W, C1, C2, tiles_w);
}

}  // namespace direct

// ---------------------------------------------------------------------------
// bf16 inputs: implicit GEMM, TMA loads, wgmma
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BK = 64;                   // K per stage: 64 channels of one tap, 128 bytes
constexpr int CONSUMERS = 256;           // warpgroups 0-1 multiply
constexpr int THREADS = CONSUMERS + 32;  // warp 8 loads

// Ring depths: haloed tiles (A) and one tap's 64 x BN weight slice each
// (B).  RES: a conv with one 64-channel chunk and one N tile of 64 keeps
// all nine weight slices for good beside one A stage.
template <bool RES>
__host__ __device__ constexpr int a_stages() { return RES ? 1 : 2; }
template <bool RES>
__host__ __device__ constexpr int b_stages() { return RES ? 9 : 4; }

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

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2)
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

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle
// that TMA wrote: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO);
// LBO is unused by this layout, the base offset stays 0.  A k16 slice
// starts 32 bytes further.
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

// D (64 x BN, f32, in registers) += A (64 x 16) * B (16 x BN), both K-major
// bf16 in shared memory; scale-d 1 (accumulate), no negation, no transpose
template <int BN>
struct Mma;

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n"
        "}\n"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
        : "l"(a), "l"(b), "r"(1));
  }
};

#undef ACC8

struct Geometry {
  int H, W, C2;
  int TH, TW;            // the patch: TH x TW outputs, computed TW + 2 wide
  int tiles_h, tiles_w;  // patches per image
  int n_tiles;           // BN-wide slices of C2
  int tiles;             // B * tiles_h * tiles_w * n_tiles
  int chunks;            // ceil(C1p / 64)
  int a_bytes;           // one haloed-tile stage, a multiple of 1024
  int stage_out;         // 1: bf16 tiles leave through shared memory and TMA stores
};

// an A stage: the haloed tile's (TH + 2) * (TW + 2) rows, and what the
// shifted views of a bm-row tile read beyond them: bm + 2*(TW + 2) + 2 rows
__host__ __device__ inline int a_stage_bytes(int tw, int bm) {
  return ((bm + 2 * (tw + 2) + 2 + 7) / 8) * 8 * 128;
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

// BN output channels a tile; MW m64 row blocks a consumer warpgroup (tile
// rows 128 * MW); TO the output type; RES resident weights
template <int BN, int MW, typename TO, bool RES>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_s1_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap wmap,
                            const __grid_constant__ CUtensorMap omap, TO* __restrict__ out,
                            const Geometry g) {
  constexpr int B_BYTES = BN * BK * 2;
  constexpr int AS = a_stages<RES>();
  constexpr int BS = b_stages<RES>();
  constexpr int SUB_BYTES = MW * 128 * 128;  // a 64-channel sub-tile of the staging tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t a_full[AS], a_empty[AS], b_full[BS], b_empty[BS];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align everything to it
  uint8_t* ring_b = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring_a = ring_b + BS * B_BYTES;
  uint8_t* staging = ring_a + AS * g.a_bytes;  // BN / 64 sub-tiles, if stage_out
  const int twp = g.TW + 2;

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
      const uint32_t a_tx = static_cast<uint32_t>((g.TH + 2) * twp * BK * 2);
      int ca = 0, cb = 0;  // haloed tiles and weight slices issued so far
      for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
        const Tile tile(g, t, BN);
        for (int chunk = 0; chunk < g.chunks; ++chunk, ++ca) {
          const int sa = ca % AS;
          mbar_wait(&a_empty[sa], ((ca / AS) & 1) ^ 1);
          mbar_expect_tx(&a_full[sa], a_tx);
          tma_load_4d(ring_a + sa * g.a_bytes, &xmap, &a_full[sa], chunk * BK, tile.w0 - 1,
                      tile.h0 - 1, tile.b);
          if (RES && cb > 0) continue;  // the nine slices are already there
          for (int tap = 0; tap < 9; ++tap, ++cb) {
            const int sb = cb % BS;
            mbar_wait(&b_empty[sb], ((cb / BS) & 1) ^ 1);
            mbar_expect_tx(&b_full[sb], B_BYTES);
            tma_load_3d(ring_b + sb * B_BYTES, &wmap, &b_full[sb], chunk * BK, tap, tile.n0);
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
#pragma unroll
    for (int m = 0; m < MW; ++m)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[m][i] = 0.0f;

    for (int chunk = 0; chunk < g.chunks; ++chunk, ++ca) {
      const int sa = ca % AS;
      mbar_wait(&a_full[sa], (ca / AS) & 1);
      const uint8_t* a = ring_a + sa * g.a_bytes + half * MW * 64 * 128;
      for (int tap = 0; tap < 9; ++tap, ++cb) {
        // RES: slice s holds tap s for good, and is never freed
        const int sb = RES ? tap : cb % BS;
        mbar_wait(&b_full[sb], RES ? 0 : (cb / BS) & 1);
        const uint64_t da = smem_desc(a + ((tap / 3) * twp + tap % 3) * 128);
        const uint64_t db = smem_desc(ring_b + sb * B_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)  // a k16 slice: +32 bytes, +2 in 16-byte units
#pragma unroll
          for (int m = 0; m < MW; ++m)  // the next m64 block: +64 rows, +512 units
            Mma<BN>::run(acc[m], da + m * 512 + 2 * kk, db + 2 * kk);
        wgmma_commit();
        wgmma_wait<1>();  // the previous group is done: free what it read
        if (free_b >= 0) mbar_arrive(&b_empty[free_b]);
        if (free_a >= 0) mbar_arrive(&a_empty[free_a]);
        free_b = RES ? -1 : sb;
        free_a = tap == 8 ? sa : -1;
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

// a 128-byte-swizzled tensor map over a dense bf16 array: dims and box
// innermost first
template <int R>
bool encode(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[R],
            const cuuint32_t (&box)[R], CUtensorMapL2promotion l2) {
  cuuint64_t strides[R - 1];  // in bytes, of dims 1 ... R-1
  cuuint64_t stride = dims[0] * 2;
  for (int i = 0; i < R - 1; ++i) strides[i] = stride, stride *= dims[i + 1];
  cuuint32_t elem[R];
  for (int i = 0; i < R; ++i) elem[i] = 1;
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, R, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, l2,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int MW, typename TO, bool RES = false>
int launch(const void* x, const void* wk, void* out, int B, int C1p, const Geometry& g,
           cudaStream_t stream) {
  if (encode_tiled() == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t c1p = C1p, W = g.W, H = g.H, nb = B, C2 = g.C2;
  const cuuint32_t tw = g.TW, th = g.TH;
  CUtensorMap xmap, wmap, omap = {};
  // x (B, H, W, C1p): the haloed patch, TW + 2 columns by TH + 2 rows
  if (!encode<4>(&xmap, x, {c1p, W, H, nb}, {BK, tw + 2, th + 2, 1},
                 CU_TENSOR_MAP_L2_PROMOTION_L2_128B))
    return ERR_ENCODE_X;
  // wk (C2, 9, C1p): one tap's 64 x BN slice
  if (!encode<3>(&wmap, wk, {c1p, 9, C2}, {BK, 1, BN}, CU_TENSOR_MAP_L2_PROMOTION_L2_128B))
    return ERR_ENCODE_W;
  // out (B, H, W, C2): one 64-channel sub-tile of the staging tile
  if (g.stage_out &&
      !encode<4>(&omap, out, {C2, W, H, nb}, {64, tw, th, 1}, CU_TENSOR_MAP_L2_PROMOTION_NONE))
    return ERR_ENCODE_OUT;
  // the rings, the staging tile and 1024 bytes of alignment slack
  const int smem = b_stages<RES>() * BN * BK * 2 + a_stages<RES>() * g.a_bytes +
                   (g.stage_out ? MW * 128 * BN * 2 : 0) + 1024;
  auto kernel = conv3x3_s1_wgmma_kernel<BN, MW, TO, RES>;
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

// f32 route.  x (B, H, W, C1) and w (3, 3, C1, C2) f32; out (B, H, W, C2)
// f32 or bf16 (out_bf16).  All contiguous.  Returns cudaGetLastError()
// after the launch.
extern "C" int conv3x3_s1_launch(const void* x, const void* w, void* out, int B, int H, int W,
                                 int C1, int C2, int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  if (out_bf16)
    direct::launch<__nv_bfloat16>(xf, wf, out, B, H, W, C1, C2, s);
  else
    direct::launch<float>(xf, wf, out, B, H, W, C1, C2, s);
  return static_cast<int>(cudaGetLastError());
}

// bf16 route.  x (B, H, W, C1p) bf16 and wk (C2, 9, C1p) bf16, K-major,
// C1p a multiple of 8 and both 16-byte aligned; out (B, H, W, C2) f32 or
// bf16.  The patch (th, tw: th * (tw + 2) <= bm), the tile's rows bm (128,
// or 256 at bn 128) and channels bn (64 or 128) and the patch counts come
// from the wrapper's plan.  Returns 0, a cudaError_t, or one of tc::ERR_*
// when a tensor map cannot be made.
extern "C" int conv3x3_s1_wgmma_launch(const void* x, const void* wk, void* out, int B, int H,
                                       int W, int C1p, int C2, int th, int tw, int tiles_h,
                                       int tiles_w, int bm, int bn, int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (C2 + bn - 1) / bn;
  const long long tiles = static_cast<long long>(B) * tiles_h * tiles_w * n_tiles;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (C1p + tc::BK - 1) / tc::BK;
  const bool bf = out_bf16 != 0;
  const bool res = bm == 128 && bn == 64 && chunks == 1 && n_tiles == 1;
  tc::Geometry g;
  g.H = H, g.W = W, g.C2 = C2, g.TH = th, g.TW = tw, g.tiles_h = tiles_h, g.tiles_w = tiles_w;
  g.n_tiles = n_tiles, g.tiles = static_cast<int>(tiles), g.chunks = chunks;
  g.a_bytes = tc::a_stage_bytes(tw, bm);
  g.stage_out = bf && !res && C2 % 8 == 0;  // TMA strides are multiples of 16 bytes
  if (res)
    return bf ? tc::launch<64, 1, __nv_bfloat16, true>(x, wk, out, B, C1p, g, s)
              : tc::launch<64, 1, float, true>(x, wk, out, B, C1p, g, s);
  if (bm == 128 && bn == 64)
    return bf ? tc::launch<64, 1, __nv_bfloat16>(x, wk, out, B, C1p, g, s)
              : tc::launch<64, 1, float>(x, wk, out, B, C1p, g, s);
  if (bm == 128 && bn == 128)
    return bf ? tc::launch<128, 1, __nv_bfloat16>(x, wk, out, B, C1p, g, s)
              : tc::launch<128, 1, float>(x, wk, out, B, C1p, g, s);
  if (bm == 256 && bn == 128)
    return bf ? tc::launch<128, 2, __nv_bfloat16>(x, wk, out, B, C1p, g, s)
              : tc::launch<128, 2, float>(x, wk, out, B, C1p, g, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
