// nvjpeg_codec: JPEG decode and encode through the CUDA toolkit's nvJPEG,
// for machines whose system has no libjpeg.  Called through ctypes from
// dmayolo_tpu_torch/data/imageio.py (ctypes releases the GIL around every
// call) and built with g++ at first use by utils/cuda_build.py, only where
// <nvjpeg.h> exists.  Host-API code: no kernel of this repository is here;
// nvJPEG runs its own on the card.
//
// One nvjpegHandle_t for the process (nvJPEG lets threads share it).  A
// call takes a codec context of its own from a pool, and returns it when
// it ends: a decoder state, encoder state and parameters, a CUDA stream
// (non-blocking: it does not wait on the legacy default stream the
// training loop uses) and device and pinned buffers, which only grow.  So
// concurrent calls never share a state, and the pool holds as many
// contexts as calls ever ran at once (the loader's threads, the REST
// server's request threads).  Contexts live as long as the process: a
// thread that ends frees nothing, since freeing device memory would
// synchronise the whole device.  A call synchronises its own stream only,
// so the loader's threads do not stall each other or the training loop.
//
// Decode: the whole file to interleaved BGR (NVJPEG_OUTPUT_BGRI; a
// one-component file to Y, replicated here) in the context's device
// buffer, copied to its pinned buffer, then into the caller's (H, W, 3)
// array.
// Encode: BGR in, nvjpegEncodeImage at the caller's quality with 4:2:0
// chroma (what libjpeg's and cv2's defaults write) and standard Huffman
// tables.
//
// Every function returns 0 or an error: an nvjpegStatus_t (1-99), or
// kCudaBase plus a cudaError_t, or one of the codes below.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

constexpr int kCudaBase = 1000;
constexpr int kShapeMismatch = 2001;  // the header's size is not the caller's
constexpr int kTooSmall = 2002;       // the encoded stream exceeds the caller's buffer

nvjpegHandle_t g_handle = nullptr;
std::once_flag g_once;
int g_init = 0;

void create_handle() {
  const nvjpegStatus_t s = nvjpegCreateSimple(&g_handle);
  g_init = s == NVJPEG_STATUS_SUCCESS ? 0 : static_cast<int>(s);
}

inline int cuda_rc(cudaError_t e) { return e == cudaSuccess ? 0 : kCudaBase + static_cast<int>(e); }

struct Codec {
  cudaStream_t stream = nullptr;
  nvjpegJpegState_t dec = nullptr;
  nvjpegEncoderState_t enc = nullptr;
  nvjpegEncoderParams_t params = nullptr;
  unsigned char* dev = nullptr;
  size_t dev_bytes = 0;
  unsigned char* host = nullptr;
  size_t host_bytes = 0;

  int init() {
    std::call_once(g_once, create_handle);
    if (g_init) return g_init;
    if (!stream) {
      const int rc = cuda_rc(cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking));
      if (rc) return rc;
    }
    return 0;
  }

  int init_decoder() {
    int rc = init();
    if (rc == 0 && !dec) rc = nvjpegJpegStateCreate(g_handle, &dec);
    return rc;
  }

  int init_encoder() {
    int rc = init();
    if (rc == 0 && !enc) rc = nvjpegEncoderStateCreate(g_handle, &enc, stream);
    if (rc == 0 && !params) rc = nvjpegEncoderParamsCreate(g_handle, &params, stream);
    return rc;
  }

  // Grow the device and pinned buffers to at least `bytes` each.
  int reserve(size_t bytes) {
    if (bytes > dev_bytes) {
      if (dev) cudaFree(dev);
      dev = nullptr;
      dev_bytes = 0;
      const int rc = cuda_rc(cudaMalloc(&dev, bytes));
      if (rc) return rc;
      dev_bytes = bytes;
    }
    if (bytes > host_bytes) {
      if (host) cudaFreeHost(host);
      host = nullptr;
      host_bytes = 0;
      const int rc = cuda_rc(cudaMallocHost(&host, bytes));
      if (rc) return rc;
      host_bytes = bytes;
    }
    return 0;
  }
};

std::mutex g_pool_mutex;
std::vector<Codec*> g_pool;  // the free contexts

// A context for one call: taken from the pool (or made), given back at
// the end of the scope.
struct Lease {
  Codec* c;
  Lease() {
    std::lock_guard<std::mutex> lock(g_pool_mutex);
    if (g_pool.empty()) {
      c = new Codec();
    } else {
      c = g_pool.back();
      g_pool.pop_back();
    }
  }
  ~Lease() {
    std::lock_guard<std::mutex> lock(g_pool_mutex);
    g_pool.push_back(c);
  }
  Codec* operator->() { return c; }
};

}  // namespace

extern "C" {

// 0 when the handle is made (and a context's stream); else the error.
int nvj_init() {
  Lease c;
  return c->init();
}

// Decode `len` bytes of JPEG to BGR uint8 into out (h * w * 3 bytes; h and
// w from the caller's header parse, checked against nvJPEG's).
int nvj_decode(const uint8_t* buf, unsigned long len, uint8_t* out, int h, int w) {
  Lease lease;
  Codec& c = *lease.c;
  int rc = c.init_decoder();
  if (rc) return rc;
  int ncomp = 0;
  nvjpegChromaSubsampling_t css;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  rc = nvjpegGetImageInfo(g_handle, buf, len, &ncomp, &css, widths, heights);
  if (rc) return rc;
  if (widths[0] != w || heights[0] != h) return kShapeMismatch;
  const bool gray = ncomp == 1;
  const size_t pitch = static_cast<size_t>(w) * (gray ? 1 : 3);
  const size_t bytes = pitch * h;
  rc = c.reserve(bytes);
  if (rc) return rc;
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  img.channel[0] = c.dev;
  img.pitch[0] = pitch;
  rc = nvjpegDecode(g_handle, c.dec, buf, len, gray ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_BGRI, &img,
                    c.stream);
  if (rc) return rc;
  rc = cuda_rc(cudaMemcpyAsync(c.host, c.dev, bytes, cudaMemcpyDeviceToHost, c.stream));
  if (rc) return rc;
  rc = cuda_rc(cudaStreamSynchronize(c.stream));
  if (rc) return rc;
  if (!gray) {
    std::memcpy(out, c.host, bytes);
  } else {
    const size_t n = static_cast<size_t>(h) * w;
    for (size_t i = 0; i < n; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = c.host[i];
  }
  return 0;
}

// Encode BGR uint8 (h, w, 3) at `quality`, 4:2:0.  On success writes the
// stream into out and its size into *length; when the stream is larger
// than cap, writes nothing, sets *length to its size and returns kTooSmall.
int nvj_encode(const uint8_t* bgr, int h, int w, int quality, uint8_t* out, long cap,
               long* length) {
  Lease lease;
  Codec& c = *lease.c;
  int rc = c.init_encoder();
  if (rc) return rc;
  rc = nvjpegEncoderParamsSetQuality(c.params, quality, c.stream);
  if (rc == 0) rc = nvjpegEncoderParamsSetSamplingFactors(c.params, NVJPEG_CSS_420, c.stream);
  if (rc == 0) rc = nvjpegEncoderParamsSetOptimizedHuffman(c.params, 0, c.stream);
  if (rc) return rc;
  const size_t bytes = static_cast<size_t>(h) * w * 3;
  rc = c.reserve(bytes);
  if (rc) return rc;
  std::memcpy(c.host, bgr, bytes);
  rc = cuda_rc(cudaMemcpyAsync(c.dev, c.host, bytes, cudaMemcpyHostToDevice, c.stream));
  if (rc) return rc;
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  img.channel[0] = c.dev;
  img.pitch[0] = static_cast<size_t>(w) * 3;
  rc = nvjpegEncodeImage(g_handle, c.enc, c.params, &img, NVJPEG_INPUT_BGRI, w, h, c.stream);
  if (rc) return rc;
  size_t n = 0;
  rc = nvjpegEncodeRetrieveBitstream(g_handle, c.enc, nullptr, &n, c.stream);
  if (rc == 0) rc = cuda_rc(cudaStreamSynchronize(c.stream));
  if (rc) return rc;
  *length = static_cast<long>(n);
  if (static_cast<long>(n) > cap) return kTooSmall;
  rc = nvjpegEncodeRetrieveBitstream(g_handle, c.enc, out, &n, c.stream);
  if (rc == 0) rc = cuda_rc(cudaStreamSynchronize(c.stream));
  *length = static_cast<long>(n);
  return rc;
}

}  // extern "C"
