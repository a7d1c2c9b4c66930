// The NMS suppression test of two xyxy boxes, rounded exactly as the plain
// PyTorch versions and the JAX package round it (`_pairwise_iou`):
//   inter = max(min(x2) - max(x1), 0) * max(min(y2) - max(y1), 0)
//   uni   = (area_a + area_b) - inter + 1e-7
//   divide form:      inter / uni > t   (IEEE-rounded quotient)
//   divide-free form: inter > t * uni
// Sources that include this file build with -fmad=false, so no product
// and sum fuse into one rounding.
#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace iou_test {

// the threshold and the band around it inside which the cheap quotient
// cannot decide the IEEE one
struct Thres {
  float t, lo, hi;
};

__device__ __forceinline__ Thres make_thres(float t) {
  // a normal t away from the range ends; otherwise every quotient divides
  const bool normal = t >= 0x1p-60f && t <= 0x1p60f;
  return {t, normal ? t * (1.0f - 0x1p-18f) : -INFINITY,
          normal ? t * (1.0f + 0x1p-18f) : INFINITY};
}

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// rn(inter / uni) > t, dividing only where a cheap quotient is too close
// to t to tell.  With uni and inter in [2^-60, 2^60], q = inter * rcp(uni)
// (rcp within 1 ulp) is within 2^-21 of the exact quotient Q, relatively;
// q above t (1 + 2^-18) puts Q more than 16 ulps of t above it, so rn(Q)
// > t, and q below t (1 - 2^-18) puts rn(Q) below t.  inter == 0 over a
// positive uni is exactly +0, whatever uni is.
__device__ __forceinline__ bool quotient_above(float inter, float uni, const Thres& th) {
  if (inter == 0.0f && uni > 0.0f) return 0.0f > th.t;
  if (uni >= 0x1p-60f && uni <= 0x1p60f && inter >= 0x1p-60f && inter <= 0x1p60f) {
    const float q = inter * rcp_approx(uni);
    if (q > th.hi) return true;
    if (q < th.lo) return false;
  }
  return __fdiv_rn(inter, uni) > th.t;
}

__device__ __forceinline__ float intersection(float4 a, float4 b) {
  const float iw = fmaxf(fminf(a.z, b.z) - fmaxf(a.x, b.x), 0.0f);
  const float ih = fmaxf(fminf(a.w, b.w) - fmaxf(a.y, b.y), 0.0f);
  return iw * ih;
}

// the test on an intersection of boxes of areas area_a, area_b, a being
// the first operand of `_pairwise_iou` (the kept or higher-ranked box)
template <bool kDivide>
__device__ __forceinline__ bool above(float inter, float area_a, float area_b, const Thres& th) {
  const float uni = area_a + area_b - inter + 1e-7f;
  return kDivide ? quotient_above(inter, uni, th) : inter > th.t * uni;
}

// box a (area area_a) suppresses box b
template <bool kDivide>
__device__ __forceinline__ bool suppresses(float4 a, float area_a, float4 b, float area_b,
                                           const Thres& th) {
  return above<kDivide>(intersection(a, b), area_a, area_b, th);
}

__device__ __forceinline__ float area(float4 a) { return (a.z - a.x) * (a.w - a.y); }

}  // namespace iou_test
