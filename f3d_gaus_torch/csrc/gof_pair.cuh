// The per-(pixel, Gaussian) arithmetic of GOF compositing, shared by every
// kernel of csrc/: the decision pass (gof_decide.cu), the compositing
// forward (raster_fwd.cu) and its backward (raster_bwd.cu).  One copy, so
// the three cannot drift apart: the backward finds exactly the forward's
// contributors because both run this code.
//
// Every sum of products below is written with explicit rounding
// intrinsics (__fmaf_rn, __fmul_rn, __fadd_rn): nvcc may contract a * b + c
// into an FMA differently in two inlining contexts, and a decision
// recomputed in another kernel could then differ by an ulp at
// alpha = 1/255.  The FMA pattern is the one nvcc chose for the plain
// expressions in the one-CTA-per-tile forward that preceded these kernels
// (read off its SASS), so the compositing forward keeps that kernel's
// bits.  The expressions are
//   AA  = (q0 U + q1 V + q3) U + (q2 V + q4) V + q5   (and num alike)
//   BB  = 2 (b0 U + b1 V + b2)
//   t   = -BB / (2 AA_safe),  mv = max(num, 0) / AA_safe
//   G   = exp(min(-mv / 2, 0)),  alpha = min(opa G, 0.99)
//   n   = (M^T M) d from the AA rows, m = (f t - f n) / ((f - n) t)
// with IEEE division and square root (no __fdividef, no -use_fast_math).

#pragma once

#include <cuda_runtime.h>

namespace gof {

constexpr int kBlock = 16;
constexpr int kPix = kBlock * kBlock;   // pixels per tile
constexpr int kNFeat = 19;
constexpr int kRowQA = 0;
constexpr int kRowQK = 6;
constexpr int kRowB = 12;
constexpr int kRowRGB = 15;
constexpr int kRowOpa = 18;

constexpr float kNear = 0.2f;
constexpr float kFar = 100.0f;
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kStopT = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;

// The ray d = (U, V, 1) of pixel `pix` of tile (tx, ty), ty the global tile
// row (a band's own row plus its row_off), half_w and half_h the full
// frame's.
__device__ __forceinline__ void pixel_ray(int tx, int ty, int pix,
                                          float half_w, float half_h,
                                          float focal_x, float focal_y,
                                          float& U, float& V) {
  const float px = (float)(tx * kBlock + pix % kBlock) + 0.5f;
  const float py = (float)(ty * kBlock + pix / kBlock) + 0.5f;
  U = __fdiv_rn(px - half_w, focal_x);
  V = __fdiv_rn(py - half_h, focal_y);
}

// (q0 U + q1 V + q3) U + (q2 V + q4) V + q5 over six monomial rows: the
// AA rows share q0 U and q2 V with the normal, which kept those two
// products unfused; num's rows fuse both.
__device__ __forceinline__ float quad_aa(const float* q, float U, float V) {
  const float a = __fadd_rn(__fmaf_rn(q[1], V, __fmul_rn(q[0], U)), q[3]);
  const float b = __fmul_rn(__fadd_rn(__fmul_rn(q[2], V), q[4]), V);
  return __fadd_rn(__fmaf_rn(a, U, b), q[5]);
}

__device__ __forceinline__ float quad_num(const float* q, float U, float V) {
  const float a = __fadd_rn(__fmaf_rn(q[0], U, __fmul_rn(q[1], V)), q[3]);
  const float b = __fmul_rn(__fmaf_rn(q[2], V, q[4]), V);
  return __fadd_rn(__fmaf_rn(a, U, b), q[5]);
}

struct Pair {
  float AA;        // |M d|^2 as evaluated (may round below 0)
  float num;       // |b x M d|^2 as evaluated (may round below 0)
  float AA_safe;   // max(AA, 1e-12)
  float t;         // ray depth of the maximum
  float mv;        // max(num, 0) / AA_safe
  float G;
  float alpha;     // min(opa G, 0.99)
};

// The rest of the pair's quadratic from its 19 monomial rows `r`, given
// AA = quad_aa and num = quad_num of them.
__device__ __forceinline__ Pair finish(const float* r, float U, float V,
                                       float AA, float num) {
  Pair e;
  e.AA = AA;
  e.num = num;
  const float BB = __fmul_rn(
      2.0f, __fadd_rn(__fmaf_rn(r[kRowB + 0], U, __fmul_rn(r[kRowB + 1], V)),
                      r[kRowB + 2]));
  e.AA_safe = fmaxf(e.AA, 1e-12f);
  e.t = __fdiv_rn(-BB, __fmul_rn(2.0f, e.AA_safe));
  e.mv = __fdiv_rn(fmaxf(e.num, 0.0f), e.AA_safe);
  e.G = expf(fminf(__fmul_rn(-0.5f, e.mv), 0.0f));
  e.alpha = fminf(__fmul_rn(r[kRowOpa], e.G), 0.99f);
  return e;
}

// The pair's quadratic from its 19 monomial rows `r`.
__device__ __forceinline__ Pair eval(const float* r, float U, float V) {
  return finish(r, U, V, quad_aa(r + kRowQA, U, V),
                quad_num(r + kRowQK, U, V));
}

// The decision: in front of the near plane and opaque enough.  It does not
// depend on the transmittance, so it runs as a pass of its own.
__device__ __forceinline__ bool passes(const Pair& e) {
  return e.t > kNear && e.alpha >= kAlphaEps;
}

// A shortcut past the divisions and the exp for the pairs that cannot pass
// alpha >= 1/255, which are most pairs: with thr = reject_threshold(opa),
// num > max(AA, 1e-12) thr implies alpha < 1/255 for this evaluation.  thr
// is 2 ln(opa / (1/255)) raised by 1e-4 relative and 2e-3 absolute, far
// more than the rounding of the product, of the division num / AA_safe and
// of expf (2 ulp) together: where the test holds, mv exceeds the
// threshold by at least 1.9e-3, so G opa stays below 0.9991 / 255.  Where
// it does not hold, or meets a NaN, finish decides.  An opacity below
// 1/255 never passes (G <= 1); one of exactly 1/255 passes where G rounds
// to 1, so it takes the threshold 2e-3 like any other.
__device__ __forceinline__ float reject_threshold(float opa) {
  if (opa < kAlphaEps) return __int_as_float(0xff800000);   // -inf
  return __fadd_rn(__fmul_rn(2.0f * logf(opa / kAlphaEps), 1.0001f), 2e-3f);
}

__device__ __forceinline__ bool surely_fails(float AA, float num, float thr) {
  return num > __fmul_rn(fmaxf(AA, 1e-12f), thr);
}

// The contributing arithmetic: the normal n = (M^T M) d with its inverse
// length, and the depth mapping m of the 2DGS distortion.
struct Normal {
  float nx, ny, nz, inv_len;
};

__device__ __forceinline__ Normal normal(const float* r, float U, float V) {
  const float* q = r + kRowQA;
  const float h1 = 0.5f * q[1], h3 = 0.5f * q[3], h4 = 0.5f * q[4];
  Normal n;
  n.nx = __fadd_rn(__fmaf_rn(h1, V, __fmul_rn(q[0], U)), h3);
  n.ny = __fadd_rn(__fmaf_rn(h1, U, __fmul_rn(q[2], V)), h4);
  n.nz = __fadd_rn(q[5], __fmaf_rn(h3, U, __fmul_rn(h4, V)));
  const float len2 = __fadd_rn(
      __fmaf_rn(n.nz, n.nz, __fmaf_rn(n.nx, n.nx, __fmul_rn(n.ny, n.ny))),
      1e-7f);
  n.inv_len = 1.0f / sqrtf(len2);
  return n;
}

__device__ __forceinline__ float depth_m(float t_pos) {
  return __fdiv_rn(__fmaf_rn(kFar, t_pos, -kFar * kNear),
                   __fmul_rn(kFar - kNear, t_pos));
}

}  // namespace gof
