// The screen-space footprint of a Gaussian at one camera, shared by the
// preprocess of a render (preprocess.cu) and the stage cap planner
// (footprint.cu): the projection, the 3D covariance, the EWA 2D covariance,
// its 3-sigma radius and the pixel mean.  One copy, so the planner counts
// exactly the footprints the render bins.
//
// Arithmetic: core/gaussians.py's f32 operations (project_points,
// build_cov3d, cov2d_and_coef, screen_extent, ndc_to_pix), in its order,
// with explicit rounding intrinsics, so that nvcc contracts nothing into an
// FMA and the results equal the composed route's bit for bit.  Each comment
// names the expression it mirrors.  The camera's constants are f32 values
// rounded where PyTorch rounds them (cuda_raster.camera_scalars).  The
// literals are written as double constants cast to float, the rounding
// PyTorch applies to a Python float.  torch.maximum / minimum propagate
// NaN, so max_of / min_of do too.

#pragma once

#include <cuda_runtime.h>

namespace screen {

// cuda_raster.camera_scalars packs these, in this order
struct Camera {
  float wv[16];            // world_view, row-major (row-vector layout)
  float fp[16];            // full_proj, row-major
  float campos[3];         // camera centre
  float focal_x, focal_y;
  float lim_x, lim_y;      // 1.3 tan_fov
  float kernel_size;
  float scale_modifier;
  float width, height;
};
constexpr int kCameraFloats = 43;
static_assert(sizeof(Camera) == kCameraFloats * sizeof(float),
              "Camera must be packed floats");

// The composed route's constants (core/gaussians.py), each the f32 nearest
// to the Python float.
#define F32(x) static_cast<float>(x)
constexpr float kNear = F32(0.2);
constexpr float kWEps = F32(1e-7);   // w's and 1 / sqrt(s^2 + eps)'s
constexpr float kTzMin = F32(1e-4);
constexpr float kDetMin = F32(1e-6);
constexpr float kLambdaMin = F32(0.1);
#undef F32

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float dvd(float a, float b) {
  return __fdiv_rn(a, b);
}

// torch.maximum / torch.minimum against a constant: NaN stays NaN
__device__ __forceinline__ float max_of(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float min_of(float x, float hi) {
  return x != x ? x : fminf(x, hi);
}

// x m[0][j] + y m[1][j] + z m[2][j] + m[3][j] (project_points' col, the t of
// _gaussian_to_view and cov2d_and_coef)
__device__ __forceinline__ float col(const float* m, float x, float y,
                                     float z, int j) {
  return add(add(add(mul(x, m[j]), mul(y, m[4 + j])), mul(z, m[8 + j])),
             m[12 + j]);
}

// r0 . r0-style sums of three products, left to right
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1,
                                     float a2, float b2) {
  return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}

// project_points: p_view, then p_ndc = col(fp, j) * 1 / (w + 1e-7)
struct Projected {
  float pv[3];
  float ndc0, ndc1;
};
__device__ __forceinline__ Projected project(const Camera& c, float m0,
                                             float m1, float m2) {
  Projected p;
#pragma unroll
  for (int j = 0; j < 3; ++j) p.pv[j] = col(c.wv, m0, m1, m2, j);
  const float p_w = __frcp_rn(add(col(c.fp, m0, m1, m2, 3), kWEps));
  p.ndc0 = mul(col(c.fp, m0, m1, m2, 0), p_w);
  p.ndc1 = mul(col(c.fp, m0, m1, m2, 1), p_w);
  return p;
}

// _rotmat_comps: the 9 row-major components of a quaternion's rotation
__device__ __forceinline__ void rotmat(float qr, float qx, float qy, float qz,
                                       float* R) {
  const float xx = mul(qx, qx), yy = mul(qy, qy), zz = mul(qz, qz);
  const float xy = mul(qx, qy), xz = mul(qx, qz), yz = mul(qy, qz);
  const float rx = mul(qr, qx), ry = mul(qr, qy), rz = mul(qr, qz);
  R[0] = sub(1.0f, mul(2.0f, add(yy, zz)));
  R[1] = mul(2.0f, sub(xy, rz));
  R[2] = mul(2.0f, add(xz, ry));
  R[3] = mul(2.0f, add(xy, rz));
  R[4] = sub(1.0f, mul(2.0f, add(xx, zz)));
  R[5] = mul(2.0f, sub(yz, rx));
  R[6] = mul(2.0f, sub(xz, ry));
  R[7] = mul(2.0f, add(yz, rx));
  R[8] = sub(1.0f, mul(2.0f, add(xx, yy)));
}

// build_cov3d: m = R diag(s * scale_modifier), cov = m m^T as its upper
// triangle (xx, xy, xz, yy, yz, zz)
__device__ __forceinline__ void cov3d(const float* R, float s0, float s1,
                                      float s2, float scale_modifier,
                                      float* cov) {
  const float sm[3] = {mul(s0, scale_modifier), mul(s1, scale_modifier),
                       mul(s2, scale_modifier)};
  float mm[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) mm[k] = mul(R[k], sm[k % 3]);
  auto cdot = [&](int a, int b) {
    return dot3(mm[3 * a], mm[3 * b], mm[3 * a + 1], mm[3 * b + 1],
                mm[3 * a + 2], mm[3 * b + 2]);
  };
  cov[0] = cdot(0, 0);
  cov[1] = cdot(0, 1);
  cov[2] = cdot(0, 2);
  cov[3] = cdot(1, 1);
  cov[4] = cdot(1, 2);
  cov[5] = cdot(2, 2);
}

// cov2d_and_coef's EWA covariance (cxx, cxy, cyy), before the kernel is
// added, of the view-space mean pv and cov3d's upper triangle
struct Cov2d {
  float xx, xy, yy;
};
__device__ __forceinline__ Cov2d cov2d(const Camera& c, const float* pv,
                                       const float* cov) {
  const float tz = max_of(pv[2], kTzMin);
  const float tx = mul(min_of(max_of(dvd(pv[0], tz), -c.lim_x), c.lim_x), tz);
  const float ty = mul(min_of(max_of(dvd(pv[1], tz), -c.lim_y), c.lim_y), tz);
  const float tz2 = mul(tz, tz);
  const float j00 = dvd(c.focal_x, tz);
  const float j02 = dvd(-mul(tx, c.focal_x), tz2);
  const float j11 = dvd(c.focal_y, tz);
  const float j12 = dvd(-mul(ty, c.focal_y), tz2);
  float r0[3], r1[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {   // Wc[i][k] = wv[k][i]
    r0[k] = add(mul(j00, c.wv[4 * k]), mul(j02, c.wv[4 * k + 2]));
    r1[k] = add(mul(j11, c.wv[4 * k + 1]), mul(j12, c.wv[4 * k + 2]));
  }
  const float V[3][3] = {{cov[0], cov[1], cov[2]},
                         {cov[1], cov[3], cov[4]},
                         {cov[2], cov[4], cov[5]}};
  // V r0 and V r1, each row a dot3; r1's serves two of the three forms
  float v0[3], v1[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    v0[k] = dot3(V[k][0], r0[0], V[k][1], r0[1], V[k][2], r0[2]);
    v1[k] = dot3(V[k][0], r1[0], V[k][1], r1[1], V[k][2], r1[2]);
  }
  // quad(a, Vb): 0.0 + a0 vb0, then + a1 vb1, + a2 vb2
  auto quad = [&](const float* a, const float* vb) {
    float out = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) out = add(out, mul(a[k], vb[k]));
    return out;
  };
  return {quad(r0, v0), quad(r0, v1), quad(r1, v1)};
}

// screen_extent on (cxx + k, cxy, cyy + k): those two sums, cxy^2, the
// determinant and the 3-sigma radius ceil(3 sqrt(lambda1))
struct Extent {
  float xk, yk, xy2, det, radius;
};
__device__ __forceinline__ Extent extent(const Cov2d& v, float kernel_size) {
  Extent e;
  e.xk = add(v.xx, kernel_size);
  e.yk = add(v.yy, kernel_size);
  e.xy2 = mul(v.xy, v.xy);
  e.det = sub(mul(e.xk, e.yk), e.xy2);
  const float mid = mul(0.5f, add(e.xk, e.yk));
  const float lambda1 =
      add(mid, __fsqrt_rn(max_of(sub(mul(mid, mid), e.det), kLambdaMin)));
  e.radius = ceilf(mul(3.0f, __fsqrt_rn(lambda1)));
  return e;
}

// ndc_to_pix: ((v + 1) S - 1) / 2
__device__ __forceinline__ float ndc_to_pix(float v, float size) {
  return mul(sub(mul(add(v, 1.0f), size), 1.0f), 0.5f);
}

}  // namespace screen
