// Per-Gaussian preprocess of a render that no gradient flows through: the
// Hopper (sm_90a) kernel of the serving, reconstruction and mesh renders.
//
// Replaces no TPU kernel: the JAX package leaves this code
// (f3d_gaus_tpu/core/gaussians.py:preprocess and the feature expansion of
// f3d_gaus_tpu/ops/rasterize.py) to XLA, which fuses it into a few kernels.
// Composed of PyTorch's element-wise operations, the same code is about 600
// kernel launches a render, and the host that issues them one at a time
// set the pace of a serving request.  Its plain PyTorch version is
// f3d_gaus_torch/ops/rasterize.py:_preprocess_impl (core/gaussians.py:
// preprocess, then the feature table of cuda_raster._all_features and the
// conic | means2d table); the wrapper is f3d_gaus_torch/ops/cuda_raster.py:
// preprocess, and rasterize.prepare takes it for CUDA tensors when
// autograd records nothing and no colours are given.
//
// What it computes, one thread a Gaussian: the view-space depth, the
// projected pixel mean, the EWA 2D covariance (kernel_size added) with its
// conic, 3-sigma radius (0 where culled) and GOF low-pass opacity
// coefficient, the SH colour (degrees 0-3, clamped at 0) and the
// cancellation-free ray-quadratic packing v2g_mb = (M, b), and from those
// the (P, 19) monomial feature table the compositing kernels read and the
// (P, 5) conic | means2d table.  It writes only what the render reads
// after it: the two tables (the colour, the opacity times its coefficient
// and v2g_mb live on in the feature table), the depths and the radii (0
// where not valid).  The SH clamp mask serves only a backward, which this
// route never has.
//
// Arithmetic: the composed route's f32 operations, in its order, with
// explicit rounding intrinsics, so that nvcc contracts nothing into an FMA
// and the results equal the composed route's bit for bit (the binning
// sorts and counts from depths, means2d and radii, which must not move).
// The projection, covariances, radius and pixel mean are screen.cuh's,
// which the stage cap planner (footprint.cu) shares, so the planner counts
// exactly the footprints this kernel gives.  Each comment names the
// expression it mirrors.  The camera's constants are f32 values rounded
// where PyTorch rounds them (cuda_raster.camera_scalars), read from device
// memory: each block stages the kCameraFloats of the row into shared
// memory before its Gaussians, so a CUDA graph that captured the launch
// reads whatever camera was copied into the row before its replay
// (pipeline/renderer.py's stage table).
//
// What bounds it on this card: bytes.  At SH degree 1 a Gaussian reads 92
// bytes and writes 104 (table 76, conic | means2d 20, depth and radius),
// about 116 MB at 589,824 Gaussians, 35 us at 3.35 TB/s; its few hundred
// f32 operations are under 10 us at 67 TFLOP/s.  Design: the two wide rows
// (76 and 20 bytes) are staged through shared memory so that each block
// stores them as contiguous 16-byte words; the narrow outputs are one
// coalesced word a thread; the inputs are read once, their lines shared
// by a warp's loads.

#include <cuda_runtime.h>

#include "screen.cuh"

namespace {

using namespace screen;

constexpr int kThreads = 128;
constexpr int kNFeat = 19;     // rasterize.NFEAT
constexpr int kExtra = 5;      // conic (3) | means2d (2)

struct Params {
  const float* means;      // (P, 3)
  const float* scales;     // (P, 3)
  const float* quats;      // (P, 4)
  const float* opacity;    // (P,)
  const float* shs;        // (P, K, 3), K >= (sh_degree + 1)^2
  int num;
  int sh_stride;           // 3 K
  int sh_degree;
  float* feat;             // (P, 19)
  float* extra;            // (P, 5)
  float* depths;           // (P,)
  int* radii;              // (P,)
};

// The SH constants (core/sh.py), each the f32 nearest to the Python float.
#define F32(x) static_cast<float>(x)
constexpr float kNormEps = F32(1e-16);
constexpr float kC0 = F32(0.28209479177387814);
constexpr float kC1 = F32(0.4886025119029199);
__constant__ float kC2[5] = {
    F32(1.0925484305920792), F32(-1.0925484305920792), F32(0.31539156525252005),
    F32(-1.0925484305920792), F32(0.5462742152960396)};
__constant__ float kC3[7] = {
    F32(-0.5900435899266435), F32(2.890611442640554), F32(-0.4570457994644658),
    F32(0.3731763325901154), F32(-0.4570457994644658), F32(1.445305721320277),
    F32(-0.5900435899266435)};
#undef F32

// rasterize._quadform6: (xx, 2xy, yy, 2xz, 2yz, zz) of d^T (G^T G) d, G's
// rows r0, r1, r2
__device__ __forceinline__ void quadform6(const float* r0, const float* r1,
                                          const float* r2, float* out) {
  auto cdot = [&](int i, int j) {
    return dot3(r0[i], r0[j], r1[i], r1[j], r2[i], r2[j]);
  };
  out[0] = cdot(0, 0);
  out[1] = mul(cdot(0, 1), 2.0f);
  out[2] = cdot(1, 1);
  out[3] = mul(cdot(0, 2), 2.0f);
  out[4] = mul(cdot(1, 2), 2.0f);
  out[5] = cdot(2, 2);
}

// count floats from shared `src` to global `dst`, as 16-byte words where
// dst is aligned to them
__device__ __forceinline__ void store_rows(float* dst, const float* src,
                                           int count) {
  if ((reinterpret_cast<size_t>(dst) & 15) == 0) {
    const int n4 = count / 4;
    float4* d4 = reinterpret_cast<float4*>(dst);
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int k = threadIdx.x; k < n4; k += kThreads) d4[k] = s4[k];
    for (int k = 4 * n4 + threadIdx.x; k < count; k += kThreads)
      dst[k] = src[k];
  } else {
    for (int k = threadIdx.x; k < count; k += kThreads) dst[k] = src[k];
  }
}

__global__ void __launch_bounds__(kThreads)
preprocess_kernel(Params p, const float* __restrict__ camera) {
  __shared__ __align__(16) float s_feat[kThreads * kNFeat];
  __shared__ __align__(16) float s_extra[kThreads * kExtra];
  __shared__ Camera s_cam;
  if (threadIdx.x < kCameraFloats)
    reinterpret_cast<float*>(&s_cam)[threadIdx.x] = camera[threadIdx.x];
  __syncthreads();
  const Camera& c = s_cam;
  const int base = blockIdx.x * kThreads;
  const int rows = min(kThreads, p.num - base);
  const int i = base + threadIdx.x;

  if (threadIdx.x < rows) {
    const float m0 = p.means[3 * i], m1 = p.means[3 * i + 1],
                m2 = p.means[3 * i + 2];
    const float s0 = p.scales[3 * i], s1 = p.scales[3 * i + 1],
                s2 = p.scales[3 * i + 2];
    const float qr = p.quats[4 * i], qx = p.quats[4 * i + 1],
                qy = p.quats[4 * i + 2], qz = p.quats[4 * i + 3];
    const float opacity = p.opacity[i];

    // the footprint (screen.cuh): projection, build_cov3d, the EWA
    // covariance, screen_extent and ndc_to_pix
    const Projected pj = project(c, m0, m1, m2);
    const float pv0 = pj.pv[0], pv1 = pj.pv[1], pv2 = pj.pv[2];
    const bool in_front = pv2 > kNear;
    float R[9], cov[6];
    rotmat(qr, qx, qy, qz, R);
    cov3d(R, s0, s1, s2, c.scale_modifier, cov);
    const Cov2d cv = cov2d(c, pj.pv, cov);
    const Extent ex = extent(cv, c.kernel_size);

    // cov2d_and_coef's low-pass coefficient
    const float det0 =
        max_of(sub(mul(cv.xx, cv.yy), mul(cv.xy, cv.xy)), kDetMin);
    const float det1 = max_of(sub(mul(ex.xk, ex.yk), ex.xy2), kDetMin);
    float coef = __fsqrt_rn(add(dvd(det0, add(det1, kDetMin)), kDetMin));
    if (det0 <= kDetMin || det1 <= kDetMin) coef = 0.0f;

    // screen_extent's conic
    const float det = ex.det;
    const float det_inv = det == 0.0f ? 0.0f : __frcp_rn(det);
    const float conic0 = mul(ex.yk, det_inv);
    const float conic1 = mul(-cv.xy, det_inv);
    const float conic2 = mul(ex.xk, det_inv);
    const float radius = ex.radius;
    const bool valid = in_front && det != 0.0f;
    const float mx = ndc_to_pix(pj.ndc0, c.width);
    const float my = ndc_to_pix(pj.ndc1, c.height);

    // sh_color_from_gaussians: dirs = (mean - campos) / sqrt(|d|^2 + eps),
    // |d|^2 summed left to right as core/sh.py writes it out
    float d0 = sub(m0, c.campos[0]), d1 = sub(m1, c.campos[1]),
          d2 = sub(m2, c.campos[2]);
    const float norm =
        __fsqrt_rn(add(add(add(mul(d0, d0), mul(d1, d1)), mul(d2, d2)),
                       kNormEps));
    d0 = dvd(d0, norm);
    d1 = dvd(d1, norm);
    d2 = dvd(d2, norm);
    // eval_sh's per-Gaussian factors
    const float a1y = mul(kC1, d1), a1z = mul(kC1, d2), a1x = mul(kC1, d0);
    const float sxx = mul(d0, d0), syy = mul(d1, d1), szz = mul(d2, d2);
    const float sxy = mul(d0, d1), syz = mul(d1, d2), sxz = mul(d0, d2);
    const float zz2_xx_yy = sub(sub(mul(2.0f, szz), sxx), syy);
    const float zz4_xx_yy = sub(sub(mul(4.0f, szz), sxx), syy);
    const float xx_yy = sub(sxx, syy);
    const float b2[5] = {mul(kC2[0], sxy), mul(kC2[1], syz),
                         mul(kC2[2], zz2_xx_yy), mul(kC2[3], sxz),
                         mul(kC2[4], xx_yy)};
    const float b3[7] = {
        mul(mul(kC3[0], d1), sub(mul(3.0f, sxx), syy)),
        mul(mul(kC3[1], sxy), d2),
        mul(mul(kC3[2], d1), zz4_xx_yy),
        mul(mul(kC3[3], d2),
            sub(sub(mul(2.0f, szz), mul(3.0f, sxx)), mul(3.0f, syy))),
        mul(mul(kC3[4], d0), zz4_xx_yy),
        mul(mul(kC3[5], d2), xx_yy),
        mul(mul(kC3[6], d0), sub(sxx, mul(3.0f, syy)))};
    const float* sh = p.shs + (size_t)i * p.sh_stride;
    float rgb[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float r = mul(kC0, sh[ch]);
      if (p.sh_degree > 0) {
        r = sub(r, mul(a1y, sh[3 + ch]));
        r = add(r, mul(a1z, sh[6 + ch]));
        r = sub(r, mul(a1x, sh[9 + ch]));
        if (p.sh_degree > 1) {
#pragma unroll
          for (int k = 0; k < 5; ++k)
            r = add(r, mul(b2[k], sh[12 + 3 * k + ch]));
          if (p.sh_degree > 2) {
#pragma unroll
            for (int k = 0; k < 7; ++k)
              r = add(r, mul(b3[k], sh[27 + 3 * k + ch]));
          }
        }
      }
      rgb[ch] = max_of(add(r, 0.5f), 0.0f);
    }

    // view2gaussian_mb: Rv = W^T R, t2 = -Rv^T t, M = S^-1 Rv^T, b = S^-1 t2
    float Rv[9];
#pragma unroll
    for (int a = 0; a < 3; ++a)     // w[a][k] = wv[k][a]
#pragma unroll
      for (int b = 0; b < 3; ++b)
        Rv[3 * a + b] = dot3(c.wv[a], R[b], c.wv[4 + a], R[3 + b],
                             c.wv[8 + a], R[6 + b]);
    const float t2[3] = {-dot3(Rv[0], pv0, Rv[3], pv1, Rv[6], pv2),
                         -dot3(Rv[1], pv0, Rv[4], pv1, Rv[7], pv2),
                         -dot3(Rv[2], pv0, Rv[5], pv1, Rv[8], pv2)};
    const float si[3] = {__frcp_rn(__fsqrt_rn(add(mul(s0, s0), kWEps))),
                         __frcp_rn(__fsqrt_rn(add(mul(s1, s1), kWEps))),
                         __frcp_rn(__fsqrt_rn(add(mul(s2, s2), kWEps)))};
    float M[9], bb[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) M[3 * a + b] = mul(si[a], Rv[3 * b + a]);
      bb[a] = mul(si[a], t2[a]);
    }

    // prepare's opacities: opa_coef = opacity * coef; the table's column is
    // opa + (opa_coef - opa), the value of its detach() trick
    const float opa_coef = mul(opacity, coef);
    const float opa = add(opacity, sub(opa_coef, opacity));

    // _expand_feature_columns: qa | qk (K = [b]_x M) | B = M^T b | rgb | opa
    float* f = s_feat + threadIdx.x * kNFeat;
    quadform6(M, M + 3, M + 6, f);
    float k0[3], k1[3], k2[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      k0[j] = add(mul(-bb[2], M[3 + j]), mul(bb[1], M[6 + j]));
      k1[j] = sub(mul(bb[2], M[j]), mul(bb[0], M[6 + j]));
      k2[j] = add(mul(-bb[1], M[j]), mul(bb[0], M[3 + j]));
    }
    quadform6(k0, k1, k2, f + 6);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      f[12 + j] = dot3(M[j], bb[0], M[3 + j], bb[1], M[6 + j], bb[2]);
    f[15] = rgb[0];
    f[16] = rgb[1];
    f[17] = rgb[2];
    f[18] = opa;

    float* e = s_extra + threadIdx.x * kExtra;
    e[0] = conic0;
    e[1] = conic1;
    e[2] = conic2;
    e[3] = mx;
    e[4] = my;

    p.depths[i] = pv2;
    p.radii[i] = valid ? (int)radius : 0;
  }
  __syncthreads();
  store_rows(p.feat + (size_t)base * kNFeat, s_feat, rows * kNFeat);
  store_rows(p.extra + (size_t)base * kExtra, s_extra, rows * kExtra);
}

}  // namespace

// One launch over `num_gaussians` Gaussians; `camera` points to the
// kCameraFloats floats of cuda_raster.camera_scalars in device memory,
// which the kernel reads when it runs.
extern "C" int f3d_preprocess(
    int device, const float* means, const float* scales, const float* quats,
    const float* opacity, const float* shs, int num_gaussians, int sh_stride,
    int sh_degree, const float* camera, float* feat, float* extra,
    float* depths, int* radii, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (num_gaussians == 0) return 0;
  Params p{means, scales,    quats, opacity, shs,  num_gaussians,
           sh_stride, sh_degree, feat,  extra,   depths, radii};
  preprocess_kernel<<<(num_gaussians + kThreads - 1) / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>(p, camera);
  return (int)cudaGetLastError();
}
