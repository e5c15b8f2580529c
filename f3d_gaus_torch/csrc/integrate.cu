// Opacity-field query ("integrate"): the Hopper (sm_90a) kernel of the mesh
// path's field, one view at a time.
//
// Replaces f3d_gaus_tpu/ops/integrate.py:_point_alpha_product (:82) and the
// window walk of _integrate_chunk (:104), which the JAX package leaves to
// XLA (there is no Pallas kernel for it); in the CUDA reference it is
// integrateCUDA.  Its plain PyTorch version is
// f3d_gaus_torch/ops/integrate.py:_alpha_impl; the wrapper is
// f3d_gaus_torch/ops/cuda_raster.py:integrate.
//
// What it computes: for each query point, the product T of (1 - alpha)
// over the Gaussians of its tile's window min(tile_count, max_per_tile),
// alpha = min(0.99, opa exp(-val / 2)) evaluated on the point's own ray at
// t_c = min(t_peak, point depth), pairs with alpha < 1/255 skipped; then
// out = 1 - T, or out = min(out, 1 - T) for the view sweep's running
// minimum.  The product is order-free, so no thread waits on another.
//
// What bounds it on this card: FP32 CUDA-core arithmetic, about 43
// operations per (point, pair) (OPS_PER_PAIR_INTEGRATE in chip_smoke.py,
// counted from pair_alpha below: a = M d 12, AA 5, a.b 5, the AA == 0
// select 1, the division 1, the clamp 1, g 6, val 5, the exponent 3, the
// 0.99 clamp 1, the test 1, 1 - alpha and the product 2).  A pair that
// fails the 1/255 test needs only its first 36 of them and one compare of
// val against 2 ln(255 opa), 37 (OPS_PER_FAILING_INTEGRATE): the bound
// charges it that, though this kernel still takes the exp.  Bytes are
// small: a 13-float row per Gaussian of a window, read once per CTA.
//
// Design (simple first): the wrapper sorts the points by tile (points
// outside the image or the near plane go to a last segment with an empty
// window); one CTA takes one (tile, block of 128 points) item, so a tile
// with more points gets more CTAs; a CTA finds its tile by a binary search
// over the items' exclusive prefix, on the device, so the grid needs no
// host sync.  The window's rows are staged through shared memory in
// batches of 128, each thread keeping its own running product.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;    // points per CTA
constexpr int kBatch = 128;      // window rows staged per step
constexpr int kRow = 16;         // staged row: M (9), b (3), opa, padding
constexpr float kAlphaEps = 1.0f / 255.0f;

struct Params {
  const float* mb;          // (P, 12) M row-major ++ b
  const float* opa;         // (P,)
  const int* point_list;    // slab of Gaussian ids, P = padding
  const int* tile_start;    // (T,)
  const int* tile_count;    // (T,) unclamped
  int num_tiles;
  int num_gaussians;        // P
  int max_per_tile;
  const int* perm;          // (Q,) sorted position -> point
  const int* seg_start;     // (T + 2,) first sorted position of segment s
  const int* item_start;    // (T + 2,) first item of segment s
  const float* u;           // (Q,) ray (u, v, 1)
  const float* v;
  const float* depth;       // (Q,) view depth
  float* out;               // (Q,)
  int running_min;          // 0: out = 1 - T; 1: out = min(out, 1 - T)
};

// 1 - alpha of one (point, Gaussian) pair, or 1 where the pair is skipped;
// the order of operations of integrate.py:_point_alpha_product
__device__ __forceinline__ float pair_factor(const float* r, float U, float V,
                                             float D) {
  const float a0 = r[0] * U + r[1] * V + r[2];
  const float a1 = r[3] * U + r[4] * V + r[5];
  const float a2 = r[6] * U + r[7] * V + r[8];
  const float AA = a0 * a0 + a1 * a1 + a2 * a2;
  const float ab = a0 * r[9] + a1 * r[10] + a2 * r[11];
  const float t_peak = -ab / (AA == 0.0f ? 1e-12f : AA);
  const float t_c = fminf(t_peak, D);
  const float g0 = t_c * a0 + r[9];
  const float g1 = t_c * a1 + r[10];
  const float g2 = t_c * a2 + r[11];
  const float val = g0 * g0 + g1 * g1 + g2 * g2;
  const float alpha = fminf(0.99f, r[12] * expf(-0.5f * val));
  return alpha >= kAlphaEps ? 1.0f - alpha : 1.0f;
}

__global__ void __launch_bounds__(kThreads) integrate_kernel(const Params p) {
  __shared__ __align__(16) float rows[kBatch * kRow];

  const int nseg = p.num_tiles + 1;
  const int item = blockIdx.x;
  if (item >= p.item_start[nseg]) return;
  // the last segment whose first item is at or before this one (segments
  // without points own no item and are passed over)
  int lo = 0, hi = nseg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (p.item_start[mid] <= item) lo = mid;
    else hi = mid - 1;
  }
  const int seg = lo;
  const int i = p.seg_start[seg] + (item - p.item_start[seg]) * kThreads +
                threadIdx.x;
  const bool live = i < p.seg_start[seg + 1];
  const int q = live ? p.perm[i] : 0;
  const float U = live ? p.u[q] : 0.0f;
  const float V = live ? p.v[q] : 0.0f;
  const float D = live ? p.depth[q] : 0.0f;

  const bool tile = seg < p.num_tiles;   // else the outside segment
  const int n = tile ? min(p.tile_count[seg], p.max_per_tile) : 0;
  const int start = tile ? p.tile_start[seg] : 0;
  float T = 1.0f;
  for (int b0 = 0; b0 < n; b0 += kBatch) {
    const int nb = min(kBatch, n - b0);
    __syncthreads();   // the previous batch's rows are free
    {
      const int k = threadIdx.x;   // kThreads == kBatch: one row each
      float* dst = rows + k * kRow;
      const int id = k < nb ? p.point_list[start + b0 + k] : -1;
      const bool valid = id >= 0 && id < p.num_gaussians;
      const float* src = p.mb + (long long)(valid ? id : 0) * 12;
#pragma unroll
      for (int c = 0; c < 12; ++c) dst[c] = valid ? __ldg(src + c) : 0.0f;
      // an invalid slot gets opacity 0: alpha 0 fails the 1/255 test
      dst[12] = valid ? __ldg(p.opa + id) : 0.0f;
      dst[13] = dst[14] = dst[15] = 0.0f;
    }
    __syncthreads();
#pragma unroll 2
    for (int k = 0; k < nb; ++k) {
      const float4* r4 = reinterpret_cast<const float4*>(rows + k * kRow);
      float r[kRow];
#pragma unroll
      for (int c = 0; c < kRow / 4; ++c) {
        const float4 x = r4[c];
        r[4 * c + 0] = x.x;
        r[4 * c + 1] = x.y;
        r[4 * c + 2] = x.z;
        r[4 * c + 3] = x.w;
      }
      T *= pair_factor(r, U, V, D);
    }
  }
  if (live) {
    const float alpha = 1.0f - T;
    p.out[q] = p.running_min ? fminf(p.out[q], alpha) : alpha;
  }
}

}  // namespace

// Plain C interface for ctypes.  Launches on `stream` and does not
// synchronise; returns cudaGetLastError() (0 = launched).  `grid` is an
// upper bound on the items (Q / 128 + T + 1); CTAs past the last item
// return at once.
extern "C" int f3d_integrate(
    int device, const float* mb, const float* opa, const int* point_list,
    const int* tile_start, const int* tile_count, int num_tiles,
    int num_gaussians, int max_per_tile, const int* perm,
    const int* seg_start, const int* item_start, const float* u,
    const float* v, const float* depth, float* out, int running_min, int grid,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (grid <= 0) return 0;
  Params p{mb,        opa,        point_list, tile_start,   tile_count,
           num_tiles, num_gaussians, max_per_tile, perm,     seg_start,
           item_start, u,         v,          depth,        out,
           running_min};
  integrate_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
