// GOF tile compositing, backward: the Hopper (sm_90a) kernel of the port.
//
// Replaces the TPU kernel f3d_gaus_tpu/ops/pallas_raster.py:_bwd_kernel
// together with the segment_sum of its caller _cff_bwd.  Its plain PyTorch
// version is f3d_gaus_torch/ops/rasterize.py:_composite_bwd_impl (the
// pull-back written out formula by formula, and held against autograd, is
// tests/test_torch_rasterize_grad.py:chunk_eval_vjp); the wrapper is
// f3d_gaus_torch/ops/cuda_raster.py:composite_bwd.
//
// What it computes: the gradient of the forward kernel (raster_fwd.cu)
// with respect to the (P, 19) feature table, plus the (P, 3) densification
// statistics, from the cotangent g_out (T, 256, 9) of out9 and the
// forward's residuals (final_T, dist1, last_pos, max_pos).  Each pixel
// walks its tile's window back to front from its last contributor, as the
// CUDA reference does (backward.cu:738-953):
//   * T before each contributor is rebuilt from final_T by division by
//     1 - alpha (alpha <= 0.99, so the divisor is >= 0.01; the stop rule
//     keeps every T >= 1e-4, so nothing underflows);
//   * the suffix sums of w (gL_rgb . c) and w (gL_nn . nn) accumulate from
//     zero; dL/dalpha adds the background term -T_final/(1-alpha) bg.gL_rgb;
//   * the distortion gradient goes through m with detached weights, the
//     depth gradient to the median contributor (max_pos) only, the alpha
//     channel (7) takes none;
//   * the pull-back through the ray quadratic to the 19 monomial rows
//     (clamps of AA and num pass nothing where they bind, the pass-through
//     minima at 0 and 0.99 pass everything, the normal's sqrt(.+1e-7)
//     normalisation, the 1e-6 floor of t in m);
//   * the stats |dL/dmean2d| through the conic, |gx| + |gy| per pixel.
//
// What bounds it on this card: FP32 CUDA-core arithmetic and the atomics.
// Every walked (pixel, pair) costs about 41 FP32 operations to decide
// whether it contributed; a contributing one about 181 more for the chain
// above and the warp sums of its 22 gradients; chip_smoke.py counts both
// from the data of a run.  The bytes (the 24 staged columns per Gaussian,
// the per-pixel residuals, the read-modify-write of the touched (P, 22)
// rows) are far below the arithmetic.
//
// Design, simple first: one CTA per tile, one thread per pixel, as the
// forward.  The block reduces its largest last_pos and walks positions
// from there down to 0 in rounds of up to 256 staged rows (19 feature +
// 5 conic/means2d columns, 24 KB of shared memory).  All 32 lanes of a
// warp visit the same Gaussian in the same iteration, so a warp with any
// contributing lane sums each of the 22 gradients with __shfl_down_sync
// and lane 0 issues one atomicAdd per value; a warp with none skips the
// Gaussian.  The atomics make the summation order, and so the last bits,
// vary from launch to launch.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 16;
constexpr int kPix = kBlock * kBlock;   // threads per CTA, one per pixel
constexpr int kBatch = 256;             // rows staged per round
constexpr int kNFeat = 19;
constexpr int kNExtra = 5;              // conic (3) | means2d (2)
constexpr int kNCols = kNFeat + kNExtra;
constexpr int kNGrad = kNFeat + 3;      // feature gradients | stats
constexpr int kRowQA = 0;
constexpr int kRowQK = 6;
constexpr int kRowB = 12;
constexpr int kRowRGB = 15;
constexpr int kRowOpa = 18;

constexpr float kNear = 0.2f;
constexpr float kFar = 100.0f;
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* allf;       // (P, kNFeat) feature table
  const float* extra;      // (P, kNExtra) conic | means2d
  const int* point_list;   // aligned slab of Gaussian ids
  const int* tile_start;   // (T,)
  const int* tile_count;   // (T,) unclamped
  int grid_x;
  float half_w, half_h;    // width / 2, height / 2
  float focal_x, focal_y;
  int max_per_tile;
  const float* bg;         // (3,)
  const float* g_out;      // (T, 256, 9) cotangent of out9
  const float* final_T;    // (T, 256)
  const float* dist1;      // (T, 256)
  const int* last_pos;     // (T, 256)
  const int* max_pos;      // (T, 256)
  float* d_feat;           // (P, kNFeat), zeroed by the caller
  float* d_stats;          // (P, 3), zeroed by the caller
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(kFull, x, o);
  return x;
}

__global__ void __launch_bounds__(kPix)
raster_bwd_kernel(const Params p) {
  __shared__ float feat[kNCols][kBatch];
  __shared__ int gid[kBatch];
  __shared__ int block_last;

  const int tile = blockIdx.x;
  const int pix = threadIdx.x;
  const int lane = pix & 31;
  const int tx = tile % p.grid_x;
  const int ty = tile / p.grid_x;
  const int ix = tx * kBlock + pix % kBlock;
  const int iy = ty * kBlock + pix / kBlock;
  const float U = ((float)ix + 0.5f - p.half_w) / p.focal_x;
  const float V = ((float)iy + 0.5f - p.half_h) / p.focal_y;
  const float UU = U * U, UV = U * V, VV = V * V;

  const long long o = (long long)tile * kPix + pix;
  const int lastp = p.last_pos[o];
  const int maxp = p.max_pos[o];
  const float T_final = p.final_T[o];
  const float final_A = 1.0f - T_final;
  const float final_D1 = p.dist1[o];
  const float* g = p.g_out + o * 9;
  const float gr0 = g[0], gr1 = g[1], gr2 = g[2];
  const float gn0 = g[3], gn1 = g[4], gn2 = g[5];
  const float g_depth = g[6];
  const float g_reg = g[8];
  const float bg_dot = p.bg[0] * gr0 + p.bg[1] * gr1 + p.bg[2] * gr2;

  // the block's largest last contributor bounds the walk
  if (pix == 0) block_last = -1;
  __syncthreads();
  int wl = lastp;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) wl = max(wl, __shfl_xor_sync(kFull, wl, s));
  if (lane == 0) atomicMax(&block_last, wl);
  __syncthreads();
  const int start = p.tile_start[tile];
  const int cnt = min(p.tile_count[tile], p.max_per_tile);
  const int last = min(block_last, cnt - 1);

  float T = T_final;
  float S_rgb = 0.f, S_nn = 0.f;   // suffix sums of w (gL . c), w (gL . nn)

  for (int base = (last / kBatch) * kBatch; base >= 0 && last >= 0;
       base -= kBatch) {
    const int nb = min(kBatch, last + 1 - base);
    __syncthreads();   // the previous round's rows are free
    if (pix < nb) {
      const int id = p.point_list[start + base + pix];
      gid[pix] = id;
      const float* row = p.allf + (long long)id * kNFeat;
#pragma unroll
      for (int k = 0; k < kNFeat; ++k) feat[k][pix] = row[k];
      const float* ex = p.extra + (long long)id * kNExtra;
#pragma unroll
      for (int k = 0; k < kNExtra; ++k) feat[kNFeat + k][pix] = ex[k];
    }
    __syncthreads();

    for (int k = nb - 1; k >= 0; --k) {
      const int j = base + k;
      // forward's classification, the same f32 formulas as raster_fwd.cu
      bool contrib = false;
      float AA = 0.f, num = 0.f, AA_safe = 1.f, t = 0.f, mv = 0.f, G = 0.f;
      float alpha = 0.f;
      const float opa = feat[kRowOpa][k];
      if (j <= lastp) {
        AA = (feat[kRowQA + 0][k] * U + feat[kRowQA + 1][k] * V +
              feat[kRowQA + 3][k]) * U +
             (feat[kRowQA + 2][k] * V + feat[kRowQA + 4][k]) * V +
             feat[kRowQA + 5][k];
        num = (feat[kRowQK + 0][k] * U + feat[kRowQK + 1][k] * V +
               feat[kRowQK + 3][k]) * U +
              (feat[kRowQK + 2][k] * V + feat[kRowQK + 4][k]) * V +
              feat[kRowQK + 5][k];
        const float BB = 2.0f * (feat[kRowB + 0][k] * U +
                                 feat[kRowB + 1][k] * V + feat[kRowB + 2][k]);
        AA_safe = fmaxf(AA, 1e-12f);
        t = -BB / (2.0f * AA_safe);
        if (t > kNear) {
          mv = fmaxf(num, 0.0f) / AA_safe;
          G = expf(fminf(-0.5f * mv, 0.0f));
          alpha = fminf(opa * G, 0.99f);
          contrib = alpha >= kAlphaEps;
        }
      }
      if (__ballot_sync(kFull, contrib) == 0u) continue;   // warp-uniform

      float gq[kNGrad];
#pragma unroll
      for (int q = 0; q < kNGrad; ++q) gq[q] = 0.f;
      if (contrib) {
        const float om = 1.0f - alpha;
        const float T_before = T / om;
        const float T_next = T_before * om;
        const float w = T_before * alpha;

        const float qa0 = feat[kRowQA + 0][k], qa1 = feat[kRowQA + 1][k];
        const float qa2 = feat[kRowQA + 2][k], qa3 = feat[kRowQA + 3][k];
        const float qa4 = feat[kRowQA + 4][k], qa5 = feat[kRowQA + 5][k];
        const float nx = qa0 * U + 0.5f * qa1 * V + 0.5f * qa3;
        const float ny = 0.5f * qa1 * U + qa2 * V + 0.5f * qa4;
        const float nz = 0.5f * qa3 * U + 0.5f * qa4 * V + qa5;
        const float inv_len = 1.0f / sqrtf(nx * nx + ny * ny + nz * nz + 1e-7f);

        // dL/dalpha: colour, normal and background terms
        const float c_rgb = gr0 * feat[kRowRGB + 0][k] +
                            gr1 * feat[kRowRGB + 1][k] +
                            gr2 * feat[kRowRGB + 2][k];
        const float c_nn = -(gn0 * nx + gn1 * ny + gn2 * nz) * inv_len;
        float d_alpha = (c_rgb - S_rgb / T_next + c_nn - S_nn / T_next) *
                        T_before;
        d_alpha += -T_final / om * bg_dot;
        S_rgb += w * c_rgb;
        S_nn += w * c_nn;
        T = T_before;

        // distortion through m (detached weights) and depth to max_pos
        const float t_pos = fmaxf(t, 1e-6f);
        const float m = (kFar * t_pos - kFar * kNear) / ((kFar - kNear) * t_pos);
        const float d_m = 2.0f * w * (m * final_A - final_D1) * g_reg;
        float d_t = (j == maxp) ? g_depth : 0.0f;
        d_t += d_m * (kFar * kNear / (kFar - kNear)) / (t_pos * t_pos);

        // alpha = opa G, G = exp(-mv / 2), pass-through minima
        const float d_opa = d_alpha * G;
        const float d_mv = -0.5f * d_alpha * opa * G;
        // t = -BB / (2 AA_safe), mv = num / AA_safe
        const float inv_AA = 1.0f / AA_safe;
        const float d_BB = -0.5f * d_t * inv_AA;
        const float d_AA = AA > 1e-12f ? -(d_t * t + d_mv * mv) * inv_AA : 0.0f;
        const float d_num = num > 0.0f ? d_mv * inv_AA : 0.0f;

        // nn = -n / |n|, cotangent w gL_nn
        const float dn0 = w * gn0, dn1 = w * gn1, dn2 = w * gn2;
        const float k3 = inv_len * inv_len * inv_len *
                         (dn0 * nx + dn1 * ny + dn2 * nz);
        const float d_nx = -inv_len * dn0 + k3 * nx;
        const float d_ny = -inv_len * dn1 + k3 * ny;
        const float d_nz = -inv_len * dn2 + k3 * nz;

        gq[kRowQA + 0] = d_AA * UU + d_nx * U;
        gq[kRowQA + 1] = d_AA * UV + 0.5f * (d_nx * V + d_ny * U);
        gq[kRowQA + 2] = d_AA * VV + d_ny * V;
        gq[kRowQA + 3] = d_AA * U + 0.5f * (d_nx + d_nz * U);
        gq[kRowQA + 4] = d_AA * V + 0.5f * (d_ny + d_nz * V);
        gq[kRowQA + 5] = d_AA + d_nz;
        gq[kRowQK + 0] = d_num * UU;
        gq[kRowQK + 1] = d_num * UV;
        gq[kRowQK + 2] = d_num * VV;
        gq[kRowQK + 3] = d_num * U;
        gq[kRowQK + 4] = d_num * V;
        gq[kRowQK + 5] = d_num;
        gq[kRowB + 0] = 2.0f * d_BB * U;
        gq[kRowB + 1] = 2.0f * d_BB * V;
        gq[kRowB + 2] = 2.0f * d_BB;
        gq[kRowRGB + 0] = w * gr0;
        gq[kRowRGB + 1] = w * gr1;
        gq[kRowRGB + 2] = w * gr2;
        gq[kRowOpa] = d_opa;

        // densification stats through the conic (backward.cu:896-909)
        const float dL_dG = opa * d_alpha;
        const float dx = feat[kNFeat + 3][k] - (float)ix;
        const float dy = feat[kNFeat + 4][k] - (float)iy;
        const float gdx = G * dx, gdy = G * dy;
        const float ca = feat[kNFeat + 0][k], cb = feat[kNFeat + 1][k];
        const float cc = feat[kNFeat + 2][k];
        const float gx = dL_dG * (-gdx * ca - gdy * cb) * p.half_w;
        const float gy = dL_dG * (-gdy * cc - gdx * cb) * p.half_h;
        gq[kNFeat + 0] = gx;
        gq[kNFeat + 1] = gy;
        gq[kNFeat + 2] = fabsf(gx) + fabsf(gy);
      }

      const long long id = gid[k];
#pragma unroll
      for (int q = 0; q < kNGrad; ++q) {
        const float s = warp_sum(gq[q]);
        if (lane == 0) {
          if (q < kNFeat) atomicAdd(p.d_feat + id * kNFeat + q, s);
          else atomicAdd(p.d_stats + id * 3 + (q - kNFeat), s);
        }
      }
    }
  }
}

}  // namespace

// Plain C interface for ctypes.  Launches on `stream` and does not
// synchronise; returns cudaGetLastError() (0 = launched).  d_feat and
// d_stats must be zeroed: the kernel adds into them.
extern "C" int f3d_raster_bwd(
    int device, const float* allf, const float* extra, const int* point_list,
    const int* tile_start, const int* tile_count, int num_tiles, int grid_x,
    float half_w, float half_h, float focal_x, float focal_y,
    int max_per_tile, const float* bg, const float* g_out,
    const float* final_T, const float* dist1, const int* last_pos,
    const int* max_pos, float* d_feat, float* d_stats, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (num_tiles == 0) return 0;
  Params p{allf,     extra,   point_list, tile_start, tile_count,
           grid_x,   half_w,  half_h,     focal_x,    focal_y,
           max_per_tile, bg,  g_out,      final_T,    dist1,
           last_pos, max_pos, d_feat,     d_stats};
  raster_bwd_kernel<<<num_tiles, kPix, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
