// GOF tile compositing, backward: the Hopper (sm_90a) backward pass.
//
// Replaces, together with the decision pass gof_decide.cu, the TPU kernel
// f3d_gaus_tpu/ops/pallas_raster.py:_bwd_kernel and the segment_sum of its
// caller _cff_bwd.  Its plain PyTorch version is
// f3d_gaus_torch/ops/rasterize.py:_composite_bwd_impl given the decision
// mask (the pull-back written out formula by formula, and held against
// autograd, is tests/test_torch_rasterize_grad.py:chunk_eval_vjp); the
// wrapper is f3d_gaus_torch/ops/cuda_raster.py:composite_bwd, which
// launches the decision pass again on the forward's table and slab and
// then this kernel.
//
// What it computes: the gradient of the forward (raster_fwd.cu) with
// respect to the (P, 19) feature table, plus the (P, 3) densification
// statistics, from the cotangent g_out (T, 256, 9) of out9 and the
// forward's residuals (final_T, dist1, last_pos, max_pos).  A pixel's
// contributors are exactly the set decision bits up to its last_pos (the
// stopping pair lies after it), so the backward finds the forward's
// contributors by running the same decision code.  Each pixel walks them
// back to front, as the CUDA reference does (backward.cu:738-953):
//   * T before each contributor is rebuilt from final_T by division by
//     1 - alpha (alpha <= 0.99, so the divisor is >= 0.01; the stop rule
//     keeps every T >= 1e-4, so nothing underflows);
//   * the suffix sums of w (gL_rgb . c) and w (gL_nn . nn) accumulate from
//     zero; dL/dalpha adds the background term -T_final/(1-alpha) bg.gL_rgb;
//   * the distortion gradient goes through m with detached weights, the
//     depth gradient to the median contributor (max_pos) only, the alpha
//     channel (7) takes none;
//   * the pull-back through the ray quadratic to the 19 monomial rows
//     (the clamps max(AA, 1e-12) and max(num, 0) pass the whole gradient
//     above their bound, half at it and nothing below, as jnp.maximum
//     does in the JAX package's _forms; num is exactly 0 often, on a
//     Gaussian's own pixel ray; the pass-through minima at 0 and 0.99 pass
//     everything, the normal's sqrt(.+1e-7) normalisation, the 1e-6 floor
//     of t in m);
//   * the stats |dL/dmean2d| through the conic, |gx| + |gy| per pixel.
//
// What bounds it on this card: the contributors' FP32 arithmetic (about
// 181 operations each on top of the recomputed decision) and the
// reduction of their 22 gradients over the pixels.  The bytes (the 24
// columns per Gaussian, the mask words, the per-pixel residuals, the
// read-modify-write of the touched (P, 22) rows) are far below it.
//
// Design: one thread per pixel, 128 pixels (half a tile) per CTA.  The CTA
// walks the slots from its largest last_pos down to 0 in ranges of 128.  A
// range's 24 columns per Gaussian are staged in shared memory (six 16-byte
// loads a row) while the next range's rows and mask words are already on
// their way into registers.  In a range each warp iterates, back to front,
// over the OR of its lanes' mask words (bits above a lane's last_pos
// cleared), so all 32 lanes visit the same Gaussian at once; lanes whose
// bit is set compute its 22 values, the others zeros.  A transpose-style
// reduction (each of 5 shuffle steps halves both the lanes and the values,
// 31 shuffles in all) leaves value q on lane q, which adds it to the
// range's shared-memory row of that Gaussian.  After the range the CTA
// issues one global atomicAdd per touched (Gaussian, column).  The atomics
// make the summation order, and so the last bits, vary from launch to
// launch.

#include <cuda_runtime.h>

#include "gof_pair.cuh"

namespace {

using namespace gof;

constexpr int kThreads = 128;           // pixels per CTA; a tile is 2 CTAs
constexpr int kRange = 128;             // slots per staged range
constexpr int kWords = kRange / 32;
constexpr int kNExtra = 5;              // conic (3) | means2d (2)
constexpr int kCols = kNFeat + kNExtra; // staged columns, 6 x 16 bytes
constexpr int kNGrad = kNFeat + 3;      // feature gradients | stats

// The cotangent g of max(x, lo) pulled back to x as jnp.maximum does: g
// above the bound, g / 2 at it, 0 below (whatever g is).
__device__ __forceinline__ float max_pullback(float x, float lo, float g) {
  return x > lo ? g : (x == lo ? 0.5f * g : 0.0f);
}

struct Params {
  const float* allf;       // (P, kNFeat) feature table
  const float* extra;      // (P, kNExtra) conic | means2d
  const int* point_list;   // aligned slab of Gaussian ids
  const int* tile_start;   // (T,)
  const int* tile_count;   // (T,) unclamped
  const unsigned* mask;    // (slab / 32, kPix) decision words
  int grid_x;
  int row_off;             // global tile row of the band's first row
  float half_w, half_h;    // the full frame's width / 2, height / 2
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

// One step of transpose_sum: a lane keeps the half of its 2H values
// selected by lane bit H and adds the partner's copy of that half.
template <int H>
__device__ __forceinline__ void transpose_step(float (&v)[32], int lane) {
  const bool upper = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, H);
  }
}

// Sums v[q] over the warp's lanes for q < 32 and returns sum q on lane q.
__device__ __forceinline__ float transpose_sum(float (&v)[32], int lane) {
  transpose_step<16>(v, lane);
  transpose_step<8>(v, lane);
  transpose_step<4>(v, lane);
  transpose_step<2>(v, lane);
  transpose_step<1>(v, lane);
  return v[0];
}

// One range's worth of prefetched inputs, held in registers: the row this
// thread stages (its id, 19 feature and 5 extra columns) and the pixel's
// mask words.
struct Prefetch {
  int id;
  float row[kCols];
  unsigned words[kWords];
};

__device__ __forceinline__ void prefetch(const Params& p, int start, int last,
                                         int base, const unsigned* words,
                                         int tid, Prefetch& f) {
  const int k = base + tid;
  f.id = k <= last ? __ldg(p.point_list + start + k) : -1;
  const long long id = f.id < 0 ? 0 : f.id;
#pragma unroll
  for (int c = 0; c < kNFeat; ++c)
    f.row[c] = f.id >= 0 ? __ldg(p.allf + id * kNFeat + c) : 0.f;
#pragma unroll
  for (int c = 0; c < kNExtra; ++c)
    f.row[kNFeat + c] = f.id >= 0 ? __ldg(p.extra + id * kNExtra + c) : 0.f;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const int word = base / 32 + w;
    f.words[w] = word * 32 <= last
                     ? __ldg(words + (long long)word * kPix)
                     : 0u;
  }
}

__global__ void __launch_bounds__(kThreads)
raster_bwd_kernel(const Params p) {
  __shared__ __align__(16) float rows[kRange * kCols];
  __shared__ float acc[kRange * kNGrad];
  __shared__ int ids[kRange];
  __shared__ int touched[kRange];
  __shared__ int cta_last;

  const int tid = threadIdx.x;
  const int gpix = blockIdx.x * kThreads + tid;
  const int tile = gpix / kPix;
  const int pix = gpix % kPix;
  const int lane = tid & 31;
  const int tx = tile % p.grid_x;
  const int ty = tile / p.grid_x + p.row_off;   // the global tile row
  const int ix = tx * kBlock + pix % kBlock;
  const int iy = ty * kBlock + pix / kBlock;
  float U, V;
  pixel_ray(tx, ty, pix, p.half_w, p.half_h, p.focal_x, p.focal_y, U, V);
  const float UU = U * U, UV = U * V, VV = V * V;

  const long long o = (long long)tile * kPix + pix;
  const int start = p.tile_start[tile];
  const int n = min(p.tile_count[tile], p.max_per_tile);
  const int lastp = min(p.last_pos[o], n - 1);
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
  // the pixel's mask word w of the window
  const unsigned* pix_words = p.mask + (long long)(start / 32) * kPix + pix;

  // the warp's and the CTA's largest last contributor bound the walk
  if (tid == 0) cta_last = -1;
  __syncthreads();
  int warp_last = lastp;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    warp_last = max(warp_last, __shfl_xor_sync(kFull, warp_last, s));
  if (lane == 0) atomicMax(&cta_last, warp_last);
  __syncthreads();
  const int last = cta_last;

  float T = T_final;
  float S_rgb = 0.f, S_nn = 0.f;   // suffix sums of w (gL . c), w (gL . nn)

  Prefetch next;
  int base = last >= 0 ? (last / kRange) * kRange : -1;
  if (base >= 0) prefetch(p, start, last, base, pix_words, tid, next);
  for (; base >= 0; base -= kRange) {
    __syncthreads();   // the previous range is flushed
    unsigned words[kWords];
    {
      float* dst = rows + tid * kCols;
#pragma unroll
      for (int c = 0; c < kCols; ++c) dst[c] = next.row[c];
      ids[tid] = next.id;
      touched[tid] = 0;
#pragma unroll
      for (int w = 0; w < kWords; ++w) words[w] = next.words[w];
    }
    for (int i = tid; i < kRange * kNGrad; i += kThreads) acc[i] = 0.f;
    __syncthreads();
    if (base >= kRange)
      prefetch(p, start, last, base - kRange, pix_words, tid, next);

#pragma unroll
    for (int w = kWords - 1; w >= 0; --w) {
      const int word = base / 32 + w;
      if (32 * word > warp_last) continue;   // warp-uniform
      unsigned mine = 0u;
      const int below = lastp - 32 * word;   // bits of this word up to lastp
      if (below >= 0) mine = below < 31 ? words[w] & ((2u << below) - 1u)
                                        : words[w];
      unsigned todo = __reduce_or_sync(kFull, mine);
      while (todo != 0u) {
        const int b = 31 - __clz(todo);
        todo &= ~(1u << b);
        const int k = w * 32 + b;
        const int j = base + k;
        float r[kCols];
        const float4* r4 = reinterpret_cast<const float4*>(rows + k * kCols);
#pragma unroll
        for (int c = 0; c < kCols / 4; ++c) {
          const float4 x = r4[c];
          r[4 * c + 0] = x.x;
          r[4 * c + 1] = x.y;
          r[4 * c + 2] = x.z;
          r[4 * c + 3] = x.w;
        }
        const float* ex = r + kNFeat;

        float gq[32];
#pragma unroll
        for (int q = 0; q < 32; ++q) gq[q] = 0.f;
        if ((mine >> b) & 1u) {
          const Pair e = eval(r, U, V);
          const float alpha = e.alpha, t = e.t, G = e.G, mv = e.mv;
          const float opa = r[kRowOpa];
          const float om = 1.0f - alpha;
          const float T_before = T / om;
          const float T_next = T_before * om;
          const float w8 = T_before * alpha;
          const Normal nn = normal(r, U, V);
          const float nx = nn.nx, ny = nn.ny, nz = nn.nz;
          const float inv_len = nn.inv_len;

          // dL/dalpha: colour, normal and background terms
          const float c_rgb = gr0 * r[kRowRGB + 0] + gr1 * r[kRowRGB + 1] +
                              gr2 * r[kRowRGB + 2];
          const float c_nn = -(gn0 * nx + gn1 * ny + gn2 * nz) * inv_len;
          float d_alpha = (c_rgb - S_rgb / T_next + c_nn - S_nn / T_next) *
                          T_before;
          d_alpha += -T_final / om * bg_dot;
          S_rgb += w8 * c_rgb;
          S_nn += w8 * c_nn;
          T = T_before;

          // distortion through m (detached weights) and depth to max_pos
          const float t_pos = fmaxf(t, 1e-6f);
          const float m = depth_m(t_pos);
          const float d_m = 2.0f * w8 * (m * final_A - final_D1) * g_reg;
          float d_t = (j == maxp) ? g_depth : 0.0f;
          d_t += d_m * (kFar * kNear / (kFar - kNear)) / (t_pos * t_pos);

          // alpha = opa G, G = exp(-mv / 2), pass-through minima
          const float d_opa = d_alpha * G;
          const float d_mv = -0.5f * d_alpha * opa * G;
          // t = -BB / (2 AA_safe), mv = num / AA_safe
          const float inv_AA = 1.0f / e.AA_safe;
          const float d_BB = -0.5f * d_t * inv_AA;
          // through the clamps max(AA, 1e-12) and max(num, 0)
          const float d_AA =
              max_pullback(e.AA, 1e-12f, -(d_t * t + d_mv * mv) * inv_AA);
          const float d_num = max_pullback(e.num, 0.0f, d_mv * inv_AA);

          // nn = -n / |n|, cotangent w gL_nn
          const float dn0 = w8 * gn0, dn1 = w8 * gn1, dn2 = w8 * gn2;
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
          gq[kRowRGB + 0] = w8 * gr0;
          gq[kRowRGB + 1] = w8 * gr1;
          gq[kRowRGB + 2] = w8 * gr2;
          gq[kRowOpa] = d_opa;

          // densification stats through the conic (backward.cu:896-909)
          const float dL_dG = opa * d_alpha;
          const float dx = ex[3] - (float)ix;
          const float dy = ex[4] - (float)iy;
          const float gdx = G * dx, gdy = G * dy;
          const float gx = dL_dG * (-gdx * ex[0] - gdy * ex[1]) * p.half_w;
          const float gy = dL_dG * (-gdy * ex[2] - gdx * ex[1]) * p.half_h;
          gq[kNFeat + 0] = gx;
          gq[kNFeat + 1] = gy;
          gq[kNFeat + 2] = fabsf(gx) + fabsf(gy);
        }

        const float s = transpose_sum(gq, lane);
        if (lane < kNGrad) atomicAdd(&acc[k * kNGrad + lane], s);
        if (lane == 0) touched[k] = 1;
      }
    }

    __syncthreads();
    for (int i = tid; i < kRange * kNGrad; i += kThreads) {
      const int k = i / kNGrad, q = i % kNGrad;
      if (!touched[k]) continue;
      const long long id = ids[k];
      if (q < kNFeat) atomicAdd(p.d_feat + id * kNFeat + q, acc[i]);
      else atomicAdd(p.d_stats + id * 3 + (q - kNFeat), acc[i]);
    }
  }
}

}  // namespace

// Plain C interface for ctypes.  Launches on `stream` and does not
// synchronise; returns cudaGetLastError() (0 = launched).  `mask` is the
// decision pass's output for the forward's table and slab
// (f3d_gof_decide); d_feat and d_stats must be zeroed: the kernel adds
// into them.
extern "C" int f3d_raster_bwd(
    int device, const float* allf, const float* extra, const int* point_list,
    const int* tile_start, const int* tile_count, const unsigned* mask,
    int num_tiles, int grid_x, int row_off, float half_w, float half_h,
    float focal_x, float focal_y, int max_per_tile, const float* bg,
    const float* g_out,
    const float* final_T, const float* dist1, const int* last_pos,
    const int* max_pos, float* d_feat, float* d_stats, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (num_tiles == 0) return 0;
  Params p{allf,     extra,   point_list, tile_start, tile_count, mask,
           grid_x,   row_off, half_w,     half_h,     focal_x,
           focal_y,  max_per_tile, bg,  g_out,      final_T,    dist1,
           last_pos, max_pos, d_feat,     d_stats};
  raster_bwd_kernel<<<num_tiles * kPix / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
