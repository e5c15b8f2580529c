// GOF tile compositing, forward: the Hopper (sm_90a) kernel of the port.
//
// Replaces the TPU kernel f3d_gaus_tpu/ops/pallas_raster.py:_fwd_kernel.
// Its plain PyTorch version is f3d_gaus_torch/ops/rasterize.py:
// _composite_fwd_impl; the wrapper is f3d_gaus_torch/ops/cuda_raster.py.
//
// What it computes: for each 16x16 pixel tile, front-to-back GOF
// compositing over the tile's depth-sorted Gaussians.  Each (pixel,
// Gaussian) pair evaluates the ray quadratic from 19 monomial coefficients
// (t = -BB/2AA, min_value = num/AA, G = exp(min(-min_value/2, 0)),
// alpha = min(0.99, opa G)); a pair contributes when t > 0.2 and
// alpha >= 1/255; the first such pair with T (1 - alpha) < 1e-4 stops the
// pixel and does not contribute.  Per pixel it accumulates RGB, the
// normalized normal -(M^T M) d, alpha, the median depth (t of the last
// contributor with T > 0.5), the last contributor's position, and the 2DGS
// distortion through the running moments D1/D2.
//
// What bounds it on this card: FP32 CUDA-core arithmetic.  Every walked
// (pixel, pair) costs about 41 FP32 operations (an FMA counts 2) to decide
// t, alpha and the stop test, and a contributing one about 64 more (normal,
// depth mapping, accumulators), against 67 TFLOP/s on an H100 SXM; the
// feature rows are 76 bytes per Gaussian and are read once per tile, so
// bytes do not bind.  chip_smoke.py counts both from the data of a run.
//
// Design, the whole of it for now: one CTA per tile, one thread per pixel.
// Threads stage a batch of up to 256 feature rows (the Gaussians at
// point_list[tile_start + j], j < min(count, max_per_tile)) into shared
// memory, then each thread walks the batch in order with scalar f32 math
// and stops at the stop rule.  A block vote (__syncthreads_count) ends the
// tile once every pixel has stopped.  The kernel reads the (P, 19)
// feature table and the aligned slab directly; nothing is gathered into a
// slab copy first.  wgmma/TMA wait for a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 16;
constexpr int kPix = kBlock * kBlock;   // threads per CTA, one per pixel
constexpr int kBatch = 256;             // feature rows staged per round
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

struct Params {
  const float* allf;       // (P, kNFeat) feature table
  const int* point_list;   // aligned slab of Gaussian ids
  const int* tile_start;   // (T,)
  const int* tile_count;   // (T,) unclamped
  int grid_x;
  float half_w, half_h;    // width / 2, height / 2
  float focal_x, focal_y;
  int max_per_tile;
  const float* bg;         // (3,) background
  float* out9;             // (T, 256, 9)
  float* final_T;          // (T, 256)
  float* dist1;
  float* dist2;
  float* raw_dist;
  int* last_pos;
  int* max_pos;
};

__global__ void __launch_bounds__(kPix)
raster_fwd_kernel(const Params p) {
  __shared__ float feat[kNFeat][kBatch];

  const int tile = blockIdx.x;
  const int pix = threadIdx.x;
  const int tx = tile % p.grid_x;
  const int ty = tile / p.grid_x;
  const float px = (float)(tx * kBlock + pix % kBlock) + 0.5f;
  const float py = (float)(ty * kBlock + pix / kBlock) + 0.5f;
  const float U = (px - p.half_w) / p.focal_x;
  const float V = (py - p.half_h) / p.focal_y;

  const int start = p.tile_start[tile];
  const int cnt = min(p.tile_count[tile], p.max_per_tile);

  float T = 1.0f;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f;
  float n0 = 0.f, n1 = 0.f, n2 = 0.f;
  float acc_a = 0.f, depth = 0.f;
  float D1 = 0.f, D2 = 0.f, dist = 0.f;
  int lastp = -1, maxp = -1;
  bool done = false;

  for (int base = 0; base < cnt; base += kBatch) {
    // block vote; also the barrier that frees the previous batch's rows
    if (__syncthreads_count(!done) == 0) break;
    const int nb = min(kBatch, cnt - base);
    if (pix < nb) {
      const float* row =
          p.allf + (long long)p.point_list[start + base + pix] * kNFeat;
#pragma unroll
      for (int k = 0; k < kNFeat; ++k) feat[k][pix] = row[k];
    }
    __syncthreads();

    for (int k = 0; k < nb && !done; ++k) {
      const float AA = (feat[kRowQA + 0][k] * U + feat[kRowQA + 1][k] * V +
                        feat[kRowQA + 3][k]) * U +
                       (feat[kRowQA + 2][k] * V + feat[kRowQA + 4][k]) * V +
                       feat[kRowQA + 5][k];
      float num = (feat[kRowQK + 0][k] * U + feat[kRowQK + 1][k] * V +
                   feat[kRowQK + 3][k]) * U +
                  (feat[kRowQK + 2][k] * V + feat[kRowQK + 4][k]) * V +
                  feat[kRowQK + 5][k];
      const float BB = 2.0f * (feat[kRowB + 0][k] * U +
                               feat[kRowB + 1][k] * V + feat[kRowB + 2][k]);
      const float AA_safe = fmaxf(AA, 1e-12f);
      num = fmaxf(num, 0.0f);
      const float t = -BB / (2.0f * AA_safe);
      if (!(t > kNear)) continue;
      const float min_value = num / AA_safe;
      const float G = expf(fminf(-0.5f * min_value, 0.0f));
      const float alpha = fminf(feat[kRowOpa][k] * G, 0.99f);
      if (!(alpha >= kAlphaEps)) continue;
      if (T * (1.0f - alpha) < kStopT) {
        done = true;
        break;
      }
      const float w = T * alpha;

      const float qa0 = feat[kRowQA + 0][k], qa1 = feat[kRowQA + 1][k];
      const float qa2 = feat[kRowQA + 2][k], qa3 = feat[kRowQA + 3][k];
      const float qa4 = feat[kRowQA + 4][k], qa5 = feat[kRowQA + 5][k];
      const float nx = qa0 * U + 0.5f * qa1 * V + 0.5f * qa3;
      const float ny = 0.5f * qa1 * U + qa2 * V + 0.5f * qa4;
      const float nz = 0.5f * qa3 * U + 0.5f * qa4 * V + qa5;
      const float inv_len = 1.0f / sqrtf(nx * nx + ny * ny + nz * nz + 1e-7f);

      c0 += w * feat[kRowRGB + 0][k];
      c1 += w * feat[kRowRGB + 1][k];
      c2 += w * feat[kRowRGB + 2][k];
      n0 += w * (-nx * inv_len);
      n1 += w * (-ny * inv_len);
      n2 += w * (-nz * inv_len);
      acc_a += w;

      const int j = base + k;
      if (T > 0.5f) {
        depth = t;
        maxp = j;
      }
      lastp = j;

      const float t_pos = fmaxf(t, 1e-6f);
      const float m = (kFar * t_pos - kFar * kNear) / ((kFar - kNear) * t_pos);
      const float mw = m * w;
      const float err = m * m * (1.0f - T) + D2 - 2.0f * m * D1;
      dist += err * w;
      D1 += mw;
      D2 += m * mw;

      T *= 1.0f - alpha;
    }
  }

  const long long o = (long long)tile * kPix + pix;
  float* out = p.out9 + o * 9;
  out[0] = c0 + T * p.bg[0];
  out[1] = c1 + T * p.bg[1];
  out[2] = c2 + T * p.bg[2];
  out[3] = n0;
  out[4] = n1;
  out[5] = n2;
  out[6] = depth;
  out[7] = acc_a;
  const float one_minus_T = 1.0f - T;
  out[8] = dist / (one_minus_T * one_minus_T + 1e-7f);
  p.final_T[o] = T;
  p.dist1[o] = D1;
  p.dist2[o] = D2;
  p.raw_dist[o] = dist;
  p.last_pos[o] = lastp;
  p.max_pos[o] = maxp;
}

}  // namespace

// Plain C interface for ctypes.  Launches on `stream` and does not
// synchronise; returns cudaGetLastError() (0 = launched).
extern "C" int f3d_raster_fwd(
    int device, const float* allf, const int* point_list,
    const int* tile_start, const int* tile_count, int num_tiles, int grid_x,
    float half_w, float half_h, float focal_x, float focal_y,
    int max_per_tile, const float* bg, float* out9,
    float* final_T, float* dist1, float* dist2, float* raw_dist,
    int* last_pos, int* max_pos, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (num_tiles == 0) return 0;
  Params p{allf,               point_list, tile_start, tile_count,
           grid_x,   half_w,   half_h,     focal_x,    focal_y,
           max_per_tile, bg,   out9,
           final_T,  dist1,    dist2,      raw_dist,   last_pos,
           max_pos};
  raster_fwd_kernel<<<num_tiles, kPix, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
