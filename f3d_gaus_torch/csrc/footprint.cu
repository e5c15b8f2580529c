// What binning a render stage needs, counted without binning: the Hopper
// (sm_90a) kernel of the stage cap planner.
//
// Replaces no TPU kernel: the JAX package has no planner (its caps are
// static).  The port plans each render stage's caps from the stage's own
// footprints (pipeline/cycle.py:stage_caps, per_scene.needed_caps).  Its
// plain PyTorch version, f3d_gaus_torch/ops/binning.py:_footprint_need_impl
// (core/gaussians.py:screen_footprints, binning.tile_rects and
// binning.tile_occupancy, four million footprints a step), is about 420
// kernel launches a step and 8,062 at the serving orbit's 19 steps, and the
// host that issues them one at a time set the pace of the plan.  The wrapper is
// f3d_gaus_torch/ops/cuda_raster.py:footprint_need, which binning.
// footprint_need takes for CUDA tensors.
//
// What it computes, for B batch elements of P Gaussians at V cameras of one
// size: each (element, view, Gaussian) footprint as the preprocess gives it
// (screen.cuh, the code preprocess.cu runs, so bit for bit), its tile
// rectangle as binning.tile_rects gives it, and per (element, view) the
// pairs (the rectangles' tiles summed, int64) and the tile occupancy
// (tile_occupancy's difference grid: +-1 at the rectangle's four corners of
// a (grid_y + 1) x (grid_x + 1) grid, then summed along both axes).  A
// second, small launch sums each grid and writes the most pairs and the
// fullest tile over every (element, view): two int64, which the wrapper
// reads.  Every count is an integer sum, exact in any order.
//
// What bounds it on this card: the corner atomics and the launch.  The
// serving orbit's 129 views x 589,824 Gaussians are 76 M footprints of
// about 150 f32 operations (11 GFLOP, 0.2 ms at 67 TFLOP/s) over 24 MB of
// Gaussians.  Design: one thread holds kPer Gaussians (mean and cov3d, which
// no view changes, in registers) and walks a group of views whose cameras
// and difference grids sit in shared memory; the corners are shared-memory
// integer atomics, each view's pairs a warp sum and one shared atomic a
// warp; a block flushes its grids and sums to device memory once, with one
// integer atomic a nonzero cell.  The group is as many views as kGroupBytes
// of shared memory holds (36 at 256^2), and the Gaussians are cut into
// about kBlocksPerSM blocks an SM over the groups and elements, so the
// flush stays small against the footprints.

#include <cuda_runtime.h>

#include <algorithm>

#include "screen.cuh"

namespace {

using namespace screen;

constexpr int kThreads = 256;
constexpr int kPer = 2;                // Gaussians a thread holds at once
constexpr int kBlock = 16;             // binning.BLOCK
constexpr int kGroupBytes = 48 * 1024; // shared memory a block's views take
constexpr int kBlocksPerSM = 4;
constexpr int kSumThreads = 128;

typedef unsigned long long u64;

struct Plan {
  const float* means;      // (B, P, 3)
  const float* scales;     // (B, P, 3)
  const float* quats;      // (B, P, 4)
  const float* cameras;    // (V, kCameraFloats)
  int num;                 // P
  int views;               // V
  int group;               // views a block
  int per_block;           // Gaussians a block
  int grid_x, grid_y;      // tiles
  u64* pairs;              // (B, V)
  int* occ;                // (B, V, (grid_y + 1) (grid_x + 1))
};

// binning.tile_rects: r = radii.float(),
// min = clamp(floor((m - r) / 16), 0, grid),
// max = clamp(floor((((m + r) + 16) - 1) / 16), 0, grid), each .to(int32);
// torch.clamp keeps NaN, whose int32 is 0
struct Rect {
  int xmin, ymin, xmax, ymax, count;
};
__device__ __forceinline__ int tile_lo(float m, float r, int grid) {
  const float b = static_cast<float>(kBlock);
  return (int)min_of(max_of(floorf(dvd(sub(m, r), b)), 0.0f), (float)grid);
}
__device__ __forceinline__ int tile_hi(float m, float r, int grid) {
  const float b = static_cast<float>(kBlock);
  return (int)min_of(max_of(floorf(dvd(sub(add(add(m, r), b), 1.0f), b)),
                            0.0f),
                     (float)grid);
}
__device__ __forceinline__ Rect tile_rect(float x, float y, int radius,
                                          int grid_x, int grid_y) {
  const float r = (float)radius;
  Rect q;
  q.xmin = tile_lo(x, r, grid_x);
  q.ymin = tile_lo(y, r, grid_y);
  q.xmax = tile_hi(x, r, grid_x);
  q.ymax = tile_hi(y, r, grid_y);
  q.count = radius > 0 ? max(q.xmax - q.xmin, 0) * max(q.ymax - q.ymin, 0)
                       : 0;
  return q;
}

__global__ void __launch_bounds__(kThreads, 2) footprint_kernel(Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = p.grid_x + 1;
  const int cells = W * (p.grid_y + 1);
  const int v0 = blockIdx.y * p.group;
  const int nv = min(p.group, p.views - v0);
  const int b = blockIdx.z;
  u64* s_pairs = reinterpret_cast<u64*>(smem);
  Camera* s_cam = reinterpret_cast<Camera*>(s_pairs + p.group);
  int* s_occ = reinterpret_cast<int*>(s_cam + p.group);

  const float* src = p.cameras + (size_t)v0 * kCameraFloats;
  float* dst = reinterpret_cast<float*>(s_cam);
  for (int k = threadIdx.x; k < nv * kCameraFloats; k += kThreads)
    dst[k] = src[k];
  for (int k = threadIdx.x; k < nv; k += kThreads) s_pairs[k] = 0;
  for (int k = threadIdx.x; k < nv * cells; k += kThreads) s_occ[k] = 0;
  __syncthreads();

  const size_t elem = (size_t)b * p.num;
  const int start = blockIdx.x * p.per_block;
  const int end = min(p.num, start + p.per_block);
  for (int i0 = start; i0 < end; i0 += kThreads * kPer) {
    float m[kPer][3], cov[kPer][6];
    bool live[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = i0 + k * kThreads + threadIdx.x;
      live[k] = i < end;
      if (live[k]) {
        const size_t g = elem + i;
        const float* mean = p.means + 3 * g;
        const float* s = p.scales + 3 * g;
        const float* q = p.quats + 4 * g;
        m[k][0] = mean[0];
        m[k][1] = mean[1];
        m[k][2] = mean[2];
        float R[9];
        rotmat(q[0], q[1], q[2], q[3], R);
        // screen_footprints' scale modifier, 1
        cov3d(R, s[0], s[1], s[2], 1.0f, cov[k]);
      }
    }
    for (int v = 0; v < nv; ++v) {
      const Camera& c = s_cam[v];
      int* occ = s_occ + v * cells;
      int n = 0;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (!live[k]) continue;
        // screen_footprints: radii 0 where not valid
        const Projected pj = project(c, m[k][0], m[k][1], m[k][2]);
        const Extent ex = extent(cov2d(c, pj.pv, cov[k]), c.kernel_size);
        const bool valid = pj.pv[2] > kNear && ex.det != 0.0f;
        const Rect q = tile_rect(ndc_to_pix(pj.ndc0, c.width),
                                 ndc_to_pix(pj.ndc1, c.height),
                                 valid ? (int)ex.radius : 0, p.grid_x,
                                 p.grid_y);
        if (q.count > 0) {
          n += q.count;
          atomicAdd(occ + q.ymin * W + q.xmin, 1);
          atomicAdd(occ + q.ymin * W + q.xmax, -1);
          atomicAdd(occ + q.ymax * W + q.xmin, -1);
          atomicAdd(occ + q.ymax * W + q.xmax, 1);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        n += __shfl_xor_sync(0xffffffffu, n, off);
      if ((threadIdx.x & 31) == 0 && n != 0)
        atomicAdd(s_pairs + v, (u64)n);
    }
  }
  __syncthreads();

  int* occ = p.occ + ((size_t)b * p.views + v0) * cells;
  for (int k = threadIdx.x; k < nv * cells; k += kThreads) {
    const int d = s_occ[k];
    if (d != 0) atomicAdd(occ + k, d);
  }
  for (int k = threadIdx.x; k < nv; k += kThreads)
    if (s_pairs[k] != 0)
      atomicAdd(p.pairs + (size_t)b * p.views + v0 + k, s_pairs[k]);
}

// One block an (element, view): tile_occupancy's two cumsums of the
// difference grid, the fullest of its grid_y x grid_x tiles, and the most
// pairs and the fullest tile over every (element, view) into out[0], out[1]
// (both counts are >= 0, so the maxima start at the zeroed out).
__global__ void __launch_bounds__(kSumThreads)
occupancy_kernel(const u64* pairs, int* occ_all, int grid_x, int grid_y,
                 u64* out) {
  __shared__ int s_best[kSumThreads / 32];
  const int W = grid_x + 1, H = grid_y + 1;
  int* occ = occ_all + (size_t)blockIdx.x * W * H;
  for (int x = threadIdx.x; x < W; x += kSumThreads) {   // cumsum(-2)
    int run = 0;
    for (int y = 0; y < H; ++y) {
      run += occ[y * W + x];
      occ[y * W + x] = run;
    }
  }
  __syncthreads();
  int best = 0;
  for (int y = threadIdx.x; y < grid_y; y += kSumThreads) {   // cumsum(-1)
    int run = 0;
    for (int x = 0; x < grid_x; ++x) {
      run += occ[y * W + x];
      best = max(best, run);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    best = max(best, __shfl_xor_sync(0xffffffffu, best, off));
  if ((threadIdx.x & 31) == 0) s_best[threadIdx.x / 32] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kSumThreads / 32; ++w) best = max(best, s_best[w]);
    atomicMax(out + 1, (u64)best);
    atomicMax(out, pairs[blockIdx.x]);
  }
}

}  // namespace

// Shared memory one view takes in footprint_kernel: its pair sum, its
// camera and its difference grid.
static size_t view_bytes(int grid_x, int grid_y) {
  return sizeof(u64) + sizeof(Camera) +
         sizeof(int) * (size_t)(grid_x + 1) * (grid_y + 1);
}

// The two launches over `batch` x `num` Gaussians at the `views` camera rows
// of cuda_raster.camera_rows (device memory).  `scratch` holds
// 2 + batch * views int64 and then batch * views difference grids of
// (grid_y + 1) (grid_x + 1) int32; it is zeroed here.  On return (once the
// stream has run) scratch[0] is the most pairs and scratch[1] the fullest
// tile of any (element, view).  cudaErrorInvalidValue where one view's grid
// does not fit in a block's shared memory.
extern "C" int f3d_footprint_need(int device, const float* means,
                                  const float* scales, const float* quats,
                                  int batch, int num, const float* cameras,
                                  int views, int grid_x, int grid_y,
                                  long long* scratch, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int max_smem = 0, sms = 0;
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const size_t per_view = view_bytes(grid_x, grid_y);
  if (batch <= 0 || views <= 0 || per_view > (size_t)max_smem)
    return (int)cudaErrorInvalidValue;
  const size_t pairs = (size_t)batch * views;
  const size_t cells = (size_t)(grid_x + 1) * (grid_y + 1);
  cudaStream_t s = (cudaStream_t)stream;
  err = cudaMemsetAsync(scratch, 0,
                        sizeof(long long) * (2 + pairs) + sizeof(int) *
                        pairs * cells, s);
  if (err != cudaSuccess) return (int)err;
  u64* out = reinterpret_cast<u64*>(scratch);
  int* occ = reinterpret_cast<int*>(scratch + 2 + pairs);

  if (num > 0) {
    const int group = (int)std::max<size_t>(
        1, std::min<size_t>(views, kGroupBytes / per_view));
    const size_t smem = group * per_view;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(footprint_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    const int groups = (views + group - 1) / group;
    const int slices = std::max(1, kBlocksPerSM * sms / (groups * batch));
    int per_block = (num + slices - 1) / slices;
    per_block = (per_block + kThreads - 1) / kThreads * kThreads;
    Plan p{means, scales, quats, cameras, num, views, group, per_block,
           grid_x, grid_y, out + 2, occ};
    const dim3 grid((num + per_block - 1) / per_block, groups, batch);
    footprint_kernel<<<grid, kThreads, smem, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  occupancy_kernel<<<(unsigned)pairs, kSumThreads, 0, s>>>(
      out + 2, occ, grid_x, grid_y, out);
  return (int)cudaGetLastError();
}
