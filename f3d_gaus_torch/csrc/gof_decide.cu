// GOF compositing, decision pass: the Hopper (sm_90a) kernel that decides
// every (pixel, pair) of the aligned slab once, for the compositing
// forward (raster_fwd.cu) and its backward (raster_bwd.cu) alike.
//
// Replaces the mask of the TPU kernels f3d_gaus_tpu/ops/pallas_raster.py:
// _fwd_kernel (vc at :262) and _bwd_kernel (:444), and the block maps that
// feed their grid (_block_maps).  Its plain PyTorch version is
// f3d_gaus_torch/ops/rasterize.py:_contrib_mask_impl; the wrapper is
// f3d_gaus_torch/ops/cuda_raster.py:decide.
//
// What it computes: one bit per (slab slot, pixel), set where the pair of
// the slot's Gaussian and the pixel's ray has t > 0.2 and alpha >= 1/255
// and the slot lies inside its tile's window min(tile_count, max_per_tile)
// (gof_pair.cuh).  The stop rule plays no part: it needs the
// transmittance, which the compositing pass keeps.  Bit s % 32 of word
// mask[(s / 32) * 256 + pixel] belongs to slab slot s.  Tile segments start
// at 128-aligned slab offsets, so a word never straddles two tiles, and
// consecutive pixels write consecutive words.
//
// What bounds it on this card: FP32 CUDA-core arithmetic over every pair
// of every window; the 76-byte feature rows are read once per 128-slot
// block and each pair costs 1 bit of output.  Most pairs fail
// alpha >= 1/255 by far: a per-Gaussian threshold on num / AA
// (gof_pair.cuh:surely_fails, no division) rules them out after the two
// quadratic forms, about 23 operations, and only the rest take the whole
// decision, about 41 with two IEEE divisions and an expf.  The bits stay
// those of the full decision.
//
// Design: a persistent grid of a few CTAs per SM walks the slab's 128-slot
// blocks up to the end of the last tile's window; each CTA finds a block's
// tile by a binary search over tile_start, on the device, so no host sync
// and no CTA per empty block.  The decisions spread evenly over the SMs
// whatever the heaviest tile holds.  A block's 128 rows are staged in
// shared memory padded to 20 floats (five 16-byte loads a row, a broadcast
// to the warp); each thread decides 4 pixels against 32 rows, so one row
// load serves 4 pairs, builds the 4 words in registers and stores them
// whole.

#include <cuda_runtime.h>

#include <algorithm>

#include "gof_pair.cuh"

namespace {

using namespace gof;

constexpr int kSlots = 128;               // slab slots per work item
constexpr int kWords = kSlots / 32;       // mask words per pixel and item
constexpr int kRowPad = 20;               // staged row stride, in floats
constexpr int kThreads = 256;
constexpr int kGroups = kThreads / kWords;          // 64 pixel groups
constexpr int kPixPerThread = kPix / kGroups;       // 4

struct Params {
  const float* allf;       // (P, kNFeat) feature table
  const int* point_list;   // aligned slab of Gaussian ids
  const int* tile_start;   // (T,)
  const int* tile_count;   // (T,) unclamped
  int num_tiles;
  int grid_x;
  int row_off;             // global tile row of the band's first row
  float half_w, half_h;    // the full frame's width / 2, height / 2
  float focal_x, focal_y;
  int max_per_tile;
  unsigned* mask;          // (slab / 32, kPix) words
};

__global__ void __launch_bounds__(kThreads)
gof_decide_kernel(const Params p) {
  __shared__ __align__(16) float rows[kSlots * kRowPad];
  __shared__ int ids[kSlots];
  __shared__ int s_tile;

  const int tid = threadIdx.x;
  const int word = tid / kGroups;   // warp-uniform: which 32 slots
  const int group = tid % kGroups;  // pixels group + kGroups * q
  const int last = p.num_tiles - 1;
  const int last_n = min(p.tile_count[last], p.max_per_tile);
  const int items =
      (p.tile_start[last] + (last_n + kSlots - 1) / kSlots * kSlots) / kSlots;

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int slot0 = item * kSlots;
    if (tid == 0) {
      // the last tile whose segment starts at or before slot0
      int lo = 0, hi = last;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (p.tile_start[mid] <= slot0) lo = mid;
        else hi = mid - 1;
      }
      s_tile = lo;
    }
    __syncthreads();   // s_tile is set; the previous item's rows are free
    const int tile = s_tile;
    const int j0 = slot0 - p.tile_start[tile];
    const int n = min(p.tile_count[tile], p.max_per_tile) - j0;   // valid
    if (tid < kSlots) ids[tid] = tid < n ? p.point_list[slot0 + tid] : -1;
    __syncthreads();
    for (int i = tid; i < kSlots * kRowPad; i += kThreads) {
      const int k = i / kRowPad, c = i % kRowPad;
      const int id = ids[k];
      // column 19 holds the Gaussian's reject_threshold
      const float x = id >= 0 ? p.allf[(long long)id * kNFeat +
                                       (c < kNFeat ? c : kRowOpa)] : 0.0f;
      rows[i] = c < kNFeat ? x : reject_threshold(x);
    }
    __syncthreads();

    const int tx = tile % p.grid_x, ty = tile / p.grid_x;
    float U[kPixPerThread], V[kPixPerThread];
    unsigned bits[kPixPerThread];
#pragma unroll
    for (int q = 0; q < kPixPerThread; ++q) {
      pixel_ray(tx, ty + p.row_off, group + kGroups * q, p.half_w, p.half_h,
                p.focal_x, p.focal_y, U[q], V[q]);
      bits[q] = 0u;
    }
    const int valid = min(max(n - word * 32, 0), 32);   // slots in the window
#pragma unroll 2
    for (int k = 0; k < valid; ++k) {
      const float4* r4 = reinterpret_cast<const float4*>(
          rows + (word * 32 + k) * kRowPad);
      float r[kRowPad];
#pragma unroll
      for (int c = 0; c < kRowPad / 4; ++c) {
        const float4 x = r4[c];
        r[4 * c + 0] = x.x;
        r[4 * c + 1] = x.y;
        r[4 * c + 2] = x.z;
        r[4 * c + 3] = x.w;
      }
      // the cheap test for all pixels first, the exact decision where it
      // cannot rule the pair out
      float AA[kPixPerThread], num[kPixPerThread];
      bool maybe[kPixPerThread];
#pragma unroll
      for (int q = 0; q < kPixPerThread; ++q) {
        AA[q] = quad_aa(r + kRowQA, U[q], V[q]);
        num[q] = quad_num(r + kRowQK, U[q], V[q]);
        maybe[q] = !surely_fails(AA[q], num[q], r[kNFeat]);
      }
#pragma unroll
      for (int q = 0; q < kPixPerThread; ++q)
        if (maybe[q])
          bits[q] |= (unsigned)passes(finish(r, U[q], V[q], AA[q], num[q]))
                     << k;
    }
    unsigned* out = p.mask + ((long long)item * kWords + word) * kPix + group;
#pragma unroll
    for (int q = 0; q < kPixPerThread; ++q) out[kGroups * q] = bits[q];
  }
}

}  // namespace

// Plain C interface for ctypes.  Launches on `stream` and does not
// synchronise; returns cudaGetLastError() (0 = launched).  `slab` is the
// length of point_list; mask holds slab / 32 * 256 words, of which the
// words of the blocks up to the end of the last tile's window are written.
extern "C" int f3d_gof_decide(
    int device, const float* allf, const int* point_list,
    const int* tile_start, const int* tile_count, int num_tiles, int grid_x,
    int row_off, float half_w, float half_h, float focal_x, float focal_y,
    int max_per_tile, int slab, unsigned* mask, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (num_tiles == 0 || slab < kSlots) return 0;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gof_decide_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const int grid = std::min(slab / kSlots, std::max(per_sm, 1) * sms);
  Params p{allf,    point_list, tile_start, tile_count, num_tiles,
           grid_x,  row_off,    half_w,     half_h,     focal_x,
           focal_y, max_per_tile, mask};
  gof_decide_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
