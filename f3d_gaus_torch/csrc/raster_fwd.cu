// GOF tile compositing, forward: the Hopper (sm_90a) compositing pass.
//
// Replaces, together with the decision pass gof_decide.cu, the TPU kernel
// f3d_gaus_tpu/ops/pallas_raster.py:_fwd_kernel.  Its plain PyTorch
// version is f3d_gaus_torch/ops/rasterize.py:_composite_fwd_impl given the
// decision mask; the wrapper is f3d_gaus_torch/ops/cuda_raster.py:
// composite_fwd, which launches the decision pass and then this kernel.
//
// What it computes: for each pixel, front-to-back GOF compositing over the
// pairs of its tile's window whose decision bit is set (gof_decide.cu:
// t > 0.2 and alpha >= 1/255).  The first such pair with
// T (1 - alpha) < 1e-4 stops the pixel and does not contribute.  Per pixel
// it accumulates RGB, the normalized normal -(M^T M) d, alpha, the median
// depth (t of the last contributor with T > 0.5), the last contributor's
// position, and the 2DGS distortion through the running moments D1/D2.  A
// pair that fails the decision changes no state, and the pairs that pass
// are composited in the same order with the same f32 operations as a walk
// over every pair would, so the mask changes nothing in the result.
//
// What bounds it on this card: the contributors' FP32 arithmetic (about 64
// operations each, on top of the recomputed decision) and the mask words,
// 4 bytes per 32 slots and pixel; chip_smoke.py counts both from the data
// of a run.  In practice the longest serial chain sets the time: a pixel
// composites its contributors one after another, so the heaviest tile's
// warps must not also wait on memory for each contributor.
//
// Design: one thread per pixel, 64 pixels (a quarter tile) per CTA, so a
// heavy tile's warps spread over four SMs.  The CTA walks its tile's window
// in batches of 128 slots: the batch's feature rows are staged in shared
// memory, padded to 20 floats (five 16-byte loads a row), while the next
// batch's rows, ids and mask words are already on their way into
// registers (a two-stage pipeline, so no contributor waits on global
// memory).  Each thread then walks its own set bits in slot order -- a
// lane's loop is as long as its own contributors, not the warp's union --
// recomputes each pair with gof_pair.cuh's code and composites it, two
// pairs at a time so that the second's quadratic overlaps the first's
// compositing.  The bit is the decision: t and alpha are not tested again.
// A block vote (__syncthreads_count) ends the walk once every pixel has
// stopped.

#include <cuda_runtime.h>

#include "gof_pair.cuh"

namespace {

using namespace gof;

constexpr int kThreads = 64;   // pixels per CTA; a tile is 4 CTAs
constexpr int kSlots = 128;    // slots per staged batch
constexpr int kWords = kSlots / 32;
constexpr int kRowsPerThread = kSlots / kThreads;
constexpr int kRowPad = 20;    // staged row stride, in floats

struct Params {
  const float* allf;       // (P, kNFeat) feature table
  const int* point_list;   // aligned slab of Gaussian ids
  const int* tile_start;   // (T,)
  const int* tile_count;   // (T,) unclamped
  const unsigned* mask;    // (slab / 32, kPix) decision words
  int grid_x;
  int row_off;             // global tile row of the band's first row
  float half_w, half_h;    // the full frame's width / 2, height / 2
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

// One batch's worth of prefetched inputs, held in registers: the rows this
// thread stages and the pixel's mask words.
struct Prefetch {
  float rows[kRowsPerThread][kNFeat];
  unsigned words[kWords];
};

__device__ __forceinline__ void prefetch(const Params& p, int start, int n,
                                         int base, const unsigned* words,
                                         int tid, Prefetch& f) {
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int k = base + tid + i * kThreads;
    const float* row =
        p.allf + (long long)(k < n ? __ldg(p.point_list + start + k) : 0) *
                     kNFeat;
#pragma unroll
    for (int c = 0; c < kNFeat; ++c)
      f.rows[i][c] = k < n ? __ldg(row + c) : 0.f;
  }
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const int word = base / 32 + w;
    f.words[w] = word * 32 < n
                     ? __ldg(words + (long long)word * kPix)
                     : 0u;
  }
}

// The row of slot k of a staged batch.
__device__ __forceinline__ void load_row(const float* batch, int k,
                                         float (&r)[kRowPad]) {
  const float4* r4 = reinterpret_cast<const float4*>(batch + k * kRowPad);
#pragma unroll
  for (int c = 0; c < kRowPad / 4; ++c) {
    const float4 x = r4[c];
    r[4 * c + 0] = x.x;
    r[4 * c + 1] = x.y;
    r[4 * c + 2] = x.z;
    r[4 * c + 3] = x.w;
  }
}

// A pixel's running compositing state.  The sums are written with explicit
// rounding intrinsics in the FMA pattern nvcc chose for the plain
// expressions (gof_pair.cuh), so the result does not depend on how the
// calls are inlined.
struct Accum {
  float T = 1.0f;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f;
  float n0 = 0.f, n1 = 0.f, n2 = 0.f;
  float acc_a = 0.f, depth = 0.f;
  float D1 = 0.f, D2 = 0.f, dist = 0.f;
  int lastp = -1, maxp = -1;

  // Composites the pair at window position j (its decision bit set, its
  // depth mapping m); false when the pair stops the pixel instead.
  __device__ __forceinline__ bool add(const Pair& e, const Normal& nn,
                                      float m, const float* r, int j) {
    const float T_next = __fmul_rn(T, 1.0f - e.alpha);
    if (T_next < kStopT) return false;
    const float w = __fmul_rn(T, e.alpha);
    c0 = __fmaf_rn(w, r[kRowRGB + 0], c0);
    c1 = __fmaf_rn(w, r[kRowRGB + 1], c1);
    c2 = __fmaf_rn(w, r[kRowRGB + 2], c2);
    n0 = __fmaf_rn(w, -__fmul_rn(nn.nx, nn.inv_len), n0);
    n1 = __fmaf_rn(w, -__fmul_rn(nn.ny, nn.inv_len), n1);
    n2 = __fmaf_rn(w, -__fmul_rn(nn.nz, nn.inv_len), n2);
    acc_a = __fadd_rn(acc_a, w);
    if (T > 0.5f) {
      depth = e.t;
      maxp = j;
    }
    lastp = j;
    // 2DGS distortion: err = m^2 (1 - T) + D2 - 2 m D1
    const float mw = __fmul_rn(w, m);
    const float err = __fmaf_rn(
        D1, __fmul_rn(m, -2.0f),
        __fmaf_rn(__fmul_rn(m, m), __fadd_rn(1.0f, -T), D2));
    dist = __fmaf_rn(w, err, dist);
    D1 = __fadd_rn(D1, mw);
    D2 = __fmaf_rn(mw, m, D2);
    T = T_next;
    return true;
  }
};

__global__ void __launch_bounds__(kThreads)
raster_fwd_kernel(const Params p) {
  __shared__ __align__(16) float rows[2][kSlots * kRowPad];

  const int tid = threadIdx.x;
  const int gpix = blockIdx.x * kThreads + tid;
  const int tile = gpix / kPix;
  const int pix = gpix % kPix;
  float U, V;
  pixel_ray(tile % p.grid_x, tile / p.grid_x + p.row_off, pix, p.half_w,
            p.half_h, p.focal_x, p.focal_y, U, V);

  const int start = p.tile_start[tile];
  const int n = min(p.tile_count[tile], p.max_per_tile);
  // the pixel's mask word w of the window
  const unsigned* pix_words = p.mask + (long long)(start / 32) * kPix + pix;

  Accum a;
  bool done = false;
  Prefetch next;
  prefetch(p, start, n, 0, pix_words, tid, next);
  unsigned words[kWords];
  for (int base = 0, buf = 0; base < n; base += kSlots, buf ^= 1) {
    // stage the prefetched batch; the barrier of the vote below makes it
    // visible, and the vote before it freed this buffer
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      float* dst = rows[buf] + (tid + i * kThreads) * kRowPad;
#pragma unroll
      for (int c = 0; c < kNFeat; ++c) dst[c] = next.rows[i][c];
    }
#pragma unroll
    for (int w = 0; w < kWords; ++w) words[w] = next.words[w];
    if (__syncthreads_count(!done) == 0) break;
    if (base + kSlots < n)
      prefetch(p, start, n, base + kSlots, pix_words, tid, next);

    // the pixel's own set bits in slot order, two at a time: the second
    // pair's quadratic, normal and depth mapping do not depend on the
    // transmittance, so they overlap the first's
    const float* batch = rows[buf];
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      unsigned bits = done ? 0u : words[w];
      while (bits != 0u) {
        const int b1 = __ffs(bits) - 1;
        bits &= bits - 1u;
        const bool two = bits != 0u;
        const int b2 = two ? __ffs(bits) - 1 : b1;
        bits &= bits - 1u;
        float r1[kRowPad], r2[kRowPad];
        load_row(batch, w * 32 + b1, r1);
        load_row(batch, w * 32 + b2, r2);
        const Pair e1 = eval(r1, U, V), e2 = eval(r2, U, V);
        const Normal q1 = normal(r1, U, V), q2 = normal(r2, U, V);
        const float m1 = depth_m(fmaxf(e1.t, 1e-6f));
        const float m2 = depth_m(fmaxf(e2.t, 1e-6f));
        if (!a.add(e1, q1, m1, r1, base + w * 32 + b1) ||
            (two && !a.add(e2, q2, m2, r2, base + w * 32 + b2))) {
          done = true;
          break;
        }
      }
    }
  }

  const long long o = (long long)tile * kPix + pix;
  float* out = p.out9 + o * 9;
  out[0] = a.c0 + a.T * p.bg[0];
  out[1] = a.c1 + a.T * p.bg[1];
  out[2] = a.c2 + a.T * p.bg[2];
  out[3] = a.n0;
  out[4] = a.n1;
  out[5] = a.n2;
  out[6] = a.depth;
  out[7] = a.acc_a;
  const float one_minus_T = 1.0f - a.T;
  out[8] = a.dist / (one_minus_T * one_minus_T + 1e-7f);
  p.final_T[o] = a.T;
  p.dist1[o] = a.D1;
  p.dist2[o] = a.D2;
  p.raw_dist[o] = a.dist;
  p.last_pos[o] = a.lastp;
  p.max_pos[o] = a.maxp;
}

}  // namespace

// Plain C interface for ctypes.  Launches on `stream` and does not
// synchronise; returns cudaGetLastError() (0 = launched).  `mask` is the
// decision pass's output for the same table and slab (f3d_gof_decide).
extern "C" int f3d_raster_fwd(
    int device, const float* allf, const int* point_list,
    const int* tile_start, const int* tile_count, const unsigned* mask,
    int num_tiles, int grid_x, int row_off, float half_w, float half_h,
    float focal_x, float focal_y, int max_per_tile, const float* bg,
    float* out9, float* final_T, float* dist1, float* dist2, float* raw_dist,
    int* last_pos, int* max_pos, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (num_tiles == 0) return 0;
  Params p{allf,     point_list, tile_start, tile_count, mask,
           grid_x,   row_off,    half_w,     half_h,     focal_x,
           focal_y,  max_per_tile, bg,     out9,       final_T,    dist1,
           dist2,    raw_dist,   last_pos,   max_pos};
  raster_fwd_kernel<<<num_tiles * kPix / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
