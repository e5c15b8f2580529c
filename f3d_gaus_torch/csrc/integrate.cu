// Opacity-field query ("integrate"): the Hopper (sm_90a) kernel of the mesh
// path's field, one view at a time.
//
// Replaces f3d_gaus_tpu/ops/integrate.py:_point_alpha_product (:82) and the
// window walk of _integrate_chunk (:104), which the JAX package leaves to
// XLA (there is no Pallas kernel for it); in the CUDA reference it is
// integrateCUDA.  Its plain PyTorch version is
// f3d_gaus_torch/ops/integrate.py:_alpha_impl; the wrapper is
// f3d_gaus_torch/ops/cuda_raster.py:integrate, and the plain versions of
// its preparation and item plan are ops/integrate.py:_pack_rows,
// _point_keys and _integrate_items.
//
// What it computes: for each query point, the product T of (1 - alpha)
// over the Gaussians of its tile's window min(tile_count, max_per_tile),
// alpha = min(0.99, opa exp(-val / 2)) evaluated on the point's own ray at
// t_c = min(t_peak, point depth), pairs with alpha < 1/255 skipped; then
// out = 1 - T, or out = min(out, 1 - T) for the view sweep's running
// minimum.
//
// What bounds it on this card: FP32 issue slots.  Most (point, pair)s
// cannot reach 1/255 (93 % at the mesh run's frontal view), yet the first
// design gave each the whole evaluation: a correctly rounded division, an
// accurate expf, the clamps.  Bytes are small: a 64-byte row per Gaussian
// of a window, staged once per 512 points.
//
// Design:
//  * A division-free, exp-free rejection, the field's analogue of
//    gof_pair.cuh:surely_fails.  With a = M (u, v, 1) (the f32 value the
//    full evaluation uses) and b the row's, val(t) = |t a + b|^2 >=
//    min_t val = |a x b|^2 / |a|^2 in exact arithmetic, so |a x b|^2 >
//    |a|^2 thr, thr = 2 ln(255 opa) plus gof_pair.cuh:reject_threshold's
//    margins, means the pair fails.  By Lagrange's identity |a x b|^2 =
//    |a|^2 |b|^2 - (a.b)^2, so the test is Q = |a|^2 (|b|^2 - thr_row) -
//    (a.b)^2 > 0 with |b|^2 - thr_row packed per row: a and a.b are the
//    full evaluation's own first steps, and Q costs one product and one
//    FMA more.  The margin, folded into thr_row = thr + kappa |b|^2 with
//    kappa = 4e-6 (67 eps, eps = 2^-24): Q's f32 rounding is within about
//    15 eps |a|^2 (|b|^2 + thr_row), so Q_f32 > 0 means |a x b|^2 / |a|^2
//    exceeds thr + 51 eps |b|^2 less 15 eps thr; the f32 val of the
//    surviving evaluation lies below the exact val by at most about
//    51 eps |b| sqrt(thr) + 28 eps^2 |b|^2 (the rounding of g = t_c a + b;
//    |t_c a| <= |b| on both branches of the clamp, sqrt(thr) <= 3.4), and
//    thr's absolute margin 2e-3 with 51 eps |b|^2 covers that fifty times
//    over (2e-3 + 51 eps |b|^2 >= 2 sqrt(2e-3 51 eps) |b| = 1.6e-4 |b|).
//    A pair that survives is evaluated exactly as before (the same
//    expressions, division and expf, in window order), and a rejected one
//    multiplies T by 1 as a failing one did, so wherever a window is not
//    split the field is bit for bit the first design's.  Rejecting costs
//    26 operations (a 12, |a|^2 5, a.b 5, Q 3, the compare), the full
//    evaluation 43; a pair that fails 1/255 but escapes the rejection
//    needs only its quadratic and a compare (37) to be known to fail.
//    integrate.py:_pair_rejected is the rejection's f32 mirror, and
//    chip_smoke.py counts from the data which pairs are which.
//  * Each thread holds 4 points (register blocking: one staged row serves
//    4 pairs), takes the rejection of all 4 at once, so that the four
//    chains interleave, and branches to the full evaluation only where a
//    lane keeps a pair.  The lanes of a warp take that branch together;
//    the points are sorted by tile and, inside a tile, in Morton order of
//    their rays (prep_kernel's keys), so that a warp's 32 points lie
//    within a few pixels and mostly agree.
//  * Rows are packed once per view (prep_kernel) into a (P + 1, 16) f32
//    table (M 9, b 3, opa, |b|^2 - thr_row, padding) and staged with
//    cp.async 16-byte copies, four per row, into a double buffer, so the
//    gather of batch k + 1 overlaps the arithmetic of batch k.  TMA cannot
//    gather rows by index; cp.async is the copy engine for a gather.  Row
//    P, which an id outside [0, P) reads, is a sentinel of opacity 0 and
//    threshold -inf with a = (1, 1, 1) for every ray, so the rejection
//    rules out each of its pairs (with a = 0 its test would be 0 inf =
//    NaN, which is not > 0).
//  * Items: one CTA of 128 threads takes one (segment, block of 512
//    points, window slice) item.  A window of n rows is cut into slices of
//    max(slice_len, ceil(n / max_slices)) rows, so that the items are
//    many enough to fill the card's waves and a long window is spread over
//    several CTAs, while a view keeps at most max_slices partial products
//    per point; each slice of a split window writes its partial products,
//    and a second small kernel multiplies them in slice order and applies
//    the running minimum (no atomics on the field: the same result on
//    every launch).  The plan is computed on the card (plan_kernel) and the
//    grid is persistent, each CTA taking the next item from one counter,
//    so the launch needs no host sync and no CTA carries a tail of heavy
//    items.
//  * No tensor cores: the field is an f32 product held at 2e-5 against the
//    plain version, with a clamp that depends on each point's depth;
//    TF32 or bf16 monomials would break that.

// Three entry points: f3d_integrate_prep (the row table and the points'
// sort keys in one launch, in place of the dozens of small PyTorch
// operations that would otherwise cost the host more than the card), then,
// after the wrapper's torch.sort of the keys, f3d_integrate (the plan, the
// field and the second pass).

#include "gof_pair.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 4;    // points per thread: a staged row serves 4
constexpr int kItemPoints = kThreads * kPerThread;   // points per item
constexpr int kBatch = 128;      // window rows staged per step
constexpr int kRow = 16;         // floats per packed row
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kKappa = 4e-6f;      // integrate.py:REJECT_KAPPA
constexpr float kKeyRange = 2.0f;    // integrate.py:KEY_RANGE

struct Params {
  const float* rows;        // (P + 1, 16): M, b, opa, |b|^2 - thr_row, 0, 0
  const int* point_list;    // slab of Gaussian ids, P = padding
  const int* tile_start;    // (T,)
  const int* tile_count;    // (T,) unclamped
  int num_tiles;
  int num_gaussians;        // P
  int max_per_tile;
  int slice_len;            // least window rows per item
  int max_slices;           // most slices per window
  const long long* perm;    // (Q,) sorted position -> point
  const int* seg_start;     // (T + 2,) first sorted position of segment s
  const int* item_start;    // (T + 2,) first item of segment s
  const int* part_start;    // (T + 2,) first partial product of segment s
  const float* u;           // (Q,) ray (u, v, 1)
  const float* v;
  const float* depth;       // (Q,) view depth
  float* part;              // partial products of split windows
  float* out;               // (Q,)
  int running_min;          // 0: out = 1 - T; 1: out = min(out, 1 - T)
  int* next_item;           // the items' counter, zeroed by the plan
};

// the rows of each slice of a window of n rows: slice_len, or more where
// that would cut the window into more than max_slices slices
__device__ __forceinline__ int slice_rows(int n, int slice_len,
                                          int max_slices) {
  return max(slice_len, (n + max_slices - 1) / max_slices);
}

__device__ __forceinline__ int num_slices(int n, int slice_len,
                                          int max_slices) {
  const int len = slice_rows(n, slice_len, max_slices);
  return max(1, (n + len - 1) / len);
}

// the last segment s with starts[s] <= x (segments that own nothing share
// their start with the next and are passed over)
__device__ __forceinline__ int find_segment(const int* starts, int nseg,
                                            int x) {
  int lo = 0, hi = nseg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (starts[mid] <= x) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr int kPlanThreads = 1024;   // 32 warps: one scan level each

// The item plan of integrate.py:_integrate_items from the sorted keys, by
// one CTA: segment starts by binary search (a key's segment is key >>
// shift), then per segment its blocks of kItemPoints points, its window
// slices and its partial products, and their exclusive prefix sums.
__global__ void __launch_bounds__(kPlanThreads) plan_kernel(
    const int* __restrict__ keys, int num_points, int shift,
    const int* __restrict__ tile_count, int num_tiles, int max_per_tile,
    int slice_len, int max_slices, int* seg_start, int* item_start,
    int* part_start, int* next_item) {
  __shared__ int sums[2][32];
  if (threadIdx.x == 0) *next_item = 0;
  const int nseg = num_tiles + 1;
  for (int s = threadIdx.x; s <= nseg; s += kPlanThreads) {
    int lo = 0, hi = num_points;   // first position whose segment >= s
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if ((keys[mid] >> shift) < s) lo = mid + 1;
      else hi = mid;
    }
    seg_start[s] = lo;
  }
  __syncthreads();
  // each thread takes a contiguous run of segments
  const int per = (nseg + kPlanThreads - 1) / kPlanThreads;
  const int s0 = min(nseg, threadIdx.x * per), s1 = min(nseg, s0 + per);
  int items = 0, parts = 0;
  for (int s = s0; s < s1; ++s) {
    const int n_pts = seg_start[s + 1] - seg_start[s];
    const int window = s < num_tiles ? min(tile_count[s], max_per_tile) : 0;
    const int slices = num_slices(window, slice_len, max_slices);
    items += (n_pts + kItemPoints - 1) / kItemPoints * slices;
    parts += slices > 1 ? slices * n_pts : 0;
  }
  // exclusive scan of the runs' totals: within each warp by shuffles,
  // then over the warps' totals
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc_i = items, inc_p = parts;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int yi = __shfl_up_sync(0xffffffffu, inc_i, d);
    const int yp = __shfl_up_sync(0xffffffffu, inc_p, d);
    if (lane >= d) {
      inc_i += yi;
      inc_p += yp;
    }
  }
  if (lane == 31) {
    sums[0][warp] = inc_i;
    sums[1][warp] = inc_p;
  }
  __syncthreads();
  if (warp == 0) {
    int wi = sums[0][lane], wp = sums[1][lane];   // kPlanThreads / 32 == 32
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int yi = __shfl_up_sync(0xffffffffu, wi, d);
      const int yp = __shfl_up_sync(0xffffffffu, wp, d);
      if (lane >= d) {
        wi += yi;
        wp += yp;
      }
    }
    sums[0][lane] = wi;   // inclusive over the warps
    sums[1][lane] = wp;
    if (lane == 31) {
      item_start[nseg] = wi;
      part_start[nseg] = wp;
    }
  }
  __syncthreads();
  items = inc_i - items + (warp ? sums[0][warp - 1] : 0);
  parts = inc_p - parts + (warp ? sums[1][warp - 1] : 0);
  for (int s = s0; s < s1; ++s) {
    item_start[s] = items;
    part_start[s] = parts;
    const int n_pts = seg_start[s + 1] - seg_start[s];
    const int window = s < num_tiles ? min(tile_count[s], max_per_tile) : 0;
    const int slices = num_slices(window, slice_len, max_slices);
    items += (n_pts + kItemPoints - 1) / kItemPoints * slices;
    parts += slices > 1 ? slices * n_pts : 0;
  }
}

// rows [r0, r0 + nb) of the window that starts at slab slot `start`, four
// 16-byte copies each, neighbouring threads on neighbouring quarters
__device__ __forceinline__ void stage(const Params& p, float* dst, int start,
                                      int r0, int nb) {
  for (int c = threadIdx.x; c < nb * 4; c += kThreads) {
    const int r = c >> 2, q = c & 3;
    int id = p.point_list[start + r0 + r];
    if (id < 0 || id > p.num_gaussians) id = p.num_gaussians;
    cp_async16(dst + r * kRow + q * 4, p.rows + (long long)id * kRow + q * 4);
  }
  cp_async_commit();
}

// The rejection: true where |a|^2 (|b|^2 - thr_row) - (a.b)^2 > 0, that is
// |a x b|^2 > |a|^2 thr_row, which implies the pair's alpha < 1/255 (the
// header's argument); r[13] holds |b|^2 - thr_row.  `a` is computed by the
// expressions of pair_factor, so both see the same f32 ray.
__device__ __forceinline__ bool surely_fails(const float* r, float U,
                                             float V) {
  const float a0 = r[0] * U + r[1] * V + r[2];
  const float a1 = r[3] * U + r[4] * V + r[5];
  const float a2 = r[6] * U + r[7] * V + r[8];
  const float AA = a0 * a0 + a1 * a1 + a2 * a2;
  const float ab = a0 * r[9] + a1 * r[10] + a2 * r[11];
  return __fmaf_rn(AA, r[13], -__fmul_rn(ab, ab)) > 0.0f;
}

// 1 - alpha of one (point, Gaussian) pair, or 1 where the pair is skipped:
// the first design's expressions, which follow
// integrate.py:_point_alpha_product
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

// The rows of one staged batch against this thread's first E points: the
// rejection for all E first (independent, so the card interleaves them),
// then the full evaluation of the pairs that survive, in row order.
template <int E>
__device__ __forceinline__ void walk(const float* rb, int nb, const float* U,
                                     const float* V, const float* D,
                                     float* T) {
#pragma unroll 1
  for (int j = 0; j < nb; ++j) {
    const float4* r4 = reinterpret_cast<const float4*>(rb + j * kRow);
    float r[kRow];
#pragma unroll
    for (int c = 0; c < kRow / 4; ++c) {
      const float4 x = r4[c];
      r[4 * c + 0] = x.x;
      r[4 * c + 1] = x.y;
      r[4 * c + 2] = x.z;
      r[4 * c + 3] = x.w;
    }
    bool keep[E];
    bool any = false;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      keep[e] = !surely_fails(r, U[e], V[e]);
      any |= keep[e];
    }
    if (any) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (keep[e]) T[e] *= pair_factor(r, U[e], V[e], D[e]);
    }
  }
}

__device__ __forceinline__ float finish(float prev, float T, int running_min) {
  const float alpha = 1.0f - T;
  return running_min ? fminf(prev, alpha) : alpha;
}

__global__ void __launch_bounds__(kThreads) integrate_kernel(const Params p) {
  __shared__ __align__(16) float rows[2][kBatch * kRow];
  __shared__ int next;

  const int nseg = p.num_tiles + 1;
  const int n_items = p.item_start[nseg];
  for (;;) {
    // items are taken in order from one counter: a CTA that finishes
    // early takes the next, so no CTA carries a tail of heavy items
    if (threadIdx.x == 0) next = atomicAdd(p.next_item, 1);
    __syncthreads();
    const int item = next;
    if (item >= n_items) break;
    const int seg = find_segment(p.item_start, nseg, item);
    const int s0 = p.seg_start[seg];
    const int n_pts = p.seg_start[seg + 1] - s0;
    const int n_blocks = (n_pts + kItemPoints - 1) / kItemPoints;
    const int n_slices = (p.item_start[seg + 1] - p.item_start[seg]) /
                         n_blocks;
    const int local = item - p.item_start[seg];
    const int block = local % n_blocks, slice = local / n_blocks;
    // point e of this thread: block position e kThreads + threadIdx.x; a
    // warp whose first lane has no point skips that position
    int k[kPerThread];
    long long q[kPerThread];
    float U[kPerThread], V[kPerThread], D[kPerThread], T[kPerThread];
    const int first = block * kItemPoints + (threadIdx.x & ~31);
    const int n_live = min(kPerThread, max(0, (n_pts - first + kThreads - 1) /
                                                  kThreads));
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      k[e] = block * kItemPoints + e * kThreads + threadIdx.x;
      const bool live = k[e] < n_pts;
      q[e] = live ? p.perm[s0 + k[e]] : 0;
      U[e] = live ? p.u[q[e]] : 0.0f;
      V[e] = live ? p.v[q[e]] : 0.0f;
      D[e] = live ? p.depth[q[e]] : 0.0f;
      T[e] = 1.0f;
    }

    const bool tile = seg < p.num_tiles;   // else the outside segment
    const int n = tile ? min(p.tile_count[seg], p.max_per_tile) : 0;
    const int start = tile ? p.tile_start[seg] : 0;
    const int len = slice_rows(n, p.slice_len, p.max_slices);
    const int r_lo = slice * len;
    const int r_hi = min(n, r_lo + len);
    __syncthreads();   // the previous item's rows are free
    if (r_lo < r_hi) stage(p, rows[0], start, r_lo, min(kBatch, r_hi - r_lo));
    for (int b0 = r_lo, buf = 0; b0 < r_hi; b0 += kBatch, buf ^= 1) {
      const int nb = min(kBatch, r_hi - b0);
      if (b0 + kBatch < r_hi) {
        // the other buffer was last read before the previous barrier
        stage(p, rows[buf ^ 1], start, b0 + kBatch,
              min(kBatch, r_hi - b0 - kBatch));
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      switch (n_live) {   // warp-uniform: the positions this warp holds
        case 4: walk<4>(rows[buf], nb, U, V, D, T); break;
        case 3: walk<3>(rows[buf], nb, U, V, D, T); break;
        case 2: walk<2>(rows[buf], nb, U, V, D, T); break;
        case 1: walk<1>(rows[buf], nb, U, V, D, T); break;
        default: break;
      }
      __syncthreads();   // this buffer is free for the batch after next
    }
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      if (k[e] >= n_pts) continue;
      if (n_slices == 1) p.out[q[e]] = finish(p.out[q[e]], T[e], p.running_min);
      else p.part[p.part_start[seg] + slice * n_pts + k[e]] = T[e];
    }
  }
}

// The split windows' second pass: each point of a segment with more than
// one slice multiplies its partial products in slice order.
__global__ void __launch_bounds__(256) combine_kernel(const Params p,
                                                      int num_points) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= num_points) return;
  const int nseg = p.num_tiles + 1;
  const int seg = find_segment(p.seg_start, nseg, i);
  const int s0 = p.seg_start[seg];
  const int n_pts = p.seg_start[seg + 1] - s0;
  const int n_blocks = (n_pts + kItemPoints - 1) / kItemPoints;
  const int n_slices = (p.item_start[seg + 1] - p.item_start[seg]) / n_blocks;
  if (n_slices == 1) return;
  const float* part = p.part + p.part_start[seg] + (i - s0);
  float T = 1.0f;
  for (int s = 0; s < n_slices; ++s) T *= part[(long long)s * n_pts];
  const int q = p.perm[i];
  p.out[q] = finish(p.out[q], T, p.running_min);
}

// The preparation: thread i <= P writes row i of the (P + 1, 16) table:
// M (9), b (3), opa, |b|^2 - thr_row with thr_row =
// gof_pair.cuh:reject_threshold(opa) + kappa |b|^2, 0, 0; row P is the
// sentinel (the header).  Thread i < Q writes point i's key: its segment
// (its tile if inside, else T) above a Morton code of its ray (u, v), each
// quantised to 2^key_bits levels over [-2, 2).  Bound by bytes (a row
// written per Gaussian, a key per point); trivial beside the field.
__device__ __forceinline__ unsigned spread_bits(unsigned x) {
  x &= 0xffffu;
  x = (x | (x << 8)) & 0x00ff00ffu;
  x = (x | (x << 4)) & 0x0f0f0f0fu;
  x = (x | (x << 2)) & 0x33333333u;
  x = (x | (x << 1)) & 0x55555555u;
  return x;
}

__device__ __forceinline__ unsigned quantise(float x, int bits) {
  const float levels = (float)(1 << bits);
  const float q = floorf(__fmul_rn(__fadd_rn(x, kKeyRange),
                                   levels / (2.0f * kKeyRange)));
  return (unsigned)fminf(fmaxf(q, 0.0f), levels - 1.0f);
}

__global__ void prep_kernel(const float* __restrict__ mb,
                            const float* __restrict__ opa, int num_gaussians,
                            const float* __restrict__ u,
                            const float* __restrict__ v,
                            const int* __restrict__ tile,
                            const unsigned char* __restrict__ inside,
                            int num_points, int num_tiles, int key_bits,
                            float* __restrict__ rows, int* __restrict__ keys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i <= num_gaussians) {
    float r[16];
    if (i < num_gaussians) {
      const float* m = mb + (long long)i * 12;
#pragma unroll
      for (int c = 0; c < 12; ++c) r[c] = m[c];
      r[12] = opa[i];
      const float b2 = __fadd_rn(__fadd_rn(__fmul_rn(r[9], r[9]),
                                           __fmul_rn(r[10], r[10])),
                                 __fmul_rn(r[11], r[11]));
      const float thr = __fadd_rn(gof::reject_threshold(r[12]),
                                  __fmul_rn(kKappa, b2));
      r[13] = __fsub_rn(b2, thr);
    } else {   // the sentinel: a = (1, 1, 1), opacity 0, threshold -inf
#pragma unroll
      for (int c = 0; c < 13; ++c)
        r[c] = (c == 2 || c == 5 || c == 8) ? 1.0f : 0.0f;
      r[13] = __int_as_float(0x7f800000);   // +inf
    }
    r[14] = r[15] = 0.0f;
    float4* dst = reinterpret_cast<float4*>(rows + (long long)i * 16);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      dst[c] = make_float4(r[4 * c], r[4 * c + 1], r[4 * c + 2], r[4 * c + 3]);
  }
  if (i < num_points) {
    int key = num_tiles << (2 * key_bits);
    if (inside[i]) {
      key = (tile[i] << (2 * key_bits)) |
            (int)(spread_bits(quantise(u[i], key_bits)) |
                  (spread_bits(quantise(v[i], key_bits)) << 1));
    }
    keys[i] = key;
  }
}

}  // namespace

// Plain C interface for ctypes.  Each launches on `stream` and does not
// synchronise; returns cudaGetLastError() (0 = launched).
extern "C" int f3d_integrate_prep(
    int device, const float* mb, const float* opa, int num_gaussians,
    const float* u, const float* v, const int* tile,
    const unsigned char* inside, int num_points, int num_tiles, int key_bits,
    float* rows, int* keys, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n = num_gaussians + 1 > num_points ? num_gaussians + 1
                                               : num_points;
  prep_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      mb, opa, num_gaussians, u, v, tile, inside, num_points, num_tiles,
      key_bits, rows, keys);
  return (int)cudaGetLastError();
}

// Three kernels:
// the plan (from the points' sorted keys and their order `perm`, into
// `plan`, 3 (T + 2) + 1 ints: segment, item and partial-product starts
// and the items' counter), the
// field over the items, and the split windows' second pass.  `max_items`
// is an upper bound on the items; the persistent grid is the smaller of it
// and the CTAs the card holds at once.
extern "C" int f3d_integrate(
    int device, const float* rows, const int* point_list,
    const int* tile_start, const int* tile_count, int num_tiles,
    int num_gaussians, int max_per_tile, int slice_len, int max_slices,
    const int* keys, const long long* perm, int key_shift, int* plan,
    const float* u,
    const float* v, const float* depth, float* part, float* out,
    int running_min, int num_points, int max_items, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (max_items <= 0 || num_points <= 0) return 0;
  const int nplan = num_tiles + 2;
  int* seg_start = plan;
  int* item_start = plan + nplan;
  int* part_start = plan + 2 * nplan;
  int* next_item = plan + 3 * nplan;
  plan_kernel<<<1, kPlanThreads, 0, (cudaStream_t)stream>>>(
      keys, num_points, key_shift, tile_count, num_tiles, max_per_tile,
      slice_len, max_slices, seg_start, item_start, part_start, next_item);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, integrate_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(max_items < resident ? max_items : resident);
  Params p{rows,       point_list, tile_start,    tile_count,
           num_tiles,  num_gaussians, max_per_tile, slice_len, max_slices,
           perm,       seg_start,  item_start,    part_start,
           u,          v,          depth,         part,
           out,        running_min, next_item};
  integrate_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<<<(num_points + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      p, num_points);
  return (int)cudaGetLastError();
}
