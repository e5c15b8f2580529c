"""Tile binning into the aligned slab (counterpart of
f3d_gaus_tpu/ops/binning.py, same `Binning` contract).

  * The P Gaussians are depth-sorted once: the key is the bitcast int32 of
    max(depth, 0) with culled Gaussians at +inf, and a stable sort breaks
    ties by id.
  * Pairs are expanded in that depth order into `pair_cap` slots; each slot
    finds its Gaussian by a binary search over the inclusive pair offsets,
    so the expansion needs no host sync.
  * A stable sort of the slot tiles groups the pairs by tile.  Slots are
    already depth-ordered, so this is the reference's 64-bit
    `tile << 32 | depth` key order.
  * Each tile's segment lands at an `align`-multiple offset of the slab;
    gaps hold the sentinel id P.  With `max_per_tile`, pairs past the first
    `max_per_tile` of a tile become sentinel padding, while `tile_count`
    stays unclamped so callers can see the truncation.

Everything here is order/selection logic on integer and float keys; it
never needs a gradient.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import gaussians as G
from ..utils import profiling
from . import cuda_raster

BLOCK = 16
ALIGN = 128           # default slab alignment
# the largest int32: the JAX package's sort key of an invalid pair.  Here a
# slot past the pairs sorts as tile `num_tiles` instead, so the name marks
# the int32 limit where words are read back as signed (rasterize.py).
INT32_MAX = 2147483647


class Binning(NamedTuple):
    # point_list is the ALIGNED SLAB: size pair_cap + num_tiles*align;
    # tile t's pairs occupy [tile_start[t], tile_start[t] + tile_count[t]),
    # depth-sorted; tile_start[t] % align == 0; padding slots hold the
    # sentinel id P (== number of Gaussians).
    point_list: torch.Tensor    # (slab_cap,) int32 Gaussian ids, P = padding
    pair_valid: torch.Tensor    # (slab_cap,) bool — point_list < P
    tile_start: torch.Tensor    # (num_tiles,) int32, multiples of align
    tile_count: torch.Tensor    # (num_tiles,) int32 (UNclamped true count)
    num_pairs: torch.Tensor     # () int32 — pairs kept (<= pair_cap)
    overflow: torch.Tensor      # () bool — true if pair_cap was insufficient
    grid: tuple                 # (grid_x, grid_y)


def slab_cap(pair_cap: int, width: int, height: int, align: int = ALIGN) -> int:
    """Size of the aligned slab for a given pair capacity + image."""
    grid_x = (width + BLOCK - 1) // BLOCK
    grid_y = (height + BLOCK - 1) // BLOCK
    return pair_cap + grid_x * grid_y * align


def tile_rects(means2d: torch.Tensor, radii: torch.Tensor, width: int,
               height: int):
    """Vectorized getRect (auxiliary.h:64-74): (xmin, ymin, xmax, ymax,
    count) int32; radii <= 0 yields count 0."""
    grid_x = (width + BLOCK - 1) // BLOCK
    grid_y = (height + BLOCK - 1) // BLOCK
    r = radii.float()
    x, y = means2d[..., 0], means2d[..., 1]
    i32 = torch.int32
    xmin = torch.clamp(torch.floor((x - r) / BLOCK), 0, grid_x).to(i32)
    ymin = torch.clamp(torch.floor((y - r) / BLOCK), 0, grid_y).to(i32)
    xmax = torch.clamp(torch.floor((x + r + BLOCK - 1) / BLOCK), 0, grid_x).to(i32)
    ymax = torch.clamp(torch.floor((y + r + BLOCK - 1) / BLOCK), 0, grid_y).to(i32)
    count = torch.clamp_min(xmax - xmin, 0) * torch.clamp_min(ymax - ymin, 0)
    count = torch.where(radii > 0, count, torch.zeros_like(count))
    return xmin, ymin, xmax, ymax, count


def _sortable_depth_key(depths: torch.Tensor, radii: torch.Tensor):
    """Monotone int32 key for non-negative f32 depths (culled -> +inf)."""
    dk = torch.where(radii > 0, torch.clamp_min(depths.float(), 0.0),
                     torch.full_like(depths, float("inf"), dtype=torch.float32))
    return dk.contiguous().view(torch.int32)


@profiling.spanned("binning")
def bin_gaussians(means2d: torch.Tensor, radii: torch.Tensor,
                  depths: torch.Tensor, width: int, height: int,
                  pair_cap: int, max_per_tile: int | None = None,
                  align: int = ALIGN) -> Binning:
    """Build the aligned per-tile depth-sorted Gaussian slab.

    means2d: (P, 2) pixel coords; radii: (P,) int32 (0 = culled); depths:
    (P,) view z.  max_per_tile: pairs past the first max_per_tile of a tile
    are dropped from the slab (tile_count stays unclamped).  While tracing
    is on (utils.profiling) the call is span `binning` and counts the
    slots it walks (`binning.slots`, pair_cap) and the pairs it bins
    (`binning.pairs`, num_pairs, summed on the device only when read)."""
    means2d, radii, depths = means2d.detach(), radii.detach(), depths.detach()
    dev = means2d.device
    i32, i64 = torch.int32, torch.int64
    grid_x = (width + BLOCK - 1) // BLOCK
    grid_y = (height + BLOCK - 1) // BLOCK
    num_tiles = grid_x * grid_y
    P = means2d.shape[0]
    NPAD = pair_cap + num_tiles * align

    # depth-rank order; the stable sort breaks equal keys by id
    _, perm = torch.sort(_sortable_depth_key(depths, radii), stable=True)
    xmin, ymin, xmax, ymax, count = tile_rects(means2d[perm], radii[perm],
                                               width, height)
    offsets = torch.cumsum(count.to(i64), 0)             # inclusive
    total = offsets[-1] if P > 0 else torch.zeros((), dtype=i64, device=dev)
    overflow = total > pair_cap

    # slot -> owning Gaussian (in depth order): the segment whose inclusive
    # offset first exceeds the slot; slots past `total` are invalid
    slots = torch.arange(pair_cap, dtype=i64, device=dev)
    pair_valid = slots < total
    rank = torch.searchsorted(offsets, slots, right=True).clamp_max(max(P - 1, 0))
    start = offsets[rank] - count[rank]
    rect_w = torch.clamp_min(xmax - xmin, 1).to(i64)[rank]
    base_tile = (ymin.to(i64) * grid_x + xmin)[rank]
    delta = slots - start
    tile = base_tile + delta % rect_w + (delta // rect_w) * grid_x
    tile = torch.where(pair_valid, tile, torch.full_like(tile, num_tiles))

    tile_s, order = torch.sort(tile, stable=True)
    gid_s = perm.to(i64)[rank[order]]
    bounds = torch.searchsorted(
        tile_s, torch.arange(num_tiles + 1, dtype=i64, device=dev))
    tile_start_c = bounds[:-1]
    tile_count = bounds[1:] - bounds[:-1]

    # aligned slab placement: tile t's segment starts at a multiple of align
    keep = torch.clamp_max(tile_count, pair_cap if max_per_tile is None
                           else max_per_tile)
    csz = ((keep + align - 1) // align) * align
    aligned_start = torch.cumsum(csz, 0) - csz
    valid_s = tile_s < num_tiles
    t_own = tile_s.clamp_max(num_tiles - 1)
    within = slots - tile_start_c[t_own]
    pos = aligned_start[t_own] + within
    keep_pair = valid_s if max_per_tile is None else valid_s & (within < max_per_tile)
    pos = torch.where(keep_pair, pos, torch.full_like(pos, NPAD))
    slab = torch.full((NPAD + 1,), P, dtype=i32, device=dev)
    slab[pos] = gid_s.to(i32)
    slab = slab[:NPAD]

    num_pairs = torch.clamp_max(total, pair_cap).to(i32)
    profiling.count("binning.slots", pair_cap)
    profiling.count("binning.pairs", num_pairs)
    return Binning(point_list=slab, pair_valid=slab < P,
                   tile_start=aligned_start.to(i32),
                   tile_count=tile_count.to(i32), num_pairs=num_pairs,
                   overflow=overflow, grid=(grid_x, grid_y))


def count_pairs(means2d, radii, width: int, height: int) -> torch.Tensor:
    """Exact number of (Gaussian, tile) pairs — sizes pair_cap."""
    *_, count = tile_rects(means2d.detach(), radii.detach(), width, height)
    return torch.sum(count.to(torch.int64))


def tile_occupancy(means2d, radii, width: int, height: int) -> torch.Tensor:
    """(..., num_tiles) int32: how many Gaussians each tile holds, the
    tile_count bin_gaussians would return, without binning; means2d
    (..., P, 2) and radii (..., P), any leading dims (one set per view).
    Each Gaussian's tile rectangle is added to a (grid_y + 1, grid_x + 1)
    difference grid by its four corners, then summed along both axes."""
    grid_x = (width + BLOCK - 1) // BLOCK
    grid_y = (height + BLOCK - 1) // BLOCK
    lead = radii.shape[:-1]
    xmin, ymin, xmax, ymax, count = tile_rects(means2d.detach(),
                                               radii.detach(), width, height)
    w = (count > 0).to(torch.int32).reshape(-1)
    cells = (grid_y + 1) * (grid_x + 1)
    views = torch.arange(lead.numel(), device=radii.device)
    base = (views * cells).reshape(*lead, 1)
    diff = torch.zeros(views.numel() * cells, dtype=torch.int32,
                       device=radii.device)
    for ys, xs, sign in ((ymin, xmin, 1), (ymin, xmax, -1), (ymax, xmin, -1),
                         (ymax, xmax, 1)):
        diff.index_add_(0, (base + ys * (grid_x + 1) + xs).reshape(-1),
                        sign * w)
    occ = diff.reshape(*lead, grid_y + 1, grid_x + 1).cumsum(-2).cumsum(-1)
    return occ[..., :grid_y, :grid_x].reshape(*lead, -1).to(torch.int32)


PLAN_CHUNK = 1 << 22      # (view, Gaussian) footprints per plain planning step


@torch.no_grad()
def footprint_need(xyz, scaling, rotation, world_views, full_projs, camera,
                   kernel_size: float = 0.0, tangents=None) -> dict:
    """What binning (B, P) Gaussians at the (V, 4, 4) world_views /
    full_projs needs, exactly: {'pairs': the most (Gaussian, tile) pairs
    of any (batch element, view), 'tile': the fullest tile's Gaussians of
    any}; `camera` gives the size all V share and, unless `tangents`
    gives each view's (tan_fovx, tan_fovy), the field of view.  Counted
    from the footprints preprocess gives, with no binning and one host
    read: for CUDA tensors in one launch of csrc/footprint.cu and its
    reduction (cuda_raster.footprint_need, counted as
    `launches.footprint`), for CPU tensors by the plain version
    _footprint_need_impl."""
    if xyz.is_cuda:
        return cuda_raster.footprint_need(
            xyz.contiguous(), scaling.contiguous(), rotation.contiguous(),
            world_views, full_projs, camera, kernel_size,
            (camera.width + BLOCK - 1) // BLOCK,
            (camera.height + BLOCK - 1) // BLOCK, tangents)
    return _footprint_need_impl(xyz, scaling, rotation, world_views,
                                full_projs, camera, kernel_size, tangents)


@torch.no_grad()
def _footprint_need_impl(xyz, scaling, rotation, world_views, full_projs,
                         camera, kernel_size: float = 0.0,
                         tangents=None) -> dict:
    """footprint_need's plain version, on any device: the footprints
    preprocess gives (gaussians.screen_footprints, bit for bit, PLAN_CHUNK
    at a time, or one view at a time at its own tangents), their pair
    counts (tile_rects) and tile occupancy (tile_occupancy)."""
    w, h = camera.width, camera.height
    V = len(world_views)
    if tangents is None:
        step = max(1, PLAN_CHUNK // max(xyz.shape[1], 1))
        chunks = [(i, camera) for i in range(0, V, step)]
    else:
        step = 1
        chunks = [(i, camera._replace(tan_fovx=tx, tan_fovy=ty))
                  for i, (tx, ty) in enumerate(tangents)]
    pairs, tiles = [], []
    for b in range(xyz.shape[0]):
        for i, cam in chunks:
            m2d, radii = G.screen_footprints(
                xyz[b], scaling[b], rotation[b], world_views[i:i + step],
                full_projs[i:i + step], cam, kernel_size)
            *_, count = tile_rects(m2d, radii, w, h)
            pairs.append(count.to(torch.int64).sum(-1).max())
            tiles.append(tile_occupancy(m2d, radii, w, h).max().long())
    n_pairs, n_tile = torch.stack([torch.stack(pairs).max(),
                                   torch.stack(tiles).max()]).tolist()
    return {"pairs": n_pairs, "tile": n_tile}


def suggest_pair_cap(n: int, bucket: int = 1 << 16) -> int:
    """Round a pair count up to a bucket."""
    n = max(int(n), 1)
    return ((n + bucket - 1) // bucket) * bucket
