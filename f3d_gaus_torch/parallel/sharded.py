"""Tile-sharded rendering across ranks (counterpart of f3d_gaus_tpu/
parallel/sharded.py).

  * TILE SHARDING: the frame's 16-pixel tile rows are split into one
    horizontal band per rank; each rank bins and composites only its band
    (the band mode of ops/rasterize.py, whose kernels take the band's
    row_off) and the bands are gathered into the full frame.
  * GAUSSIAN SHARDING: the per-Gaussian preprocess runs on this rank's P/D
    rows, and the compact (P/D, 19) feature table is all-gathered
    differentiably (the JAX package's all_gather(tiled=True)); the conic,
    means2d, depth and radius columns are gathered without gradient.
  * GRADIENTS: each band's backward gives per-Gaussian partials for the
    whole set.  The feature gather's backward sums them over the ranks and
    keeps this rank's rows (JAX's reduce_scatter).  The five inputs'
    gradients are then all-reduced (SUM): without Gaussian sharding that
    sums the bands' partials, with it the ranks' disjoint rows.  Either
    way every rank ends with the full gradient of a loss that every rank
    computes on the assembled frame.

`band_render(rank, world, ...)` is one rank's body and needs no process
group (without `gather` it preprocesses every Gaussian itself, which is
what the gathered table holds); `render_tile_sharded(group, ...)` runs it
on this rank of `group` with the collectives.  The JAX package's
`overlap_flags` (XLA:TPU scheduler flags for overlapping collectives with
compute) is XLA-only and has no counterpart here.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import rasterize as R


class _AllGatherRows(torch.autograd.Function):
    """all_gather along dim 0 of equal (n, ...) pieces; the backward sums
    the cotangent over the ranks and keeps this rank's rows (JAX's
    reduce_scatter, the transpose of a tiled all_gather)."""

    @staticmethod
    def forward(ctx, x, group):
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.group, ctx.rank, ctx.n = group, rank, x.shape[0]
        return torch.cat(parts, 0)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None


class _SumGrads(torch.autograd.Function):
    """Identity forward; the backward all-reduces (SUM) the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _RowsOfFrame(torch.autograd.Function):
    """all_gather of the ranks' (C, h, W) bands into the (C, D h, W)
    frame.  Every rank's loss is the same function of the frame, so a
    band's cotangent is this rank's rows of its own frame cotangent."""

    @staticmethod
    def forward(ctx, band, group):
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        parts = [torch.empty_like(band) for _ in range(world)]
        dist.all_gather(parts, band.contiguous(), group=group)
        ctx.rank, ctx.h = rank, band.shape[1]
        return torch.cat(parts, 1)

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.rank * ctx.h:(ctx.rank + 1) * ctx.h].contiguous(), None


def _band_rows(camera, world: int) -> int:
    grid_y = -(-camera.height // R.BLOCK)
    if grid_y % world != 0:
        raise ValueError(f"tile rows {grid_y} not divisible by the number of "
                         f"ranks {world}")
    return grid_y // world


def band_render(rank: int, world: int, means3d, scales, quats, opacities,
                shs, camera, bg=None, *, sh_degree: int = 1,
                kernel_size: float = 0.0, pair_cap: int = 1 << 16,
                max_per_tile: int = 1024, chunk: int = 128,
                backend: str = "auto", gather=None):
    """Rank `rank` of `world`'s band of the frame, differentiably in the
    five Gaussian inputs: preprocess (of this rank's P/D rows, gathered by
    `gather(features, extra)` into the (P, 19) and (P, 7) tables, when
    `gather` is given; else of every row), the band's binning and the
    compositing from the feature table.  Returns (band (9, rows * 16, W),
    overflow (0-dim bool))."""
    n_rows = _band_rows(camera, world)
    P = means3d.shape[0]
    if gather is not None:
        sl = slice(rank * P // world, (rank + 1) * P // world)
        means3d, scales, quats, opacities, shs = (
            a[sl] for a in (means3d, scales, quats, opacities, shs))
    feat, extra, depths, radii = R._preprocess_impl(
        means3d, scales, quats, opacities, shs, sh_degree, camera,
        kernel_size)
    # [conic | means2d | depth | radius]: the columns binning and the
    # densification statistics read, gathered without gradient
    extra = torch.cat([extra, depths[:, None], radii[:, None].float()],
                      1).detach()
    if gather is not None:
        feat, extra = gather(feat, extra)
    radii = extra[:, 6].to(torch.int32)
    bng, statics = R.bin_band(extra[:, 3:5], radii, extra[:, 5], camera,
                              (rank * n_rows, n_rows), pair_cap=pair_cap,
                              max_per_tile=max_per_tile, chunk=chunk)
    if bg is None:
        bg = torch.zeros(3, device=feat.device)
    bg = torch.as_tensor(bg, dtype=torch.float32,
                         device=feat.device).detach().reshape(3).contiguous()
    out, _ = R.composite_from_features(feat, extra[:, :5].contiguous(), bng,
                                       statics, bg, backend)
    band = R._tiles_to_image(out, statics._replace(
        height=n_rows * R.BLOCK))
    overflow = bng.overflow | torch.any(bng.tile_count > max_per_tile)
    return band, overflow


def render_tile_sharded(group, means3d, scales, quats, opacities, shs,
                        camera, bg=None, *, sh_degree: int = 1,
                        kernel_size: float = 0.0, pair_cap: int = 1 << 16,
                        max_per_tile: int = 1024, chunk: int = 128,
                        backend: str = "auto", gaussian_shard: bool = True):
    """Render ONE Gaussian set with the frame's tile rows split over the
    ranks of `group` (None: the default group), every rank passing the
    same full inputs.  Differentiable in (means3d, scales, quats,
    opacities, shs): each rank gets the full gradient.  Returns {'out9':
    (9, H, W) assembled from the ranks' bands, 'overflow': True if any
    rank's binning truncated}.

    gaussian_shard=True also shards the preprocess (off when P does not
    divide by the number of ranks) and all-gathers its feature table."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    _band_rows(camera, world)
    if gaussian_shard and means3d.shape[0] % world != 0:
        gaussian_shard = False
    gather = None
    if gaussian_shard:
        def gather(feat, extra):
            parts = [torch.empty_like(extra) for _ in range(world)]
            dist.all_gather(parts, extra.contiguous(), group=group)
            return _AllGatherRows.apply(feat, group), torch.cat(parts, 0)
    # each rank's gradient holds its bands' partials (unsharded) or its own
    # rows (sharded): their sum over the ranks is the full gradient
    means3d, scales, quats, opacities, shs = (
        _SumGrads.apply(a, group)
        for a in (means3d, scales, quats, opacities, shs))
    band, overflow = band_render(
        rank, world, means3d, scales, quats, opacities, shs, camera, bg,
        sh_degree=sh_degree, kernel_size=kernel_size, pair_cap=pair_cap,
        max_per_tile=max_per_tile, chunk=chunk, backend=backend,
        gather=gather)
    flag = overflow.to(torch.int32).reshape(1)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    out9 = _RowsOfFrame.apply(band, group)
    return {"out9": out9[:, :camera.height], "overflow": flag[0] > 0}
