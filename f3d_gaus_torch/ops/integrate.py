"""Opacity-field query at 3D points ("integrate"), the mesh path's field
(counterpart of f3d_gaus_tpu/ops/integrate.py, same semantics).

Every query point is projected to its pixel; along the point's own ray,
each Gaussian of that pixel's tile window contributes
alpha = min(0.99, opa * exp(-1/2 * Q(t_c))) with the ray quadratic taken
at t_c = min(t_peak, point depth), alphas below 1/255 are skipped, and the
field is 1 - prod(1 - alpha): the front-to-back sum telescopes, so the
product's order does not matter.  Points outside the image or in front of
the near plane get alpha 0.

Two implementations of the per-view product:
  * the hand-written CUDA kernels of csrc/integrate.cu (the row table
    and the points' sort keys, the item plan, the field with its
    division- and exp-free rejection of the pairs that cannot reach
    1/255, and the second pass of split windows), through
    ops/cuda_raster.py:integrate, which every query on CUDA tensors goes
    through; their plain versions here are _pack_rows, _point_keys,
    _integrate_items and _pair_rejected (the rejection's f32 mirror);
  * `_alpha_impl`, the plain PyTorch field (the points grouped by tile,
    each tile's window in chunks), used for CPU tensors and as the
    yardstick the kernel is held against.

`integrate_min_alpha` is the mesh path's hot loop: a fresh preprocess and
binning per view, one view at a time, and a running minimum from 1 over
the views.  Like the JAX package it does not stop on a truncated binning
(pair_cap or max_per_tile too small); it counts such views in
`overflow_views` instead.  Integrate has no gradient.

`integrate_points` has no `bg` argument: the JAX function accepts one and
never reads it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import gaussians as G
from ..core.cameras import Camera
from ..core.device import resolve_device
from . import binning as B
from . import cuda_raster

ALPHA_EPS = 1.0 / 255.0
BLOCK = B.BLOCK
# the rejection's margin for the rounding of g = t_c a + b and of a x b,
# per unit |b|^2 (argued in csrc/integrate.cu's header)
REJECT_KAPPA = 4e-6
# the kernel's plan (cuda_raster): points per item, the least window rows
# per item and the most slices per window (partial products a point)
POINTS_PER_ITEM = cuda_raster.POINTS_PER_ITEM
SLICE_LEN = cuda_raster.SLICE_LEN
MAX_SLICES = cuda_raster.MAX_SLICES
KEY_RANGE = 2.0            # ray coordinates the sort key resolves

overflow_views = 0        # views with a truncated binning since the last reset


class IntegrateStatics(NamedTuple):
    width: int
    height: int
    grid_x: int
    grid_y: int
    focal_x: float
    focal_y: float
    max_per_tile: int
    chunk: int           # window slots per step of the plain version
    point_chunk: int     # query points per step of the plain version


class QueryRays(NamedTuple):
    """The query points as one view sees them, each (Q,)."""
    u: torch.Tensor          # (px - W/2) / focal_x
    v: torch.Tensor
    depth: torch.Tensor      # view-space z
    tile: torch.Tensor       # int32 tile of the point's pixel (clipped)
    inside: torch.Tensor     # bool: in the image and past the near plane
    px: torch.Tensor
    py: torch.Tensor


def _statics(camera: Camera, max_per_tile, chunk, point_chunk):
    return IntegrateStatics(
        width=camera.width, height=camera.height,
        grid_x=(camera.width + BLOCK - 1) // BLOCK,
        grid_y=(camera.height + BLOCK - 1) // BLOCK,
        focal_x=float(camera.focal_x), focal_y=float(camera.focal_y),
        max_per_tile=max_per_tile, chunk=chunk, point_chunk=point_chunk)


def project_query_points(points, world_view, full_proj, width, height):
    """Project query points the way preprocessPointsCUDA does: full_proj NDC
    -> pixel coords, view depth.  Returns (px, py, depth, inside)."""
    p_view, p_ndc = G.project_points(points, world_view, full_proj)
    px = G.ndc_to_pix(p_ndc[..., 0], width)
    py = G.ndc_to_pix(p_ndc[..., 1], height)
    depth = p_view[..., 2]
    inside = ((px >= 0) & (px < width) & (py >= 0) & (py < height)
              & (depth > G.NEAR_PLANE))
    return px, py, depth, inside


def query_rays(points, camera: Camera, s: IntegrateStatics) -> QueryRays:
    px, py, depth, inside = project_query_points(
        points, camera.world_view, camera.full_proj, s.width, s.height)
    # float -> int32 of an out-of-range value is undefined; such points are
    # outside, so clamp before converting
    tx = torch.clamp(torch.floor(px / BLOCK), 0, s.grid_x - 1)
    ty = torch.clamp(torch.floor(py / BLOCK), 0, s.grid_y - 1)
    tile = (torch.nan_to_num(ty) * s.grid_x
            + torch.nan_to_num(tx)).to(torch.int32)
    u = (px - s.width / 2.0) / s.focal_x
    v = (py - s.height / 2.0) / s.focal_y
    return QueryRays(u, v, depth.contiguous(), tile, inside, px, py)


def _pair_alpha(rows, u, v, ray_depth):
    """alpha of each (point, window slot) pair, 0 where it fails the 1/255
    test.

    rows: (Q or 1, C, 13), the (M, b) packing (12) and the opacity of each
    window slot, an empty slot all zeros (opacity 0: alpha 0 fails the
    1/255 test); u, v, ray_depth: (Q,).  Returns (Q, C)."""
    m = rows.unbind(-1)
    U, V, D = u[:, None], v[:, None], ray_depth[:, None]
    a = [m[3 * k] * U + m[3 * k + 1] * V + m[3 * k + 2] for k in range(3)]
    b = m[9:12]
    AA = a[0] * a[0] + a[1] * a[1] + a[2] * a[2]
    ab = a[0] * b[0] + a[1] * b[1] + a[2] * b[2]
    t_peak = -ab / torch.where(AA == 0, 1e-12, AA)
    t_c = torch.minimum(t_peak, D)                              # the GOF clamp
    g = [t_c * a[k] + b[k] for k in range(3)]                   # g(t_c)
    val = g[0] * g[0] + g[1] * g[1] + g[2] * g[2]
    # the field query takes no gradient, so clamp's tie share is moot
    alpha = torch.clamp_max(m[12] * torch.exp(-0.5 * val), 0.99)
    return torch.where(alpha >= ALPHA_EPS, alpha, 0.0)


def _pack_rows(v2g_mb, opa):
    """The kernel's (P + 1, 16) f32 row table, the plain version of
    csrc/integrate.cu:prep_kernel's: M (9), b (3), opa, |b|^2 - thr_row
    with thr_row = reject_threshold(opa) + REJECT_KAPPA |b|^2, two zeros.
    reject_threshold is csrc/gof_pair.cuh's: 2 ln(opa / (1/255)) raised by
    1e-4 relative and 2e-3 absolute, -inf below an opacity of 1/255 (so
    the column is +inf and every pair of the row with a ray of nonzero
    |a| is rejected).  Row P, read for ids outside [0, P), is a sentinel
    of opacity 0 whose M gives a = (1, 1, 1) on every ray, so that all its
    pairs are rejected too (a = 0 would make the test 0 inf = NaN)."""
    P = v2g_mb.shape[0]
    eps = torch.tensor(ALPHA_EPS, dtype=torch.float32)
    thr = (2.0 * torch.log(opa / eps)) * 1.0001 + 2e-3
    thr = torch.where(opa < eps, float("-inf"), thr)
    b = v2g_mb[:, 9:12]
    b2 = b[:, 0] * b[:, 0] + b[:, 1] * b[:, 1] + b[:, 2] * b[:, 2]
    rows = torch.zeros((P + 1, 16), dtype=torch.float32, device=opa.device)
    rows[:P, :12] = v2g_mb
    rows[:P, 12] = opa
    rows[:P, 13] = b2 - (thr + REJECT_KAPPA * b2)
    rows[P, [2, 5, 8]] = 1.0
    rows[P, 13] = float("inf")
    return rows


def _pair_rejected(rows, u, v):
    """The f32 mirror of the kernel's rejection (csrc/integrate.cu:
    surely_fails): True where |a|^2 (|b|^2 - thr_row) - (a.b)^2 > 0, that
    is |a x b|^2 > |a|^2 thr_row, which implies alpha < 1/255.  rows:
    (Q or 1, C, 16) packed rows (_pack_rows); u, v: (Q,).  `a` is computed
    as _pair_alpha computes it.  Returns (Q, C) bool.

    Not the kernel's decision bit for bit: the kernel takes Q in one fused
    multiply-add and nvcc contracts a, |a|^2 and a.b into FMAs, where each
    product here is rounded.  Both roundings lie inside the margin the
    kernel's header argues (the 15 eps |a|^2 (|b|^2 + thr_row) it allows
    for Q's rounding, within kappa's 67 eps), so a pair this mirror keeps
    on the margin's edge the kernel may rule out, and only such a pair."""
    m = rows.unbind(-1)
    U, V = u[:, None], v[:, None]
    a = [m[3 * k] * U + m[3 * k + 1] * V + m[3 * k + 2] for k in range(3)]
    AA = a[0] * a[0] + a[1] * a[1] + a[2] * a[2]
    ab = a[0] * m[9] + a[1] * m[10] + a[2] * m[11]
    return AA * m[13] - ab * ab > 0


class ItemPlan(NamedTuple):
    """The field kernel's work plan for one view (_integrate_items).
    Segment s < T holds the inside points of tile s, segment T the rest."""
    keys: torch.Tensor        # (Q,) int32 sort keys, ascending
    perm: torch.Tensor        # (Q,) int64 sorted position -> point
    seg_start: torch.Tensor   # (T + 2,) int32 first position of segment s
    item_start: torch.Tensor  # (T + 2,) int32 first item of segment s
    part_start: torch.Tensor  # (T + 2,) int32 first partial of segment s


key_bits = cuda_raster.key_bits


def _spread_bits(x):
    """The bits of x (< 2^16) moved to the even positions (Morton)."""
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    return (x | (x << 1)) & 0x55555555


def _point_keys(tile, inside, u, v, num_tiles: int):
    """(Q,) int32 sort keys, the plain version of csrc/integrate_prep.cu's:
    the segment (the tile if inside, else T) above the Morton code of the
    ray (u, v), each quantised to 2^key_bits levels over [-KEY_RANGE,
    KEY_RANGE), so that points next to each other in a tile's order lie
    next to each other in the image."""
    bits = key_bits(num_tiles)
    levels = 1 << bits

    def quant(x):
        q = torch.floor((x + KEY_RANGE) * (levels / (2 * KEY_RANGE)))
        return torch.clamp(torch.nan_to_num(q), 0, levels - 1).to(torch.int64)
    code = _spread_bits(quant(u)) | (_spread_bits(quant(v)) << 1)
    seg = torch.where(inside, tile.to(torch.int64), num_tiles)
    return torch.where(inside, (seg << (2 * bits)) | code,
                       seg << (2 * bits)).to(torch.int32)


def _integrate_items(tile, inside, u, v, tile_count, max_per_tile: int,
                     slice_len: int = SLICE_LEN,
                     per_item: int = POINTS_PER_ITEM) -> ItemPlan:
    """The kernel's item plan in torch ops, the plain version of
    csrc/integrate.cu:plan_kernel with the keys of _point_keys.  The points
    are sorted by key (by segment, Morton order inside a tile).  Segment s
    has ceil(n_pts / per_item) point blocks and its window, window =
    min(tile_count, max_per_tile) (0 outside), cut into slices of
    slice_rows(window, slice_len) rows, at most MAX_SLICES of them; its
    items are its (slice, block)s, block fastest, so that neighbouring
    CTAs read the same rows.  A segment of more than one slice keeps
    slices x n_pts partial products from part_start[s] on, slice-major."""
    T = tile_count.shape[0]
    dev = tile.device
    keys, perm = torch.sort(_point_keys(tile, inside, u, v, T))
    seg = keys >> (2 * key_bits(T))
    seg_start = torch.searchsorted(
        seg, torch.arange(T + 2, dtype=seg.dtype, device=dev))
    n_pts = seg_start[1:] - seg_start[:-1]
    window = torch.cat([torch.clamp_max(tile_count, max_per_tile),
                        tile_count.new_zeros(1)]).to(seg_start.dtype)
    rows = slice_rows(window, slice_len)
    slices = torch.clamp_min((window + rows - 1) // rows, 1)
    items = (n_pts + per_item - 1) // per_item * slices
    parts = torch.where(slices > 1, slices * n_pts, 0)

    def starts(x):
        out = torch.zeros(T + 2, dtype=torch.int32, device=dev)
        out[1:] = torch.cumsum(x, 0)
        return out
    return ItemPlan(keys, perm, seg_start.to(torch.int32), starts(items),
                    starts(parts))


def slice_rows(window, slice_len: int):
    """The rows of each slice of a window (an int or a tensor of them):
    slice_len, or more where that would cut it into more than MAX_SLICES
    slices (csrc/integrate.cu:slice_rows)."""
    least = (window + MAX_SLICES - 1) // MAX_SLICES
    if torch.is_tensor(window):
        return torch.clamp_min(least, slice_len)
    return max(slice_len, least)


plan_bounds = cuda_raster.plan_bounds


def _point_alpha_product(rows, u, v, ray_depth):
    """prod(1 - alpha) over one window chunk for each point (Q,)."""
    return torch.prod(1.0 - _pair_alpha(rows, u, v, ray_depth), -1)


def _alpha_impl(v2g_mb, opa, point_list, tile_start, tile_count,
                q: QueryRays, s: IntegrateStatics):
    """Plain PyTorch field of one view: (Q,) alpha = 1 - prod(1 - alpha_i)
    over each inside point's tile window min(tile_count, max_per_tile), 0
    elsewhere.  Groups the points by tile, as the kernel does, and walks
    each tile's window in chunks of s.chunk rows against at most
    s.point_chunk of its points at a time."""
    P, T = v2g_mb.shape[0], tile_start.shape[0]
    rows = torch.cat([v2g_mb, opa[:, None]], 1)
    rows = torch.cat([rows, rows.new_zeros((1, 13))], 0)      # the sentinel P
    order = torch.argsort(torch.where(q.inside, q.tile, T), stable=True)
    n_pts = torch.bincount(q.tile[q.inside].long(), minlength=T).tolist()
    count = torch.clamp_max(tile_count, s.max_per_tile).tolist()
    start = tile_start.tolist()
    alpha = torch.zeros_like(q.u)
    pos = 0
    for t in range(T):
        tile_pts = order[pos:pos + n_pts[t]]
        pos += n_pts[t]
        for lo in range(0, len(tile_pts), s.point_chunk):
            sel = tile_pts[lo:lo + s.point_chunk]
            prod = torch.ones_like(q.u[sel])
            for c0 in range(0, count[t], s.chunk):
                ids = point_list[start[t] + c0:
                                 start[t] + min(c0 + s.chunk, count[t])]
                prod = prod * _point_alpha_product(
                    rows[ids.long().clamp(0, P)][None], q.u[sel], q.v[sel],
                    q.depth[sel])
            alpha[sel] = 1.0 - prod
    return alpha


def _view_alpha(pre, bng, q: QueryRays, s: IntegrateStatics, kernel: bool,
                out=None):
    """One view's field: alpha (Q,), or `out` updated in place to
    min(out, alpha) (the view sweep's running minimum)."""
    if kernel:
        return cuda_raster.integrate(pre.v2g_mb, pre.opa_coef, bng.point_list,
                                     bng.tile_start, bng.tile_count, q.u, q.v,
                                     q.depth, q.tile, q.inside,
                                     s.max_per_tile, out=out)
    alpha = _alpha_impl(pre.v2g_mb, pre.opa_coef, bng.point_list,
                        bng.tile_start, bng.tile_count, q, s)
    return alpha if out is None else torch.minimum(out, alpha, out=out)


def _prepare_view(gauss, camera, sh_degree, kernel_size, pair_cap,
                  max_per_tile):
    pre = G.preprocess(*gauss, sh_degree, camera, kernel_size)
    bng = B.bin_gaussians(pre.means2d, pre.radii, pre.depths, camera.width,
                          camera.height, pair_cap, max_per_tile=max_per_tile)
    truncated = bng.overflow | torch.any(bng.tile_count > max_per_tile)
    return pre, bng, truncated


def _inputs(arrays, points, device, backend):
    """(device, the Gaussian tensors, the points, whether the kernel runs)."""
    if backend not in ("auto", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    dev = resolve_device(device, arrays[0] if torch.is_tensor(arrays[0])
                         else None)
    gauss = tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                  for a in arrays)
    pts = torch.as_tensor(points, dtype=torch.float32, device=dev)
    return dev, gauss, pts, backend == "auto" and dev.type != "cpu"


@torch.no_grad()
def integrate_min_alpha(means3d, scales, quats, opacities, shs,
                        world_views, full_projs, cam_centers, points, *,
                        width: int, height: int, tan_fovx: float,
                        tan_fovy: float, sh_degree: int = 1,
                        kernel_size: float = 0.0, pair_cap: int = 1 << 18,
                        max_per_tile: int = 1024, chunk: int = 128,
                        point_chunk: int = 1 << 14, backend: str = "auto",
                        device=None):
    """min over views of alpha_integrated at `points` (Q, 3), from 1.

    world_views/full_projs: (V, 4, 4) and cam_centers (V, 3) numpy arrays.
    Each view is preprocessed and binned afresh and its field taken by the
    kernel (CUDA tensors, backend 'auto') or the plain version (CPU
    tensors, or backend 'torch').  The inputs may be tensors (their device
    is used) or arrays, which go to `device` (default `cuda`).  Returns
    (Q,) float32 on the run's device."""
    global overflow_views
    dev, gauss, pts, kernel = _inputs(
        (means3d, scales, quats, opacities, shs), points, device, backend)
    min_alpha = torch.ones(pts.shape[0], dtype=torch.float32, device=dev)
    truncated = torch.zeros((), dtype=torch.int64, device=dev)
    for wv, fp, cc in zip(world_views, full_projs, cam_centers):
        cam = Camera(wv, fp, cc, width, height, tan_fovx, tan_fovy)
        s = _statics(cam, max_per_tile, chunk, point_chunk)
        pre, bng, trunc = _prepare_view(gauss, cam, sh_degree, kernel_size,
                                        pair_cap, max_per_tile)
        truncated += trunc
        _view_alpha(pre, bng, query_rays(pts, cam, s), s, kernel,
                    out=min_alpha)
    overflow_views += int(truncated)
    return min_alpha


@torch.no_grad()
def integrate_points(means3d, scales, quats, opacities, shs, camera, points,
                     *, sh_degree: int = 1, kernel_size: float = 0.0,
                     pair_cap: int = 1 << 18, max_per_tile: int = 1024,
                     chunk: int = 128, point_chunk: int = 1 << 14,
                     pixel_color=None, backend: str = "auto", device=None):
    """The GOF opacity field of a Gaussian set at world points (Q, 3)
    through one camera.  Returns dict(alpha_integrated (Q,),
    color_integrated (Q, 3)): the colour is gathered from `pixel_color`
    ((3, H, W), a render to read it from) at the point's pixel, zeros
    without one or outside the image.  Devices and backends as
    integrate_min_alpha."""
    global overflow_views
    dev, gauss, pts, kernel = _inputs(
        (means3d, scales, quats, opacities, shs), points, device, backend)
    s = _statics(camera, max_per_tile, chunk, point_chunk)
    pre, bng, trunc = _prepare_view(gauss, camera, sh_degree, kernel_size,
                                    pair_cap, max_per_tile)
    overflow_views += int(trunc)
    q = query_rays(pts, camera, s)
    alpha = _view_alpha(pre, bng, q, s, kernel)
    color = torch.zeros((pts.shape[0], 3), dtype=torch.float32, device=dev)
    if pixel_color is not None:
        img = torch.as_tensor(pixel_color, dtype=torch.float32, device=dev)
        # truncation toward zero, as astype(int32); only inside points keep it
        xi = torch.clamp(torch.nan_to_num(q.px), 0, s.width - 1).long()
        yi = torch.clamp(torch.nan_to_num(q.py), 0, s.height - 1).long()
        color = torch.where(q.inside[:, None], img[:, yi, xi].T, 0.0)
    return {"alpha_integrated": alpha, "color_integrated": color}
