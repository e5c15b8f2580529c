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
  * the hand-written CUDA kernel csrc/integrate.cu (ops/cuda_raster.py:
    integrate), which every query on CUDA tensors goes through;
  * `_alpha_impl`, its plain PyTorch version (the points grouped by tile,
    each tile's window in chunks), used for CPU tensors and as the
    yardstick the kernel is held against.

`integrate_min_alpha` is the mesh path's hot loop: a fresh preprocess and
binning per view, one view at a time, and a running minimum from 1 over
the views.  Like the JAX package it does not stop on a truncated binning
(pair_cap or max_per_tile too small); it counts such views in
`overflow_views` instead.  Integrate has no gradient.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import gaussians as G
from ..core.cameras import Camera
from ..core.device import resolve_device
from . import binning as B

ALPHA_EPS = 1.0 / 255.0
BLOCK = B.BLOCK

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
    alpha = torch.clamp_max(m[12] * torch.exp(-0.5 * val), 0.99)
    return torch.where(alpha >= ALPHA_EPS, alpha, 0.0)


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
        from . import cuda_raster
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
