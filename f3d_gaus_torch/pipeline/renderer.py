"""High-level render wrappers over the tile rasterizer (counterpart of
f3d_gaus_tpu/pipeline/renderer.py).

`render_gaussians` assembles SH, rasterizes, splits the 9-channel output and
derives the world-space normal (c2w-rotated, normalized) and the
depth-normal (cross product of backprojected depth gradients).
`render_views_batched` renders a stage: every (batch element, view) pair,
one render at a time, which keeps peak memory at one render's workspace.
Its cameras go to the device once, as the stage's `camera_table` (each
view's preprocess camera row and camera-to-world), from which every render
reads them.

A stage of two or more views of Gaussians whose renders take the
preprocess kernel (rasterize._kernel_preprocess: CUDA tensors that autograd
records nothing of) runs on a side stream as CUDA graphs, one per batch
element: the first view renders eagerly, which also warms the code up, the
same render is captured once at the stage's caps with its camera row a
static input, and every other view copies its table row into that input
and replays the graph, whose static outputs are copied into the stage's
result.  Each view still renders once, with the launches of an eager
render, and the result is the eager route's bit for bit; the host issues
one graph launch a view in place of about a hundred kernels, and the stage
makes no host sync.  Every other stage (training's differentiated renders,
CPU tensors, single views) renders eagerly.

A stage's views may each have their own tangents (`tangents`: the cameras
a pose-free model predicts).  The decision and compositing kernels take
the focal lengths as launch arguments, and depth_to_normal's pixel rays
are built from them, both of which a captured graph keeps, so a stage
whose views differ in their tangents renders eagerly.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.cameras import Camera
from ..core.device import resolve_device, upload
from ..ops import cuda_raster, rasterize
from ..utils import profiling
from .config import PipelineConfig

# A stage table's row: the preprocess kernel's camera (cuda_raster.
# camera_scalars), then the camera-to-world at a 16-byte aligned offset
CAMERA_FLOATS = cuda_raster.CAMERA_FLOATS
C2W_OFFSET = 48
ROW_FLOATS = C2W_OFFSET + 16


class RenderOverflow(RuntimeError):
    """A render exceeded its static caps (pair_cap / max_per_tile) and would
    silently truncate.  Catch this, double the caps (or call
    rasterize.plan_caps) and re-render; cycle.run_nvs raises it and
    cycle.run_nvs_replanned replans."""


def _c2w_host(world_view) -> np.ndarray:
    """Camera-to-world (column-vector) of a row-vector world_view, f32."""
    return np.linalg.inv(np.asarray(world_view, np.float32).T).astype(
        np.float32)


def _c2w(world_view, device) -> torch.Tensor:
    """_c2w_host on `device`, uploaded with no host sync."""
    return upload(_c2w_host(world_view), device)


def _camera(world_view, full_proj, cam_center, cfg: PipelineConfig,
            tangents=None):
    """A serving camera: cfg's frame width (`resolution`) and height, and
    both its tangents, or the view's own (tan_fovx, tan_fovy)."""
    tan_x, tan_y = (cfg.tan_fov, cfg.tan_fovy) if tangents is None \
        else tangents
    return Camera(world_view, full_proj, cam_center, cfg.resolution,
                  cfg.frame_height, tan_x, tan_y)


def camera_table(world_views, full_projs, cam_centers, cfg: PipelineConfig,
                 device, tangents=None) -> torch.Tensor:
    """A stage's cameras on `device`, uploaded once with no host sync: a
    (V, ROW_FLOATS) float32 table whose row v holds view v's
    cuda_raster.camera_scalars (at cfg's frame size and kernel_size, and
    cfg's tangents or view v's (tan_fovx, tan_fovy) of `tangents`) in
    [:CAMERA_FLOATS] and its camera-to-world, row-major, in [C2W_OFFSET:],
    each bit for bit what the view's own camera gives."""
    wv = np.asarray(world_views, np.float32)
    V = wv.shape[0]
    table = np.zeros((V, ROW_FLOATS), np.float32)
    if V:
        cam = _camera(wv[0], full_projs[0], cam_centers[0], cfg)
        table[:, :CAMERA_FLOATS] = cuda_raster.camera_rows(
            cam, wv, full_projs, cam_centers, cfg.kernel_size, tangents)
        table[:, C2W_OFFSET:] = np.linalg.inv(
            wv.transpose(0, 2, 1)).astype(np.float32).reshape(V, 16)
    return upload(table, torch.device(device))


_RAYS: dict = {}
_RAYS_KEPT = 16     # predicted cameras bring new fields of view each request


def _pixel_rays(width, height, tan_fovx, tan_fovy, device):
    """The (H, W, 3) camera rays of the pixels depth_to_normal
    backprojects, built once a size, field of view and device, the last
    _RAYS_KEPT of them kept (one built inside a CUDA graph's capture holds
    nothing until a replay, so it is not kept)."""
    key = (width, height, tan_fovx, tan_fovy, device)
    pts = _RAYS.get(key)
    if pts is not None:
        return pts
    fx = width / (2.0 * tan_fovx)
    fy = height / (2.0 * tan_fovy)
    gy, gx = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    pts = torch.stack([(gx - width / 2.0) / fx, (gy - height / 2.0) / fy,
                       torch.ones_like(gx)], -1)
    if device.type != "cuda" or not torch.cuda.is_current_stream_capturing():
        if len(_RAYS) >= _RAYS_KEPT:
            del _RAYS[next(iter(_RAYS))]
        _RAYS[key] = pts
    return pts


def _depth_to_normal(c2w, depth, pts):
    """depth_to_normal given the (4, 4) camera-to-world tensor and the
    pixel rays of _pixel_rays."""
    rays_d = pts @ c2w[:3, :3].T
    rays_o = c2w[:3, 3]
    points = depth[0][..., None] * rays_d + rays_o        # (H, W, 3) world
    dx = points[2:, 1:-1] - points[:-2, 1:-1]
    dy = points[1:-1, 2:] - points[1:-1, :-2]
    n = torch.linalg.cross(dx, dy)
    n = n * torch.rsqrt(torch.sum(n * n, -1, keepdim=True) + 1e-12)
    out = torch.zeros_like(points)
    out[1:-1, 1:-1] = n
    return out.permute(2, 0, 1)


def depth_to_normal(world_view, depth, width, height, tan_fovx, tan_fovy):
    """Normals from a depth map.  world_view: (4, 4) row-vector layout;
    depth: (1, H, W) tensor.  Returns (3, H, W), zero on the 1-pixel border."""
    dev = depth.device
    return _depth_to_normal(_c2w(world_view, dev), depth,
                            _pixel_rays(width, height, tan_fovx, tan_fovy,
                                        dev))


def _render(gaussians: dict, b: int, cam, row, bg, cfg: PipelineConfig):
    """Element `b` through camera `cam`, whose stage-table row `row` (a
    (ROW_FLOATS,) device tensor) gives the preprocess kernel its camera and
    the normals their camera-to-world: (render_views_batched's fields of
    one render, the radii)."""
    shs = torch.cat([gaussians["features_dc"][b],
                     gaussians["features_rest"][b]], dim=1)
    out = rasterize.render(
        gaussians["xyz"][b], gaussians["scaling"][b], gaussians["rotation"][b],
        gaussians["opacity"][b], shs, cam, bg,
        sh_degree=cfg.max_sh_degree, kernel_size=cfg.kernel_size,
        pair_cap=cfg.pair_cap, max_per_tile=cfg.max_per_tile, chunk=cfg.chunk,
        camera_row=row[:CAMERA_FLOATS])

    rn = out["rendered_normal"]
    rn = rn * torch.rsqrt(torch.sum(rn * rn, dim=0, keepdim=True) + 1e-12)
    c2w = row[C2W_OFFSET:].view(4, 4)
    normal_world = (c2w[:3, :3] @ rn.reshape(3, -1)).reshape(rn.shape)
    dn = _depth_to_normal(c2w, out["rendered_depth"],
                          _pixel_rays(cam.width, cam.height, cam.tan_fovx,
                                      cam.tan_fovy, rn.device))
    return {
        "render": out["render"],
        "rendered_normal": normal_world,
        "rendered_depth": out["rendered_depth"],
        "depth_normal": dn,
        "rendered_alpha": out["rendered_alpha"],
        "distortion_map": out["distortion_map"],
        "overflow": out["overflow"],
    }, out["radii"]


def render_gaussians(gaussians: dict, b: int, world_view, full_proj,
                     cam_center, bg, cfg: PipelineConfig):
    """Render element `b` of a predicted Gaussian dict through one camera
    (camera matrices as float32 numpy arrays)."""
    row = camera_table([world_view], [full_proj], [cam_center], cfg,
                       gaussians["xyz"].device)[0]
    out, radii = _render(gaussians, b,
                         _camera(world_view, full_proj, cam_center, cfg), row,
                         bg, cfg)
    overflow = out.pop("overflow")
    return {**out, "radii": radii, "visibility_filter": radii > 0,
            "overflow": overflow}


def _graph_route(dev, gaussians: dict, n_views: int) -> bool:
    """Whether a stage renders through CUDA graphs: two or more views of
    Gaussians whose renders take the preprocess kernel
    (rasterize._kernel_preprocess: CUDA tensors, nothing for autograd to
    record)."""
    return n_views > 1 and rasterize._kernel_preprocess(
        dev, list(gaussians.values()), None)


class _GraphStages:
    """What one CUDA device's graph stages share: the side stream they run
    on (a capture needs a stream other than the default one), the memory
    pool their captures draw from, and the last stage's graphs, kept so
    that the pool lives on into the next stage's captures."""

    def __init__(self, dev):
        self.stream = torch.cuda.Stream(dev)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: list = []


_GRAPH_STAGES: dict = {}     # by device


def _graph_stages(dev) -> _GraphStages:
    if dev not in _GRAPH_STAGES:
        _GRAPH_STAGES[dev] = _GraphStages(dev)
    return _GRAPH_STAGES[dev]


def _capture(gaussians: dict, b: int, cam, bg, cfg: PipelineConfig, pool):
    """One render of element b captured as a CUDA graph on the current
    (side) stream into `pool`: (graph, its static camera row, its static
    outputs, what its capture counted).  A capture that fails raises."""
    row = torch.empty(ROW_FLOATS, device=bg.device)
    graph = torch.cuda.CUDAGraph()
    with profiling.captured() as tally:
        graph.capture_begin(pool=pool)
        try:
            static, _ = _render(gaussians, b, cam, row, bg, cfg)
        finally:
            graph.capture_end()
    profiling.count("graph.captures")
    return graph, row, static, tally


def _graph_stage(gaussians: dict, cams: list, table, bg,
                 cfg: PipelineConfig) -> dict:
    """render_views_batched's stage as CUDA graphs (see the module
    docstring), on the device's side stream, ordered after the caller's
    stream's work and before its later work.  While tracing is on each
    replay is span `replay` and counts what its capture counted
    (profiling.replayed); each capture counts `graph.captures`."""
    dev = table.device
    B, V = gaussians["xyz"].shape[0], len(cams)
    stages = _graph_stages(dev)
    side, main = stages.stream, torch.cuda.current_stream(dev)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        first = [_render(gaussians, b, cams[0], table[0], bg, cfg)[0]
                 for b in range(B)]
    # the result lives on the caller's stream
    out = {k: v.new_empty((B, V) + v.shape) for k, v in first[0].items()}
    side.wait_stream(main)
    with torch.cuda.stream(side):
        graphs = []
        for b in range(B):
            for k, v in first[b].items():
                out[k][b, 0].copy_(v)
            graphs.append(_capture(gaussians, b, cams[1], bg, cfg,
                                   stages.pool))
        del first
        for v in range(1, V):
            for b, (graph, row, static, tally) in enumerate(graphs):
                row.copy_(table[v])
                with profiling.span("replay"):
                    graph.replay()
                profiling.replayed(tally)
                for k, t in static.items():
                    out[k][b, v].copy_(t)
    main.wait_stream(side)
    stages.graphs = [g[0] for g in graphs]
    return out


def render_views_batched(gaussians: dict, world_views, full_projs,
                         cam_centers, bg, cfg: PipelineConfig, device=None,
                         tangents=None):
    """Render every (batch element, view) pair.

    gaussians: dict of (B, P, ...) tensors; world_views/full_projs:
    (V, 4, 4) and cam_centers (V, 3) numpy arrays; bg: (3,); tangents:
    None (every view at cfg's tangents) or each view's (tan_fovx,
    tan_fovy).  Returns a dict of (B, V, ...) tensors, including the
    (B, V) bool `overflow` map, which callers must check: a static-cap
    truncation is otherwise silent.  A stage of two or more views whose
    renders take the preprocess kernel and share their tangents runs as
    CUDA graphs (module docstring), bit for bit the eager renders."""
    dev = resolve_device(device, gaussians["xyz"])
    gaussians = {k: v.to(dev) for k, v in gaussians.items()}
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    per_view = [None] * len(world_views) if tangents is None else tangents
    cams = [_camera(*c, cfg, t) for c, t in zip(
        zip(world_views, full_projs, cam_centers), per_view)]
    table = camera_table(world_views, full_projs, cam_centers, cfg, dev,
                         tangents)
    one_fov = len({(c.tan_fovx, c.tan_fovy) for c in cams}) == 1
    if one_fov and _graph_route(dev, gaussians, len(cams)):
        return _graph_stage(gaussians, cams, table, bg, cfg)
    B = gaussians["xyz"].shape[0]
    rows = []
    for cam, row in zip(cams, table):
        per_b = [_render(gaussians, b, cam, row, bg, cfg)[0]
                 for b in range(B)]
        rows.append({k: torch.stack([o[k] for o in per_b]) for k in per_b[0]})
    return {k: torch.stack([r[k] for r in rows], 1) for k in rows[0]}
