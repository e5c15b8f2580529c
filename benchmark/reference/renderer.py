# Frozen copy of f3d_gaus_torch/pipeline/renderer.py at commit b6ed6e2, the
# benchmark's plain reference; imports rewritten for this flat package.
"""High-level render wrappers over the tile rasterizer (counterpart of
f3d_gaus_tpu/pipeline/renderer.py).

`render_gaussians` assembles SH, rasterizes, splits the 9-channel output and
derives the world-space normal (c2w-rotated, normalized) and the
depth-normal (cross product of backprojected depth gradients).
`render_views_batched` loops over views x batch elements: each render is one
kernel launch, and renders are not run concurrently, which keeps peak
memory at one render's workspace.
"""
from __future__ import annotations

import numpy as np
import torch

from .cameras import Camera
from .device import resolve_device
from . import rasterize
from .config import PipelineConfig


class RenderOverflow(RuntimeError):
    """A render exceeded its static caps (pair_cap / max_per_tile) and would
    silently truncate.  Catch this, double the caps (or call
    rasterize.plan_caps) and re-render; cycle.run_nvs raises it and
    cycle.run_nvs_replanned replans."""


def _c2w(world_view, device) -> torch.Tensor:
    """Camera-to-world (column-vector) of a row-vector world_view, f32."""
    c2w = np.linalg.inv(np.asarray(world_view, np.float32).T)
    return torch.as_tensor(c2w.astype(np.float32), device=device)


def depth_to_normal(world_view, depth, width, height, tan_fovx, tan_fovy):
    """Normals from a depth map.  world_view: (4, 4) row-vector layout;
    depth: (1, H, W) tensor.  Returns (3, H, W), zero on the 1-pixel border."""
    dev = depth.device
    c2w = _c2w(world_view, dev)
    fx = width / (2.0 * tan_fovx)
    fy = height / (2.0 * tan_fovy)
    gy, gx = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                            torch.arange(width, dtype=torch.float32, device=dev),
                            indexing="ij")
    pts = torch.stack([(gx - width / 2.0) / fx, (gy - height / 2.0) / fy,
                       torch.ones_like(gx)], -1)          # (H, W, 3) cam rays
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


def render_gaussians(gaussians: dict, b: int, world_view, full_proj,
                     cam_center, bg, cfg: PipelineConfig):
    """Render element `b` of a predicted Gaussian dict through one camera
    (camera matrices as float32 numpy arrays)."""
    cam = Camera(world_view, full_proj, cam_center, cfg.resolution,
                 cfg.resolution, cfg.tan_fov, cfg.tan_fov)
    shs = torch.cat([gaussians["features_dc"][b],
                     gaussians["features_rest"][b]], dim=1)
    out = rasterize.render(
        gaussians["xyz"][b], gaussians["scaling"][b], gaussians["rotation"][b],
        gaussians["opacity"][b], shs, cam, bg,
        sh_degree=cfg.max_sh_degree, kernel_size=cfg.kernel_size,
        pair_cap=cfg.pair_cap, max_per_tile=cfg.max_per_tile, chunk=cfg.chunk)

    rn = out["rendered_normal"]
    rn = rn * torch.rsqrt(torch.sum(rn * rn, dim=0, keepdim=True) + 1e-12)
    c2w = _c2w(world_view, rn.device)
    normal_world = (c2w[:3, :3] @ rn.reshape(3, -1)).reshape(rn.shape)
    dn = depth_to_normal(world_view, out["rendered_depth"], cfg.resolution,
                         cfg.resolution, cfg.tan_fov, cfg.tan_fov)
    return {
        "render": out["render"],
        "rendered_normal": normal_world,
        "rendered_depth": out["rendered_depth"],
        "depth_normal": dn,
        "rendered_alpha": out["rendered_alpha"],
        "distortion_map": out["distortion_map"],
        "radii": out["radii"],
        "visibility_filter": out["radii"] > 0,
        "overflow": out["overflow"],
    }


def render_views_batched(gaussians: dict, world_views, full_projs,
                         cam_centers, bg, cfg: PipelineConfig, device=None):
    """Render every (batch element, view) pair.

    gaussians: dict of (B, P, ...) tensors; world_views/full_projs:
    (V, 4, 4) and cam_centers (V, 3) numpy arrays; bg: (3,).  Returns a
    dict of (B, V, ...) tensors, including the (B, V) bool `overflow` map,
    which callers must check: a static-cap truncation is otherwise silent."""
    dev = resolve_device(device, gaussians["xyz"])
    gaussians = {k: v.to(dev) for k, v in gaussians.items()}
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    B = gaussians["xyz"].shape[0]
    rows = []
    for wv, fp, cc in zip(world_views, full_projs, cam_centers):
        per_b = []
        for b in range(B):
            out = render_gaussians(gaussians, b, wv, fp, cc, bg, cfg)
            out.pop("radii"), out.pop("visibility_filter")
            per_b.append(out)
        rows.append({k: torch.stack([o[k] for o in per_b]) for k in per_b[0]})
    return {k: torch.stack([r[k] for r in rows], 1) for k in rows[0]}
