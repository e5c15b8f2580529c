"""The cells' inputs, made from the seed: RGB-D images for the predictor,
and a NeRF-synthetic-shaped scene for the per-scene fit (cameras on the
upper hemisphere, targets ray-cast from an analytic scene, the random
init cloud).

`smooth_rgbd` and `hemisphere_c2w` are copies of chip_smoke.py's (commit
b6ed6e2); the scene's shapes and colours are those of chip_smoke.py:
surface_gaussians, here ray-cast exactly instead of splatted; the cameras
follow f3d_gaus_torch/pipeline/scene_io.py:read_blender_scene at the same
commit, through the reference's copy of core/cameras.py.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def smooth_rgbd(rng, r):
    """A smooth random RGB image in [0, 1] and a depth map normalised to
    [6.667, 8.667] (the demo dataset's depth range), both (1, r, r, ...)."""
    yy, xx = np.meshgrid(np.linspace(0, 1, r), np.linspace(0, 1, r),
                         indexing="ij")

    def field():
        f = sum(np.cos(2 * np.pi * (rng.uniform(0.5, 3) * xx
                                    + rng.uniform(0.5, 3) * yy
                                    + rng.uniform())) * rng.uniform(0.2, 1)
                for _ in range(4))
        return (f - f.min()) / (f.max() - f.min())
    img = np.stack([field() for _ in range(3)], -1)
    img = np.clip(img + rng.normal(size=img.shape) * 0.02, 0, 1)
    depth = field() * 2.0 + 6.667
    return img[None].astype(np.float32), depth[None].astype(np.float32)


def hemisphere_c2w(n, radius):
    """n Blender camera-to-world matrices on the upper hemisphere (z up) at
    `radius`, elevations 10-75 degrees on a golden-angle spiral, each
    looking at the origin (OpenGL axes: -z forward, y up)."""
    out = []
    for i in range(n):
        el = np.radians(10 + 65 * (i + 0.5) / n)
        az = i * np.pi * (3 - np.sqrt(5))
        p = radius * np.array([np.cos(el) * np.cos(az),
                               np.cos(el) * np.sin(az), np.sin(el)])
        f = -p / np.linalg.norm(p)
        r = np.cross(f, [0.0, 0.0, 1.0])
        r /= np.linalg.norm(r)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([r, np.cross(r, f), -f], 1)
        c2w[:3, 3] = p
        out.append(c2w)
    return out


def blender_cameras(camera_type, c2ws, angle_x, width, height,
                    znear=0.01, zfar=100.0):
    """Cameras as read_blender_scene builds them from Blender c2w matrices
    (y and z axes flipped to COLMAP's, square pixels), of `camera_type`
    (the reference's Camera or the program's: the same fields)."""
    from .reference.cameras import projection_matrix
    out = []
    for m in c2ws:
        c2w = np.array(m, np.float32)
        c2w[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w)
        fovx = angle_x
        fovy = 2.0 * math.atan(height / (2.0 * (width / (2 * math.tan(
            fovx / 2)))))
        world_view = np.eye(4, dtype=np.float32)
        world_view[:3, :3] = w2c[:3, :3]
        world_view[:3, 3] = w2c[:3, 3]
        world_view = world_view.T.astype(np.float32)
        full_proj = (world_view @ projection_matrix(
            znear, zfar, fovx, fovy).T).astype(np.float32)
        center = np.linalg.inv(world_view)[3, :3].astype(np.float32)
        out.append(camera_type(world_view, full_proj, center, width,
                               height, math.tan(fovx / 2),
                               math.tan(fovy / 2)))
    return out


def nerfpp_radius(cameras) -> float:
    """1.1 x the largest distance of a camera centre from their centroid
    (scene_io._nerfpp_radius): the fit's scene extent."""
    centers = np.stack([c.cam_center for c in cameras])
    return float(np.linalg.norm(centers - centers.mean(0), axis=-1).max()
                 * 1.1)


def random_init(rng, n):
    """3DGS's random init cloud for NeRF-synthetic: n points uniform in
    [-1.3, 1.3]^3 with uniform colours (scene_io.read_blender_scene)."""
    pts = rng.random((n, 3), np.float32) * 2.6 - 1.3
    cols = rng.random((n, 3)).astype(np.float32)
    return pts, cols


# the analytic scene: a checkered ground square, a sphere coloured by its
# normal and a striped box (chip_smoke.py:surface_gaussians), black beyond
GROUND_Z = -0.6
SPHERE_C, SPHERE_R = (0.3, -0.25, -0.1), 0.45
BOX_C, BOX_H = (-0.45, 0.4, -0.3), 0.3


def _rays(cam, device):
    """Pixel-centre rays of one camera (3DGS's pixel convention: pixel i
    at NDC (2i + 1) / S - 1): origins (3,) and unit directions (H, W, 3)
    in world space."""
    wv = torch.as_tensor(cam.world_view, device=device, dtype=torch.float64)
    ys = (2 * torch.arange(cam.height, device=device, dtype=torch.float64)
          + 1) / cam.height - 1
    xs = (2 * torch.arange(cam.width, device=device, dtype=torch.float64)
          + 1) / cam.width - 1
    gy, gx = torch.meshgrid(ys * cam.tan_fovy, xs * cam.tan_fovx,
                            indexing="ij")
    d_cam = torch.stack([gx, gy, torch.ones_like(gx)], -1)
    # world_view is the row-vector w2c: x_view = x_world @ wv[:3, :3] + t
    d = d_cam @ wv[:3, :3].T
    d = d / d.norm(dim=-1, keepdim=True)
    o = torch.as_tensor(cam.cam_center, device=device, dtype=torch.float64)
    return o, d


def raycast(cam, device):
    """The analytic scene seen by `cam`: a (3, H, W) float32 image on
    `device`, the nearest surface's colour at each pixel centre."""
    o, d = _rays(cam, device)
    inf = torch.full(d.shape[:2], float("inf"), device=device,
                     dtype=torch.float64)
    best, col = inf.clone(), torch.zeros(d.shape, device=device,
                                         dtype=torch.float64)

    def take(t, c):
        nonlocal best, col
        hit = t < best
        best = torch.where(hit, t, best)
        col = torch.where(hit[..., None], c, col)

    # ground square z = GROUND_Z, |x|, |y| <= 1
    t = (GROUND_Z - o[2]) / d[..., 2]
    p = o + t[..., None] * d
    ok = (t > 0) & (p[..., 0].abs() <= 1) & (p[..., 1].abs() <= 1)
    check = (torch.floor(p[..., 0] / 0.25) + torch.floor(p[..., 1] / 0.25)) % 2
    c = torch.where(check[..., None] > 0, p.new_tensor([0.85, 0.8, 0.7]),
                    p.new_tensor([0.2, 0.3, 0.5]))
    take(torch.where(ok, t, inf), c + 0.08 * torch.sin(9 * p[..., :1]))
    # sphere
    sc = o.new_tensor(SPHERE_C)
    oc = o - sc
    b = (d * oc).sum(-1)
    disc = b * b - (oc * oc).sum() + SPHERE_R ** 2
    t = -b - torch.sqrt(disc.clamp_min(0))
    ok = (disc > 0) & (t > 0)
    n = (o + t[..., None] * d - sc) / SPHERE_R
    take(torch.where(ok, t, inf), 0.5 + 0.4 * n)
    # box (slab test), stripes on the local coordinates
    bc = o.new_tensor(BOX_C)
    inv = 1.0 / d
    t0 = (bc - BOX_H - o) * inv
    t1 = (bc + BOX_H - o) * inv
    tn = torch.minimum(t0, t1).amax(-1)
    tf = torch.maximum(t0, t1).amin(-1)
    ok = (tn <= tf) & (tn > 0)
    local = (o + tn[..., None] * d - bc) / BOX_H
    take(torch.where(ok, tn, inf),
         0.5 + 0.4 * torch.sin(12 * local[..., [1, 2, 0]]))
    return col.clamp(0, 1).permute(2, 0, 1).float().contiguous()
