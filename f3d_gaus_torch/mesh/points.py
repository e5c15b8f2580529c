"""Tetrahedralization seed points from a Gaussian set + frustum culling
(a numpy copy of f3d_gaus_tpu/mesh/points.py).

Counterpart of get_tetra_points / get_frustum_mask
(reference visualize.py:72-144): per Gaussian, the 8 corners of its
oriented 3-sigma box plus its center, masked to points visible from at
least one context camera.
"""
from __future__ import annotations

import numpy as np


def quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    """Rotation matrix for quaternion(s) (..., 4) -> (..., 3, 3), (w, x, y,
    z), not normalised (core/quaternions.py's formula, in numpy)."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z),
                     2 * (x * z + r * y)], -1)
    row1 = np.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - r * x)], -1)
    row2 = np.stack([2 * (x * z - r * y), 2 * (y * z + r * x),
                     1 - 2 * (x * x + y * y)], -1)
    return np.stack([row0, row1, row2], -2)

# unit-box corners, the [-1, 1]^3 cube (trimesh.creation.box() * 2)
_CORNERS = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                     for z in (-1, 1)], np.float32)


def frustum_mask(points: np.ndarray, world_views: np.ndarray,
                 fov_deg: float, near: float = 0.02, far: float = 1e6,
                 resolution: int = 256) -> np.ndarray:
    """True for points inside >= 1 camera frustum (visualize.py:72-117).

    points: (N, 3); world_views: (V, 4, 4) row-vector-layout view matrices.
    The reference computes focal via fov2focal with the fov accidentally
    passed in DEGREES (visualize.py:76: `fov2focal(fov, 256)` with
    `config['model']['fov']`), i.e. tan(fov_deg/2 interpreted as radians) —
    an effective focal of ~415 instead of the intended ~1110 at fov 13.164,
    so the reference's mask is much WIDER than the true frustum.  We
    reproduce that effective (wide) mask for parity: the mask only gates
    which Delaunay seed points exist, and using the intended geometry here
    would CULL seed points the reference keeps, changing mesh topology near
    frustum edges.
    """
    focal = resolution / (2.0 * np.tan(fov_deg / 2.0))
    pts_h = np.concatenate([points, np.ones_like(points[:, :1])], -1)
    # row-vector layout: p_view = p @ world_view
    view = np.einsum('nc,vck->vnk', pts_h, world_views)[..., :3]   # (V, N, 3)
    z = view[..., 2]
    u = view[..., 0] / np.maximum(z, 1e-12) * focal + resolution / 2.0
    v = view[..., 1] / np.maximum(z, 1e-12) * focal + resolution / 2.0
    ok = ((z >= near) & (z <= far) & (u >= 0) & (u <= resolution - 1)
          & (v >= 0) & (v <= resolution - 1))
    return ok.any(0)


def tetra_points(xyz: np.ndarray, scaling: np.ndarray, rotation: np.ndarray,
                 world_views: np.ndarray, fov_deg: float,
                 near: float = 0.02, far: float = 1e6,
                 resolution: int = 256):
    """Seed points for Delaunay: 8 oriented-box corners at 3x scale + the
    center, per Gaussian (visualize.py:119-144).  Returns (points (M, 3),
    point_scales (M,)) after frustum masking.

    xyz: (P, 3); scaling: (P, 3) activated scales; rotation: (P, 4)
    normalized quaternions; world_views: (V, 4, 4).
    """
    xyz = np.asarray(xyz, np.float32)
    scale3 = np.abs(np.asarray(scaling, np.float32)) * 3.0
    R = quat_to_rotmat(np.asarray(rotation, np.float32))

    corners = _CORNERS[None] * scale3[:, None, :]          # (P, 8, 3)
    corners = np.einsum('pij,pkj->pki', R, corners) + xyz[:, None]
    pts = np.concatenate([corners.reshape(-1, 3), xyz], 0)

    smax = scale3.max(-1)                                  # (P,)
    pscale = np.concatenate([np.repeat(smax, 8), smax], 0)

    mask = frustum_mask(pts, np.asarray(world_views, np.float32),
                        fov_deg, near, far, resolution)
    return pts[mask], pscale[mask]
