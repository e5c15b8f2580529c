"""Quaternion utilities on tensors (counterpart of
f3d_gaus_tpu/core/quaternions.py).

Quaternions are (w, x, y, z), real part first, and are not normalized
implicitly; the predictor normalizes before handing them to the renderer.
"""
from __future__ import annotations

import torch

from .device import max_tie


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix for quaternion(s) (..., 4) -> (..., 3, 3)."""
    r, x, y, z = q.unbind(-1)
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z),
                        2 * (x * z + r * y)], -1)
    row1 = torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z),
                        2 * (y * z - r * x)], -1)
    row2 = torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x),
                        1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], -2)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternions, broadcasting over leading dims."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    ow = aw * bw - ax * bx - ay * by - az * bz
    ox = aw * bx + ax * bw + ay * bz - az * by
    oy = aw * by - ax * bz + ay * bw + az * bx
    oz = aw * bz + ax * by - ay * bx + az * bw
    return torch.stack([ow, ox, oy, oz], -1)


def quat_normalize(q: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    return q / (max_tie(n, eps) if eps else n)
