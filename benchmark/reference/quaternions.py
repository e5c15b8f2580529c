# Frozen copy of f3d_gaus_torch/core/quaternions.py at commit b6ed6e2, the
# benchmark's plain reference; imports rewritten for this flat package.
"""Quaternion utilities on tensors (counterpart of
f3d_gaus_tpu/core/quaternions.py).

Quaternions are (w, x, y, z), real part first, and are not normalized
implicitly; the predictor normalizes before handing them to the renderer.
`rotmat_to_quat` is the differentiable tensor version; core/cameras.py
keeps a numpy copy for the numpy camera code.
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


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4), (w, x, y, z).

    The branch-free four-case algorithm of the JAX package (reference
    src/dataio_gs_test_256_demo.py:262-297): every candidate is computed
    and the numerically safest is selected with torch.where, so it is
    differentiable; sqrt(max(x, 1e-12)) takes max_tie's gradient.
    core/cameras.py:rotmat_to_quat is the numpy copy the camera code uses.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = 1.0 + m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(max_tie(x, 1e-12))

    # case 0: trace positive
    r0 = safe_sqrt(tr) / 2.0
    q0 = torch.stack([r0, (m21 - m12) / (4 * r0), (m02 - m20) / (4 * r0),
                      (m10 - m01) / (4 * r0)], -1)
    # case 1: m00 dominant
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                      (m02 + m20) / s1], -1)
    # case 2: m11 dominant
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                      (m12 + m21) / s2], -1)
    # case 3: m22 dominant
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                      0.25 * s3], -1)

    use0 = (tr > 0)[..., None]
    use1 = ((m00 > m11) & (m00 > m22))[..., None]
    use2 = (m11 > m22)[..., None]
    return torch.where(use0, q0, torch.where(use1, q1,
                                             torch.where(use2, q2, q3)))
