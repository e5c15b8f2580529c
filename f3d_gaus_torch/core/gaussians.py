"""Per-Gaussian geometry: covariances, projection, and the GOF
view->Gaussian ray-quadratic precompute (counterpart of
f3d_gaus_tpu/core/gaussians.py).

Everything is vectorized over the Gaussian axis in structure-of-arrays
form: per-component (P,) tensors combined with scalar camera entries, the
same order of operations as the JAX package so the two agree to f32
rounding.  Camera matrices arrive as float32 numpy arrays; their entries
enter the arithmetic as Python floats, which are exact copies of the f32
values.

Matrix convention: `world_view` is the row-vector-layout matrix described
in core/cameras.py.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .device import clip_tie, max_tie

NEAR_PLANE = 0.2   # auxiliary.h:27
FAR_PLANE = 100.0  # auxiliary.h:28


def _scalar_over(num: float, den: torch.Tensor) -> torch.Tensor:
    """num / den as a true division (a Python scalar divided by a tensor
    is computed as reciprocal(den) * num, which rounds differently)."""
    return torch.full((), num, dtype=den.dtype, device=den.device) / den


def _mat(m) -> list:
    """A float32 camera matrix as nested Python floats (exact f32 values);
    a (V, 4, 4) float32 tensor of V cameras as nested (V, 1) tensors,
    which broadcast over the Gaussians to the same f32 arithmetic."""
    if torch.is_tensor(m):
        return [[m[:, i, j, None] for j in range(4)] for i in range(4)]
    return np.asarray(m, np.float32).astype(np.float64).tolist()


def _rotmat_comps(q):
    """Quaternion (..., 4) -> 9 row-major rotation components, each (...,)."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
            2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
            2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y))


def build_cov3d(scales: torch.Tensor, quats: torch.Tensor,
                scale_modifier: float = 1.0) -> torch.Tensor:
    """World-space covariance R S^2 R^T as its 6 upper-triangular entries
    (xx, xy, xz, yy, yz, zz)."""
    R = _rotmat_comps(quats)
    s0 = scales[..., 0] * scale_modifier
    s1 = scales[..., 1] * scale_modifier
    s2 = scales[..., 2] * scale_modifier
    m = [R[0] * s0, R[1] * s1, R[2] * s2,
         R[3] * s0, R[4] * s1, R[5] * s2,
         R[6] * s0, R[7] * s1, R[8] * s2]

    def dot(i, j):
        return m[3 * i] * m[3 * j] + m[3 * i + 1] * m[3 * j + 1] \
            + m[3 * i + 2] * m[3 * j + 2]
    return torch.stack([dot(0, 0), dot(0, 1), dot(0, 2),
                        dot(1, 1), dot(1, 2), dot(2, 2)], -1)


def _gaussian_to_view(means, quats, wv):
    """(Rv 9 comps row-major, t2 3 comps, t 3 comps): Rv = Rw2v . R is the
    gaussian->view rotation, t2 = -Rv^T t the camera origin in the gaussian
    frame.  wv: nested-float world_view."""
    R = _rotmat_comps(quats)
    w = [[wv[j][i] for j in range(3)] for i in range(3)]
    tw = [wv[3][0], wv[3][1], wv[3][2]]
    m0, m1, m2 = means[..., 0], means[..., 1], means[..., 2]
    t = [m0 * w[i][0] + m1 * w[i][1] + m2 * w[i][2] + tw[i] for i in range(3)]
    Rv = [w[i][0] * R[j] + w[i][1] * R[3 + j] + w[i][2] * R[6 + j]
          for i in range(3) for j in range(3)]
    t2 = [-(Rv[i] * t[0] + Rv[3 + i] * t[1] + Rv[6 + i] * t[2])
          for i in range(3)]
    return Rv, t2, t


def view2gaussian_mb(means, scales, quats, world_view):
    """Cancellation-free packing of the GOF ray quadratic: M = S^-1 Rv^T
    (P, 3, 3) and b = S^-1 t2 (P, 3), float32.  For a view ray d the scaled
    Gaussian-frame point is t (M d) + b, so with a = M d: AA = |a|^2,
    BB = 2 a.b, min_value = |a x b|^2 / |a|^2, normal = M^T a.  Kept in f32
    (no f64 CC - BB^2/4AA)."""
    Rv, t2, _ = _gaussian_to_view(means, quats, _mat(world_view))
    sf = scales.float()
    si = [1.0 / torch.sqrt(sf[..., i] ** 2 + 1e-7) for i in range(3)]
    M = torch.stack([si[i] * Rv[3 * j + i] for i in range(3) for j in range(3)],
                    -1).reshape(*means.shape[:-1], 3, 3)
    b = torch.stack([si[i] * t2[i] for i in range(3)], -1)
    return M.float(), b.float()


def view2gaussian(means, scales, quats, world_view) -> torch.Tensor:
    """The 10-float CUDA-layout ray-quadratic precompute
    [A00 A01 A02 A11 A12 A22 Bx By Bz C] (only the test oracle reads it)."""
    Rv, t2, _ = _gaussian_to_view(means, quats, _mat(world_view))
    s_inv2 = [1.0 / (scales.float()[..., i] ** 2 + 1e-7) for i in range(3)]
    C = t2[0] * t2[0] * s_inv2[0] + t2[1] * t2[1] * s_inv2[1] \
        + t2[2] * t2[2] * s_inv2[2]
    B = [Rv[3 * i] * s_inv2[0] * t2[0] + Rv[3 * i + 1] * s_inv2[1] * t2[1]
         + Rv[3 * i + 2] * s_inv2[2] * t2[2] for i in range(3)]

    def a(i, j):
        return Rv[3 * i] * s_inv2[0] * Rv[3 * j] \
            + Rv[3 * i + 1] * s_inv2[1] * Rv[3 * j + 1] \
            + Rv[3 * i + 2] * s_inv2[2] * Rv[3 * j + 2]
    return torch.stack([a(0, 0), a(0, 1), a(0, 2), a(1, 1), a(1, 2), a(2, 2),
                        B[0], B[1], B[2], C], -1).float()


def project_points(means, world_view, full_proj):
    """(p_view (P,3), p_ndc (P,3)), row-vector convention, +1e-7 on w."""
    wv, fp = _mat(world_view), _mat(full_proj)
    m0, m1, m2 = means[..., 0], means[..., 1], means[..., 2]

    def col(M, j):
        return m0 * M[0][j] + m1 * M[1][j] + m2 * M[2][j] + M[3][j]
    p_view = torch.stack([col(wv, j) for j in range(3)], -1)
    p_w = 1.0 / (col(fp, 3) + 1e-7)
    p_ndc = torch.stack([col(fp, j) * p_w for j in range(3)], -1)
    return p_view, p_ndc


def ndc_to_pix(v: torch.Tensor, size: int) -> torch.Tensor:
    """((v + 1) * S - 1) / 2  (auxiliary.h:59-62)."""
    return ((v + 1.0) * size - 1.0) * 0.5


def cov2d_and_coef(means, cov3d6, world_view, focal_x: float, focal_y: float,
                   tan_fovx: float, tan_fovy: float, kernel_size: float):
    """EWA screen-space covariance [xx, xy, yy] (kernel added) and the GOF
    low-pass opacity coefficient (computeCov2D, forward.cu:74-124)."""
    wv = _mat(world_view)
    m0, m1, m2 = means[..., 0], means[..., 1], means[..., 2]
    t = [m0 * wv[0][j] + m1 * wv[1][j] + m2 * wv[2][j] + wv[3][j]
         for j in range(3)]
    limx, limy = 1.3 * tan_fovx, 1.3 * tan_fovy
    # z floor: Gaussians behind/at the camera are frustum-culled downstream,
    # but the vectorized path must still give them finite values
    tz = max_tie(t[2], 1e-4)
    tx = clip_tie(t[0] / tz, -limx, limx) * tz
    ty = clip_tie(t[1] / tz, -limy, limy) * tz

    j00 = _scalar_over(focal_x, tz)
    j02 = -(focal_x * tx) / (tz * tz)
    j11 = _scalar_over(focal_y, tz)
    j12 = -(focal_y * ty) / (tz * tz)

    Wc = [[wv[j][i] for j in range(3)] for i in range(3)]
    r0 = [j00 * Wc[0][k] + j02 * Wc[2][k] for k in range(3)]
    r1 = [j11 * Wc[1][k] + j12 * Wc[2][k] for k in range(3)]
    c = cov3d6
    V = [[c[..., 0], c[..., 1], c[..., 2]],
         [c[..., 1], c[..., 3], c[..., 4]],
         [c[..., 2], c[..., 4], c[..., 5]]]

    def quad(a_, b_):
        out = 0.0
        for i in range(3):
            vb = V[i][0] * b_[0] + V[i][1] * b_[1] + V[i][2] * b_[2]
            out = out + a_[i] * vb
        return out
    cxx = quad(r0, r0)
    cxy = quad(r0, r1)
    cyy = quad(r1, r1)

    det0 = max_tie(cxx * cyy - cxy * cxy, 1e-6)
    det1 = max_tie((cxx + kernel_size) * (cyy + kernel_size) - cxy * cxy,
                   1e-6)
    coef = torch.sqrt(det0 / (det1 + 1e-6) + 1e-6)
    coef = torch.where((det0 <= 1e-6) | (det1 <= 1e-6),
                       torch.zeros_like(coef), coef)
    cov2d = torch.stack([cxx + kernel_size, cxy, cyy + kernel_size], -1)
    return cov2d, coef


def screen_extent(cov2d: torch.Tensor):
    """(conic (P,3), 3-sigma radius (P,), det (P,)) from the 2D covariance."""
    cxx, cxy, cyy = cov2d[..., 0], cov2d[..., 1], cov2d[..., 2]
    det = cxx * cyy - cxy * cxy
    det_inv = torch.where(det == 0.0, torch.zeros_like(det), 1.0 / det)
    conic = torch.stack([cyy * det_inv, -cxy * det_inv, cxx * det_inv], -1)
    mid = 0.5 * (cxx + cyy)
    lambda1 = mid + torch.sqrt(max_tie(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lambda1))
    return conic, radius, det


class Preprocessed(NamedTuple):
    """Per-Gaussian render-ready quantities."""
    depths: torch.Tensor        # (P,)  view-space z
    means2d: torch.Tensor       # (P, 2) pixel coords
    conic: torch.Tensor         # (P, 3) inverse 2D covariance
    opa_coef: torch.Tensor      # (P,)  opacity * lowpass coefficient
    rgb: torch.Tensor           # (P, 3) SH-evaluated color
    clamped: torch.Tensor       # (P, 3) SH clamp mask
    v2g: torch.Tensor | None    # (P, 10) CUDA-layout precompute (on request)
    v2g_mb: torch.Tensor        # (P, 12) stable packing: M.reshape(9) ++ b
    radii: torch.Tensor         # (P,)  int32 screen radius (0 = culled)
    valid: torch.Tensor         # (P,)  bool — survives frustum/extent culling


def screen_footprints(means, scales, quats, world_views, full_projs,
                      camera: "Camera", kernel_size: float = 0.0,
                      scale_modifier: float = 1.0):
    """The means2d (V, P, 2) and radii (V, P) int32 that `preprocess` gives
    at V cameras at once, bit for bit: its expressions with the (V, 4, 4)
    world_views and full_projs broadcast over the Gaussians; `camera`
    gives the size and field of view all V share.  No colours and no ray
    quadratic: what sizing the binning needs."""
    dev = means.device
    wv = torch.as_tensor(np.asarray(world_views, np.float32), device=dev)
    fp = torch.as_tensor(np.asarray(full_projs, np.float32), device=dev)
    p_view, p_ndc = project_points(means, wv, fp)
    cov3d6 = build_cov3d(scales, quats, scale_modifier)
    cov2d, _ = cov2d_and_coef(means, cov3d6, wv, camera.focal_x,
                              camera.focal_y, camera.tan_fovx,
                              camera.tan_fovy, kernel_size)
    _, radius, det = screen_extent(cov2d)
    valid = (p_view[..., 2] > NEAR_PLANE) & (det != 0.0)
    radii = torch.where(valid, radius, torch.zeros_like(radius)).to(torch.int32)
    mean2d = torch.stack([ndc_to_pix(p_ndc[..., 0], camera.width),
                          ndc_to_pix(p_ndc[..., 1], camera.height)], -1)
    return mean2d, radii


def preprocess(means, scales, quats, opacities, shs, sh_degree: int, camera,
               kernel_size: float = 0.0, scale_modifier: float = 1.0,
               compute_v2g: bool = False) -> Preprocessed:
    """Full per-Gaussian preprocess (preprocessCUDA, forward.cu:284-404).
    `camera` is a core.cameras.Camera; the tensors fix the device.
    compute_v2g adds the 10-float CUDA-layout packing (test oracle only)."""
    from . import sh as shmod

    p_view, p_ndc = project_points(means, camera.world_view, camera.full_proj)
    in_front = p_view[..., 2] > NEAR_PLANE

    cov3d6 = build_cov3d(scales, quats, scale_modifier)
    cov2d, coef = cov2d_and_coef(means, cov3d6, camera.world_view,
                                 camera.focal_x, camera.focal_y,
                                 camera.tan_fovx, camera.tan_fovy, kernel_size)
    conic, radius, det = screen_extent(cov2d)
    nondegenerate = det != 0.0

    mean2d = torch.stack([ndc_to_pix(p_ndc[..., 0], camera.width),
                          ndc_to_pix(p_ndc[..., 1], camera.height)], -1)

    campos = torch.as_tensor(np.asarray(camera.cam_center, np.float32),
                             device=means.device)
    rgb, clamped = shmod.sh_color_from_gaussians(sh_degree, shs, means, campos)
    v2g = (view2gaussian(means, scales, quats, camera.world_view)
           if compute_v2g else None)
    M, b = view2gaussian_mb(means, scales, quats, camera.world_view)
    v2g_mb = torch.cat([M.reshape(M.shape[0], 9), b], -1)

    valid = in_front & nondegenerate
    radii = torch.where(valid, radius, torch.zeros_like(radius)).to(torch.int32)
    opa = opacities.reshape(opacities.shape[0]) * coef
    return Preprocessed(depths=p_view[..., 2], means2d=mean2d, conic=conic,
                        opa_coef=opa, rgb=rgb, clamped=clamped, v2g=v2g,
                        v2g_mb=v2g_mb, radii=radii, valid=valid)
