# Frozen copy of f3d_gaus_torch/train/losses.py at commit b6ed6e2, the
# benchmark's plain reference; imports rewritten for this flat package.
"""Image losses: L1, SSIM, PSNR, total variation, masked L1, normal
consistency and the warping resample (counterpart of
f3d_gaus_tpu/train/losses.py).

Parity targets: the reference trainer's loss utilities (l1_loss, 11x11
Gaussian-window SSIM with C1 = 0.01^2, C2 = 0.03^2, PSNR).  Plain PyTorch
ops: none of these is a kernel of the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .device import abs_tie


def l1(a, b):
    return abs_tie(a - b).mean()


def psnr(a, b):
    mse = ((a - b) ** 2).reshape(a.shape[0], -1).mean(-1)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


def _gaussian_window(size=11, sigma=1.5):
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2 * sigma ** 2))
    g = (g / g.sum()).astype(np.float32)
    return np.outer(g, g)


_WINDOW = _gaussian_window()


def tv(x):
    """Total variation on (..., H, W) maps (yaml opt.w_tv)."""
    dh = abs_tie(x[..., 1:, :] - x[..., :-1, :]).mean()
    dw = abs_tie(x[..., :, 1:] - x[..., :, :-1]).mean()
    return dh + dw


def masked_l1(a, b, mask, eps=1e-6):
    """L1 over a validity mask (depth/warping losses).  `mask` broadcasts
    against a/b (e.g. (B, 1, H, W) against (B, 3, H, W))."""
    shape = torch.broadcast_shapes(a.shape, b.shape, mask.shape)
    m = mask.to(a.dtype).expand(shape)
    return (abs_tie(a - b) * m).sum() / (m.sum() + eps)


def normal_consistency(n1, n2, mask=None):
    """1 - cos between two normal maps (..., 3, H, W): the GOF
    depth-normal consistency regularizer."""
    err = 1.0 - (n1 * n2).sum(-3)
    if mask is not None:
        m = mask.to(err.dtype)
        return (err * m).sum() / (m.sum() + 1e-6)
    return err.mean()


def _as_f32(x, device):
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def warp_from_view(src_img, src_world_view, src_full_proj, depth,
                   dst_world_view, width, height, tan_fovx, tan_fovy):
    """Backproject the destination view's depth map and sample the source
    image bilinearly: the warping loss's resampling step (yaml
    opt.w_warping).

    src_img: (3, H, W) tensor; depth: (1, H, W) tensor of the destination
    view; src_world_view, src_full_proj and dst_world_view: (4, 4) float32
    camera matrices (row-vector layout, numpy).  Returns (warped (3, H, W),
    valid (H, W) bool in-bounds mask)."""
    dev = src_img.device
    fx = width / (2.0 * tan_fovx)
    fy = height / (2.0 * tan_fovy)
    gy, gx = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(width, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij")
    rays = torch.stack([(gx - width / 2.0) / fx, (gy - height / 2.0) / fy,
                        torch.ones_like(gx)], -1)               # (H, W, 3) cam
    c2w = _as_f32(np.linalg.inv(np.asarray(dst_world_view, np.float32).T), dev)
    pts = (depth[0][..., None] * rays) @ c2w[:3, :3].T + c2w[:3, 3]

    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], -1).reshape(-1, 4)
    clip = ph @ _as_f32(src_full_proj, dev)                     # row-vector
    w = clip[:, 3:4] + 1e-7
    ndc = clip[:, :2] / w
    u = ((ndc[:, 0] + 1) * width - 1) * 0.5
    v = ((ndc[:, 1] + 1) * height - 1) * 0.5
    z = (ph @ _as_f32(src_world_view, dev))[:, 2]

    u0, v0 = torch.floor(u), torch.floor(v)
    du, dv = (u - u0)[None], (v - v0)[None]
    # out-of-range samples are masked by `valid`; clamp before the integer
    # conversion so no float overflows an int
    u0i = u0.clamp(-1, width).long().clamp(0, width - 1)
    v0i = v0.clamp(-1, height).long().clamp(0, height - 1)
    u1i = (u0i + 1).clamp(0, width - 1)
    v1i = (v0i + 1).clamp(0, height - 1)
    img = src_img
    s00, s01 = img[:, v0i, u0i], img[:, v0i, u1i]
    s10, s11 = img[:, v1i, u0i], img[:, v1i, u1i]
    warped = ((1 - dv) * ((1 - du) * s00 + du * s01)
              + dv * ((1 - du) * s10 + du * s11))
    valid = ((u >= 0) & (u <= width - 1) & (v >= 0) & (v <= height - 1)
             & (z > 0))
    return warped.reshape(3, height, width), valid.reshape(height, width)


def ssim(img1, img2, c1=0.01 ** 2, c2=0.03 ** 2):
    """Mean SSIM over (B, C, H, W) images: the 3DGS training loss term.
    11x11 Gaussian window, per-channel depthwise filtering with zero
    padding 5."""
    C = img1.shape[1]
    w = torch.as_tensor(_WINDOW, device=img1.device).expand(C, 1, 11, 11)

    def filt(x):
        return F.conv2d(x, w, padding=5, groups=C)

    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = filt(img1 * img1) - mu1_sq
    s2 = filt(img2 * img2) - mu2_sq
    s12 = filt(img1 * img2) - mu12
    m = (((2 * mu12 + c1) * (2 * s12 + c2))
         / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2)))
    return m.mean()
