"""Spherical-harmonics color evaluation and the degree-1 SH frame
rotation (counterpart of f3d_gaus_tpu/core/sh.py).

shs has shape (..., K, 3) with K = (deg+1)^2, band order (0,0), (1,-1),
(1,0), (1,1), ...  Colors are `max(SH(dir) + 0.5, 0)`.
`transform_shs_deg1` is the one definition of the rotation in the port:
models/predictor.py calls it (the JAX package keeps a second copy in its
models/predictor.py).
"""
from __future__ import annotations

import torch

from .device import max_tie

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def eval_sh(deg: int, shs: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Evaluate SH color. shs: (..., K, 3); dirs: (..., 3) unit vectors.
    Returns the un-clamped color + 0.5."""
    result = SH_C0 * shs[..., 0, :]
    if deg > 0:
        x = dirs[..., 0:1]
        y = dirs[..., 1:2]
        z = dirs[..., 2:3]
        result = (result - SH_C1 * y * shs[..., 1, :]
                  + SH_C1 * z * shs[..., 2, :] - SH_C1 * x * shs[..., 3, :])
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (result
                      + SH_C2[0] * xy * shs[..., 4, :]
                      + SH_C2[1] * yz * shs[..., 5, :]
                      + SH_C2[2] * (2.0 * zz - xx - yy) * shs[..., 6, :]
                      + SH_C2[3] * xz * shs[..., 7, :]
                      + SH_C2[4] * (xx - yy) * shs[..., 8, :])
            if deg > 2:
                result = (result
                          + SH_C3[0] * y * (3.0 * xx - yy) * shs[..., 9, :]
                          + SH_C3[1] * xy * z * shs[..., 10, :]
                          + SH_C3[2] * y * (4.0 * zz - xx - yy) * shs[..., 11, :]
                          + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy)
                          * shs[..., 12, :]
                          + SH_C3[4] * x * (4.0 * zz - xx - yy) * shs[..., 13, :]
                          + SH_C3[5] * z * (xx - yy) * shs[..., 14, :]
                          + SH_C3[6] * x * (xx - 3.0 * yy) * shs[..., 15, :])
    return result + 0.5


def sh_color_from_gaussians(deg: int, shs: torch.Tensor, means: torch.Tensor,
                            campos: torch.Tensor):
    """Per-Gaussian RGB from SH, viewing direction mean - campos.
    Returns (rgb clamped at 0, clamped mask)."""
    dirs = means - campos
    # smoothed norm: a Gaussian AT the camera (unet_depth 0 in the cycle
    # feed) has |dirs| = 0; sqrt(|d|^2 + eps) keeps the value finite (such
    # points are frustum-culled downstream), as in the JAX package.  |d|^2
    # is summed left to right, written out so that the order is this
    # code's and not a reduction's (csrc/preprocess.cu adds in this order)
    sq = dirs * dirs
    norm = torch.sqrt(sq[..., 0:1] + sq[..., 1:2] + sq[..., 2:3] + 1e-16)
    dirs = dirs / norm
    raw = eval_sh(deg, shs, dirs)
    return max_tie(raw, 0.0), raw < 0


# --- degree-1 SH frame rotation -------------------------------------------
# The feed-forward predictor emits SH in camera space and rotates band-1
# coefficients to world space by conjugating the camera rotation with the
# (v <-> SH basis) permutation (reference gaussian_predictor.py:821-837).

V_TO_SH = torch.tensor([[0., 0., -1.], [-1., 0., 0.], [0., 1., 0.]])
SH_TO_V = V_TO_SH.T


def transform_shs_deg1(features_rest: torch.Tensor,
                       cam_to_world: torch.Tensor) -> torch.Tensor:
    """Rotate degree-1 SH coefficients from the camera to the world frame.
    features_rest: (B, N, 3, 3) [sh, rgb]; cam_to_world: (B, 4, 4) in the
    row-vector layout (its top-left 3x3 is used as the reference
    multiplies it).  Returns (B, N, 3, 3)."""
    t = (SH_TO_V.to(cam_to_world) @ cam_to_world[:, :3, :3]
         @ V_TO_SH.to(cam_to_world))                      # (B, 3, 3)
    s = features_rest.transpose(-1, -2)                    # (B, N, rgb, sh)
    s = torch.einsum("bnrs,bst->bnrt", s, t)
    return s.transpose(-1, -2)                             # (B, N, sh, rgb)
