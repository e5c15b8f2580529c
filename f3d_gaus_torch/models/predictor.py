"""The feed-forward Gaussian predictor: SongUNet backbone + per-pixel
Gaussian parameter head + camera-space -> world-space lifting
(counterpart of f3d_gaus_tpu/models/predictor.py).

Parity target: GaussianSplatPredictor_gtunet with the shipped config
(network_with_offset): the head splits into [3 xyz-offset, 1 opacity,
3 scale, 4 rotation, 3 f_dc, 9 f_rest] with the per-group init table,
pos = ray_dirs * depth + offset, and the camera->world lifting rotates
positions, rotations (quaternion pre-multiply by cv2wT_quat) and degree-1 SH.
State_dict keys are `encoder.<reference name>` and `out.weight/bias`.

Not ported, by design: the JAX module's functional `init_params` /
`apply`; `GaussianPredictor(cfg, generator)` and its forward take their
place.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..core import sh
from ..core.quaternions import quat_multiply
from ..utils import profiling
from . import layers as L
from . import songunet


class PredictorConfig(NamedTuple):
    """The cfg['model'] keys the predictor consumes (yaml:114-157)."""
    resolution: int = 256
    fov_deg: float = 13.164
    base_dim: int = 128            # SongUNet img_resolution (naming) & width
    num_blocks: int = 3
    attn_resolutions: tuple = (16,)
    max_sh_degree: int = 1
    inverted_x: bool = False
    inverted_y: bool = True
    isotropic: bool = False
    opacity_scale: float = 0.001
    opacity_bias: float = -3.0
    scale_scale: float = 0.0005
    scale_bias: float = 0.01       # exp(log(scale_bias)) init target
    xyz_scale: float = 1e-6
    xyz_bias: float = 0.0
    cross_view_attention: bool = True
    in_channels: int = 4
    model_channels: int = 0        # 0 -> base_dim (the reference hardwires 128)


def split_dimensions(cfg: PredictorConfig):
    """[offset 3, opacity 1, scale 3, rotation 4, f_dc 3, f_rest 9] with the
    per-group (scale, bias) init of get_splits_and_inits(with_offset=True)."""
    splits = [3, 1, 3, 4, 3]
    scales = [cfg.xyz_scale, cfg.opacity_scale, cfg.scale_scale, 1.0, 5.0]
    biases = [cfg.xyz_bias, cfg.opacity_bias, math.log(cfg.scale_bias), 0.0, 0.0]
    if cfg.max_sh_degree != 0:
        splits.append(((cfg.max_sh_degree + 1) ** 2 - 1) * 3)
        scales.append(0.0)
        biases.append(0.0)
    return splits, scales, biases


def fov2focal(fov_rad: float, pixels: int) -> float:
    return pixels / (2.0 * math.tan(fov_rad / 2.0))


def ray_dirs_grid(cfg: PredictorConfig) -> np.ndarray:
    """(H, W, 3) unnormalized camera-space ray directions: pixel-center grid
    / focal, y flipped when inverted_y (true in the shipped config)."""
    r = cfg.resolution
    x = np.linspace(-r // 2 + 0.5, r // 2 - 0.5, r, dtype=np.float32)
    y = np.linspace(r // 2 - 0.5, -r // 2 + 0.5, r, dtype=np.float32)
    if cfg.inverted_x:
        x = -x
    if cfg.inverted_y:
        y = -y
    gx, gy = np.meshgrid(x, y, indexing="xy")
    focal = fov2focal(cfg.fov_deg * math.pi / 180.0, r)
    return np.stack([gx / focal, gy / focal, np.ones_like(gx)], axis=-1)


# the degree-1 SH rotation into world space (the JAX package keeps a copy
# here; the port's one definition is core/sh.py's)
transform_shs_deg1 = sh.transform_shs_deg1


def make_plan(cfg: PredictorConfig):
    splits, _, _ = split_dimensions(cfg)
    return songunet.make_plan(
        img_resolution=cfg.base_dim, in_channels=cfg.in_channels,
        out_channels=sum(splits),
        model_channels=cfg.model_channels or cfg.base_dim,
        num_blocks=cfg.num_blocks, attn_resolutions=tuple(cfg.attn_resolutions))


class GaussianPredictor(nn.Module):
    """UNet + the per-group-initialized 1x1 output conv."""

    def __init__(self, cfg: PredictorConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        splits, scales, biases = split_dimensions(cfg)
        total = sum(splits)
        self.encoder = songunet.SongUNet(make_plan(cfg), generator)
        self.out = L.Conv2d(total, total, 1, generator=generator)
        with torch.no_grad():
            ws, bs = [], []
            for s, b, ch in zip(scales, biases, splits):
                ws.append(L.xavier_uniform((ch, total, 1, 1), total, ch, s,
                                           generator))
                bs.append(torch.full((ch,), float(b)))
            self.out.weight.copy_(torch.cat(ws, 0))
            self.out.bias.copy_(torch.cat(bs, 0))
        self.register_buffer("ray_dirs", torch.from_numpy(ray_dirs_grid(cfg)),
                             persistent=False)

    @profiling.spanned("predictor")
    def forward(self, images, view_to_world, cv2wT_quat, unet_depth):
        """images: (B, N, H, W, 4) NHWC [rgb | ones]; view_to_world:
        (B, N, 4, 4) row-vector camera-to-world; cv2wT_quat: (B, N, 4);
        unet_depth: (B, N, H, W).

        Returns xyz (B, N·P, 3), opacity (B, N·P, 1), scaling (B, N·P, 3),
        rotation (B, N·P, 4), features_dc (B, N·P, 1, 3), features_rest
        (B, N·P, sh_rest, 3), unet_depth (B, N·P, 1), with P = H·W.
        Span `predictor` (utils.profiling)."""
        cfg = self.cfg
        B, N, H, W, Cin = images.shape
        n_views_xa = N if cfg.cross_view_attention else 1
        splits, _, _ = split_dimensions(cfg)

        x = images.reshape(B * N, H, W, Cin).permute(0, 3, 1, 2)
        feats = self.encoder(x, n_views_xa)
        out = self.out(feats).permute(0, 2, 3, 1)          # (B·N, H, W, total)
        offset, opacity, scaling, rotation, f_dc, *f_rest = out.split(splits, -1)

        depth = unet_depth.reshape(B * N, H, W, 1)
        pos = self.ray_dirs[None] * depth + offset          # camera space

        def flat(t):
            return t.reshape(B * N, H * W, t.shape[-1])

        # camera -> world: homogeneous row-vector matmul
        v2w = view_to_world.reshape(B * N, 4, 4)
        posf = flat(pos)
        ph = torch.cat([posf, torch.ones_like(posf[..., :1])], -1)
        pw = torch.bmm(ph, v2w)
        xyz = pw[..., :3] / (pw[..., 3:] + 1e-10)

        rot = flat(rotation)
        rot = rot / torch.linalg.norm(rot, dim=-1, keepdim=True)
        mq = cv2wT_quat.reshape(B * N, 1, 4)
        rot = quat_multiply(mq.expand_as(rot), rot)

        out_dict = {
            "xyz": xyz,
            "opacity": torch.sigmoid(flat(opacity)),
            "scaling": torch.exp(flat(scaling)),
            "rotation": rot,
            "features_dc": flat(f_dc)[:, :, None, :],
            "unet_depth": flat(depth),
        }
        if cfg.max_sh_degree > 0:
            fr = flat(f_rest[0])
            fr = fr.reshape(fr.shape[0], fr.shape[1], -1, 3)
            out_dict["features_rest"] = transform_shs_deg1(fr, v2w)
        else:
            out_dict["features_rest"] = out_dict["features_dc"].new_zeros(
                (B * N, H * W, 0, 3))

        # multi_view_union: (B·N, P, ...) -> (B, N·P, ...)
        return {k: v.reshape(B, N * v.shape[1], *v.shape[2:])
                for k, v in out_dict.items()}
