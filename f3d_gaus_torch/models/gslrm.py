"""GS-LRM, the large reconstruction model for 3D Gaussian splatting (Zhang
et al., ECCV 2024, arXiv:2404.19702), object-level: posed views in,
pixel-aligned Gaussians out.  No JAX counterpart.

Each of V views carries 9 channels a pixel: its RGB mapped to [-1, 1] and
the pixel ray's Plücker coordinates (o × d, d) (core.cameras.plucker_rays).
Each view is cut into p × p patches; one linear layer maps a patch's
p·p·9 values to the width, and the tokens of all views form one sequence.
`layers` pre-LN blocks (multi-head self-attention over every token of
every view, an MLP with exact GELU) follow, then a final LayerNorm and a
linear head to p·p·12 values a token, unpatchified to 12 channels a
pixel: RGB 3, scale 3, rotation 4, opacity 1 and the ray distance 1.  The
Gaussian of a pixel sits at o + t·d, with t = near + (far - near)·
sigmoid(w).

Activations follow models/predictor.py: scaling = exp, opacity = sigmoid,
rotation = q / |q|, features_dc = the colour channels.  Weights are drawn
as N(0, INIT_STD) with zero biases; the head's rows are scaled and biased
per channel group (`split_dimensions`, predictor.split_dimensions' table
for colour, scale, rotation and opacity), so the Gaussians at
initialisation are small rather than noise that covers the frame.  No
positional or view embedding (the rays place each patch), LayerNorm eps
1e-5, biases on every linear layer, no QK-norm.  State_dict keys name the
paper's parts: `tokenizer`, `blocks.{i}.{norm1, attn.qkv, attn.proj,
norm2, mlp.fc1, mlp.fc2}`, `norm`, `head`.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core import cameras
from ..utils import profiling
from . import layers as L
from .predictor import PredictorConfig

SQRT3 = math.sqrt(3.0)
INIT_STD = 0.02            # every weight's N(0, INIT_STD) draw
DISTANCE_SCALE = 1e-3      # the head's init scale of the distance


class GSLRMConfig(NamedTuple):
    """The object-level model's published shape (arXiv:2404.19702 §4)."""
    views: int = 4
    resolution: int = 512
    patch: int = 8
    width: int = 1024
    layers: int = 24
    heads: int = 16
    mlp: int = 4096
    gaussian_channels: int = 12
    sh_degree: int = 0
    # the camera radius ∓ the scene's half-diagonal
    near: float = 4.03 - SQRT3
    far: float = 4.03 + SQRT3

    @property
    def tokens(self) -> int:
        return self.views * (self.resolution // self.patch) ** 2


def split_dimensions(cfg: GSLRMConfig):
    """[rgb 3, scale 3, rotation 4, opacity 1, distance 1] with the head's
    per-group (scale, bias): predictor.split_dimensions' table (colour
    (5, 0), scale (5e-4, log 0.01), rotation (1, 0), opacity (1e-3, -3))
    and (DISTANCE_SCALE, 0) for the distance."""
    p = PredictorConfig()
    splits = [3, 3, 4, 1, 1]
    scales = [5.0, p.scale_scale, 1.0, p.opacity_scale, DISTANCE_SCALE]
    biases = [0.0, math.log(p.scale_bias), 0.0, p.opacity_bias, 0.0]
    assert sum(splits) == cfg.gaussian_channels
    return splits, scales, biases


class Linear(nn.Module):
    """x W^T + b with W drawn as N(0, std) from `generator` (no default
    initialisation to overwrite); `bias` False leaves b out."""

    def __init__(self, cin, cout, std, generator=None, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(
            torch.randn((cout, cin), generator=generator) * std)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Attention(nn.Module):
    def __init__(self, cfg: GSLRMConfig, generator=None):
        super().__init__()
        self.heads = cfg.heads
        self.qkv = Linear(cfg.width, 3 * cfg.width, INIT_STD, generator)
        self.proj = Linear(cfg.width, cfg.width, INIT_STD, generator)

    def forward(self, x):
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.heads, C // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)          # (B, heads, N, 64)
        o = L.multihead_attention(q, k, v)
        return self.proj(o.transpose(1, 2).reshape(B, N, C))


class MLP(nn.Module):
    def __init__(self, cfg: GSLRMConfig, generator=None):
        super().__init__()
        self.fc1 = Linear(cfg.width, cfg.mlp, INIT_STD, generator)
        self.fc2 = Linear(cfg.mlp, cfg.width, INIT_STD, generator)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """Pre-LN: x + attn(norm1(x)), then + mlp(norm2(x))."""

    def __init__(self, cfg: GSLRMConfig, generator=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.width, eps=1e-5)
        self.attn = Attention(cfg, generator)
        self.norm2 = nn.LayerNorm(cfg.width, eps=1e-5)
        self.mlp = MLP(cfg, generator)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


def patchify(x, p: int):
    """(B, V, H, W, C) -> (B, V·(H/p)·(W/p), p·p·C), each token's values
    in (row, column, channel) order within its patch."""
    B, V, H, W, C = x.shape
    x = x.reshape(B, V, H // p, p, W // p, p, C).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(B, V * (H // p) * (W // p), p * p * C)


def unpatchify(x, views: int, height: int, width: int, p: int):
    """patchify's inverse: (B, N, p·p·C) -> (B, V, H, W, C)."""
    B = x.shape[0]
    x = x.reshape(B, views, height // p, width // p, p, p, -1)
    x = x.permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(B, views, height, width, x.shape[-1])


class GSLRM(nn.Module):
    """Posed views -> pixel-aligned Gaussians (see the module docstring)."""

    def __init__(self, cfg: GSLRMConfig,
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.sh_degree != 0:
            raise ValueError("GS-LRM's head gives SH degree 0 colours")
        self.cfg = cfg
        p, std = cfg.patch, INIT_STD
        self.tokenizer = Linear(p * p * 9, cfg.width, std, generator)
        self.blocks = nn.ModuleList([Block(cfg, generator)
                                     for _ in range(cfg.layers)])
        self.norm = nn.LayerNorm(cfg.width, eps=1e-5)
        self.head = Linear(cfg.width, p * p * cfg.gaussian_channels, std,
                           generator)
        splits, scales, biases = split_dimensions(cfg)
        with torch.no_grad():
            scale = torch.cat([torch.full((n,), s)
                               for n, s in zip(splits, scales)])
            bias = torch.cat([torch.full((n,), b)
                              for n, b in zip(splits, biases)])
            # the head's rows are (row, column, channel) of the patch
            self.head.weight.mul_(scale.repeat(p * p)[:, None].to(
                self.head.weight.device))
            self.head.bias.copy_(bias.repeat(p * p))

    @profiling.spanned("gslrm")
    def forward(self, images, world_views, tan_fov: float,
                tan_fovy: float | None = None):
        """images (B, V, H, W, 3) RGB in [0, 1]; world_views (B, V, 4, 4)
        row-vector world->view tensors of the input cameras, tan_fov their
        tan(fov / 2) (square pixels; `tan_fovy`, the y tangent, defaults
        to it).

        Returns GaussianPredictor's dict: xyz (B, V·H·W, 3), opacity
        (B, V·H·W, 1), scaling (B, V·H·W, 3), rotation (B, V·H·W, 4),
        features_dc (B, V·H·W, 1, 3) and an empty features_rest
        (B, V·H·W, 0, 3), pixels in (view, row, column) order.  While
        tracing is on (utils.profiling) the call is span `gslrm` with
        children `tokens`, `blocks` and `head`, and counts
        `gslrm.gaussians`."""
        cfg = self.cfg
        B, V, H, W, _ = images.shape
        p = cfg.patch
        with profiling.span("tokens"):
            o, d, plucker = cameras.plucker_rays(
                world_views, tan_fov,
                tan_fov if tan_fovy is None else tan_fovy, H, W)
            x = torch.cat([images * 2.0 - 1.0, plucker], -1)
            x = self.tokenizer(patchify(x, p))
        with profiling.span("blocks"):
            for block in self.blocks:
                x = block(x)
        with profiling.span("head"):
            out = unpatchify(self.head(self.norm(x)), V, H, W, p)
            rgb, scale, rot, opa, dist = out.split(split_dimensions(cfg)[0],
                                                   -1)
            t = cfg.near + (cfg.far - cfg.near) * torch.sigmoid(dist)
            xyz = o[:, :, None, None, :] + t * d
            n = V * H * W

            def flat(a):
                return a.reshape(B, n, a.shape[-1])
            rot = flat(rot)
            g = {"xyz": flat(xyz),
                 "opacity": torch.sigmoid(flat(opa)),
                 "scaling": torch.exp(flat(scale)),
                 "rotation": rot / torch.linalg.norm(rot, dim=-1,
                                                     keepdim=True),
                 "features_dc": flat(rgb)[:, :, None, :]}
            g["features_rest"] = g["features_dc"].new_zeros((B, n, 0, 3))
        profiling.count("gslrm.gaussians", B * n)
        return g
