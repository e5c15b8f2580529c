"""DINOv2's ViT-L/14 with registers (Oquab et al., arXiv:2304.07193; Darcet
et al., arXiv:2309.16588), the patch embedding of VGGT's aggregator
(`dinov2_vitl14_reg`).  No JAX counterpart.

Frames (N, 3, H, W), already normalised, are cut into p × p patches by a
strided convolution; a class token and the position table (a 37 × 37 grid,
DINOv2's 518-pixel training frames, interpolated bicubically with
antialiasing to the frame's patch grid) are added, the register tokens
are inserted after the class token, and `layers` pre-LN blocks follow:
x + ls1 · attn(norm1(x)), then x + ls2 · mlp(norm2(x)), LayerScale
(`LayerScale`) on both branches, exact GELU, biases on every linear layer,
LayerNorm eps 1e-6.  The output is the final LayerNorm's patch tokens
(DINOv2's `x_norm_patchtokens`), what VGGT reads.

`Block` is also the block of VGGT's aggregator and camera head
(models/vggt.py): with `qk_norm` its attention normalises q and k over
the head dimension, and its forward takes the rotary position tables
that rotate q and k.  Every attention is layers.multihead_attention.

Weights are drawn as N(0, INIT_STD) from the generator (biases zero,
LayerNorms one and zero), the class and register tokens as N(0, 1e-6),
LayerScale at `layer_scale`.  State_dict keys are DINOv2's: `patch_embed.
proj`, `cls_token`, `register_tokens`, `pos_embed`, `blocks.{i}.{norm1,
attn.qkv, attn.proj, ls1.gamma, norm2, mlp.fc1, mlp.fc2, ls2.gamma}`,
`norm`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import profiling
from . import layers as L
from .gslrm import INIT_STD, Linear

EPS = 1e-6
TOKEN_STD = 1e-6          # the class, register and camera tokens' draw


def normal(shape, std, generator=None):
    """An nn.Parameter of N(0, std) draws from `generator`."""
    return nn.Parameter(torch.randn(shape, generator=generator) * std)


class LayerScale(nn.Module):
    def __init__(self, dim, init: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init)))

    def forward(self, x):
        return x * self.gamma


class Attention(nn.Module):
    """Multi-head self-attention with a bias on qkv and proj; with
    `qk_norm`, a LayerNorm over each head's q and k (`q_norm`,
    `k_norm`)."""

    def __init__(self, dim, heads, qk_norm: bool = False, generator=None):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim, INIT_STD, generator)
        self.proj = Linear(dim, dim, INIT_STD, generator)
        if qk_norm:
            self.q_norm = nn.LayerNorm(dim // heads, eps=EPS)
            self.k_norm = nn.LayerNorm(dim // heads, eps=EPS)
        else:
            self.q_norm = self.k_norm = None

    def forward(self, x, rope=None):
        """x (N, L, C); rope: None or (cos, sin) tables (L, d) for
        rotate_2d."""
        N, Lx, C = x.shape
        qkv = self.qkv(x).reshape(N, Lx, 3, self.heads, C // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)          # (N, heads, L, d)
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        if rope is not None:
            q, k = rotate_2d(q, *rope), rotate_2d(k, *rope)
        o = L.multihead_attention(q, k, v)
        return self.proj(o.transpose(1, 2).reshape(N, Lx, C))


class MLP(nn.Module):
    def __init__(self, dim, hidden, generator=None):
        super().__init__()
        self.fc1 = Linear(dim, hidden, INIT_STD, generator)
        self.fc2 = Linear(hidden, dim, INIT_STD, generator)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """x + ls1 · attn(norm1(x)), then x + ls2 · mlp(norm2(x))."""

    def __init__(self, dim, heads, mlp, layer_scale: float,
                 qk_norm: bool = False, generator=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=EPS)
        self.attn = Attention(dim, heads, qk_norm, generator)
        self.ls1 = LayerScale(dim, layer_scale)
        self.norm2 = nn.LayerNorm(dim, eps=EPS)
        self.mlp = MLP(dim, mlp, generator)
        self.ls2 = LayerScale(dim, layer_scale)

    def forward(self, x, rope=None):
        x = x + self.ls1(self.attn(self.norm1(x), rope))
        return x + self.ls2(self.mlp(self.norm2(x)))


def rotate_2d(x, cos, sin):
    """2D rotary embedding (VGGT's RotaryPositionEmbedding2D): the first
    half of each head's features rotated by the token's row, the second
    half by its column, each half as 1D RoPE with rotate_half.  x (...,
    L, d); cos and sin (L, d) from rope_tables."""
    h = x.shape[-1] // 2

    def rot(t, c, s):
        t1, t2 = t.chunk(2, dim=-1)
        return t * c + torch.cat([-t2, t1], -1) * s
    return torch.cat([rot(x[..., :h], cos[:, :h], sin[:, :h]),
                      rot(x[..., h:], cos[:, h:], sin[:, h:])], -1)


def rope_tables(pos, head_dim: int, freq: float):
    """cos and sin (L, head_dim) of positions pos (L, 2) int (row,
    column): each half of head_dim takes one coordinate, its frequencies
    1 / freq^(2i / (head_dim / 2)), each angle repeated over the half's
    two halves."""
    dim = head_dim // 2
    inv = 1.0 / (freq ** (torch.arange(0, dim, 2, device=pos.device,
                                       dtype=torch.float32) / dim))
    parts = []
    for c in range(2):
        ang = pos[:, c].float()[:, None] * inv[None]
        parts.append(torch.cat([ang, ang], -1))
    ang = torch.cat(parts, -1)
    return torch.cos(ang), torch.sin(ang)


class DINOv2(nn.Module):
    """Normalised frames -> DINOv2's final LayerNorm's patch tokens."""

    def __init__(self, dim=1024, layers=24, heads=16, mlp=4096, patch=14,
                 registers=4, grid=37, layer_scale=1.0, generator=None):
        super().__init__()
        self.patch, self.grid = patch, grid
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, dim, patch, stride=patch)
        with torch.no_grad():
            self.patch_embed.proj.weight.copy_(
                torch.randn((dim, 3, patch, patch), generator=generator)
                * INIT_STD)
            self.patch_embed.proj.bias.zero_()
        self.cls_token = normal((1, 1, dim), TOKEN_STD, generator)
        self.register_tokens = normal((1, registers, dim), TOKEN_STD,
                                      generator)
        self.pos_embed = normal((1, 1 + grid * grid, dim), INIT_STD,
                                generator)
        self.blocks = nn.ModuleList([Block(dim, heads, mlp, layer_scale,
                                           generator=generator)
                                     for _ in range(layers)])
        self.norm = nn.LayerNorm(dim, eps=EPS)

    def position_table(self, rows: int, cols: int):
        """The class token's position and the patch table interpolated
        to rows × cols: (1, 1 + rows·cols, dim)."""
        pe = self.pos_embed.float()
        dim, g = pe.shape[-1], self.grid
        patch = pe[:, 1:].reshape(1, g, g, dim).permute(0, 3, 1, 2)
        if (rows, cols) != (g, g):
            patch = F.interpolate(patch, size=(rows, cols), mode="bicubic",
                                  align_corners=False, antialias=True)
        patch = patch.permute(0, 2, 3, 1).reshape(1, rows * cols, dim)
        return torch.cat([pe[:, :1], patch], 1)

    @profiling.spanned("dinov2")
    def forward(self, frames):
        """frames (N, 3, H, W) normalised -> patch tokens (N, (H/p)·(W/p),
        dim)."""
        N, _, H, W = frames.shape
        rows, cols = H // self.patch, W // self.patch
        x = self.patch_embed.proj(frames).flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(N, -1, -1), x], 1)
        x = x + self.position_table(rows, cols)
        x = torch.cat([x[:, :1], self.register_tokens.expand(N, -1, -1),
                       x[:, 1:]], 1)
        for block in self.blocks:
            x = block(x)
        return self.norm(x)[:, 1 + self.register_tokens.shape[1]:]
