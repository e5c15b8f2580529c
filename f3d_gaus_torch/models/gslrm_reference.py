"""A plain PyTorch reference of GS-LRM (Zhang et al., "GS-LRM: Large
Reconstruction Model for 3D Gaussian Splatting", ECCV 2024,
arXiv:2404.19702), object-level, in float32.

It imports torch and math only: nothing of the port and no
kernel, so it can stand beside the port as its yardstick, on the CPU at a
small size and on the card at the published widths (4 views at 512²,
patch 8, 24 layers, width 1024, 16 heads of 64, MLP 4096, 12 channels a
pixel).  Attention is written out: scores, max, exp, sum and the weighted
values, a block of queries of one head at a time, so 16,384 tokens fit
on the card.  `resolve_device` turns TF32 off for matmuls and cuDNN at
every forward.

Departures from the paper, each an assumption of the benchmark's
configuration (benchmark/configs/gslrm_object_512.json):
- Weights: none were published; every weight is drawn as N(0, 0.02) with
  zero biases, and the head's rows are scaled and biased per channel
  group: colour (5, 0), scale (5e-4, log 0.01), rotation (1, 0),
  opacity (1e-3, -3) (F3D-Gaus's per-group table) and distance (1e-3, 0).
- Activations and position follow F3D-Gaus's predictor: scaling = exp,
  opacity = sigmoid, rotation = q / |q|, colour = the SH DC coefficients
  (degree 0), t = near + (far - near) sigmoid(w), xyz = o + t d with d
  the unit world direction through the pixel centre.
- Blocks: no positional or view embedding, LayerNorm eps 1e-5, exact
  GELU, biases on every linear layer, no QK-norm.
- Input RGB in [0, 1] is mapped to [-1, 1] before the tokenizer.
- Precision: float32 throughout (the paper trains and serves in mixed
  precision).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class GSLRMConfig(NamedTuple):
    views: int = 4
    resolution: int = 512
    patch: int = 8
    width: int = 1024
    layers: int = 24
    heads: int = 16
    mlp: int = 4096
    gaussian_channels: int = 12
    sh_degree: int = 0
    near: float = 4.03 - math.sqrt(3.0)
    far: float = 4.03 + math.sqrt(3.0)


INIT_STD = 0.02
# the head's channel groups: colour, scale, rotation, opacity, distance
SPLITS = (3, 3, 4, 1, 1)
GROUP_SCALE = (5.0, 5e-4, 1.0, 1e-3, 1e-3)
GROUP_BIAS = (0.0, math.log(0.01), 0.0, -3.0, 0.0)


# scores of one block of queries held at a time (one head's rows)
QUERY_BLOCK_BYTES = 1 << 28


def resolve_device(device=None, like=None) -> torch.device:
    """The device to run on (`device`, else `like`'s, else cuda), with
    TF32 turned off for matmuls and cuDNN."""
    if device is None:
        device = like.device if like is not None else "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device(device)


def _normal(shape, std, generator):
    """N(0, std) draws: from the benchmark's stream of normals when the
    generator has `take`, else from torch.randn."""
    if hasattr(generator, "take"):
        z = generator.take(tuple(shape))
    else:
        z = torch.randn(tuple(shape), generator=generator)
    return torch.nn.Parameter(z * std)


class Linear(torch.nn.Module):
    def __init__(self, cin, cout, std, generator):
        super().__init__()
        self.weight = _normal((cout, cin), std, generator)
        self.bias = torch.nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return x @ self.weight.t() + self.bias


class LayerNorm(torch.nn.Module):
    def __init__(self, c, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = torch.nn.Parameter(torch.ones(c))
        self.bias = torch.nn.Parameter(torch.zeros(c))

    def forward(self, x):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + self.eps) * self.weight + self.bias


def gelu(x):
    """Exact GELU: x Φ(x)."""
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def blocked_attention(q, k, v, block_bytes: int = QUERY_BLOCK_BYTES):
    """softmax(q k^T / sqrt(d)) v written out, one head and one block of
    queries at a time.  q, k, v: (B, H, L, d)."""
    B, H, L, d = q.shape
    rows = max(1, min(L, block_bytes // (k.shape[2] * 4)))
    out = torch.empty_like(q)
    for b in range(B):
        for h in range(H):
            kt = k[b, h].t()
            for r in range(0, L, rows):
                s = (q[b, h, r:r + rows] @ kt) / math.sqrt(d)
                e = torch.exp(s - s.max(-1, keepdim=True).values)
                out[b, h, r:r + rows] = (e / e.sum(-1, keepdim=True)) @ v[b, h]
    return out


class Attention(torch.nn.Module):
    def __init__(self, cfg, generator):
        super().__init__()
        self.heads = cfg.heads
        self.qkv = Linear(cfg.width, 3 * cfg.width, INIT_STD, generator)
        self.proj = Linear(cfg.width, cfg.width, INIT_STD, generator)

    def forward(self, x):
        B, N, C = x.shape
        dh = C // self.heads
        qkv = self.qkv(x)
        q, k, v = [qkv[..., i * C:(i + 1) * C].reshape(
            B, N, self.heads, dh).transpose(1, 2) for i in range(3)]
        o = blocked_attention(q, k, v)
        return self.proj(o.transpose(1, 2).reshape(B, N, C))


class MLP(torch.nn.Module):
    def __init__(self, cfg, generator):
        super().__init__()
        self.fc1 = Linear(cfg.width, cfg.mlp, INIT_STD, generator)
        self.fc2 = Linear(cfg.mlp, cfg.width, INIT_STD, generator)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class Block(torch.nn.Module):
    def __init__(self, cfg, generator):
        super().__init__()
        self.norm1 = LayerNorm(cfg.width)
        self.attn = Attention(cfg, generator)
        self.norm2 = LayerNorm(cfg.width)
        self.mlp = MLP(cfg, generator)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


def pixel_rays(world_view, tan_fov, height, width):
    """Camera centres (..., 3) and unit world directions through the pixel
    centres (..., H, W, 3) of row-vector world_view matrices (..., 4, 4):
    pixel (i, j) at ((2j + 1) / W - 1, (2i + 1) / H - 1) tan_fov, +z
    forward."""
    rot = world_view[..., :3, :3]
    trans = world_view[..., 3, :3]
    o = -torch.einsum("...j,...ij->...i", trans, rot)
    dt, dev = world_view.dtype, world_view.device
    ys = ((torch.arange(height, dtype=dt, device=dev) * 2 + 1) / height - 1)
    xs = ((torch.arange(width, dtype=dt, device=dev) * 2 + 1) / width - 1)
    d_cam = torch.stack([xs[None, :].expand(height, width) * tan_fov,
                         ys[:, None].expand(height, width) * tan_fov,
                         torch.ones(height, width, dtype=dt, device=dev)], -1)
    d = torch.einsum("hwj,...ij->...hwi", d_cam, rot)
    return o, d / d.norm(dim=-1, keepdim=True)


class GSLRM(torch.nn.Module):
    def __init__(self, cfg: GSLRMConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        p = cfg.patch
        self.tokenizer = Linear(p * p * 9, cfg.width, INIT_STD, generator)
        self.blocks = torch.nn.ModuleList([Block(cfg, generator)
                                           for _ in range(cfg.layers)])
        self.norm = LayerNorm(cfg.width)
        self.head = Linear(cfg.width, p * p * cfg.gaussian_channels,
                           INIT_STD, generator)
        with torch.no_grad():
            scale = torch.tensor([s for n, s in zip(SPLITS, GROUP_SCALE)
                                  for _ in range(n)] * (p * p))
            bias = torch.tensor([b for n, b in zip(SPLITS, GROUP_BIAS)
                                 for _ in range(n)] * (p * p))
            self.head.weight.mul_(scale[:, None].to(self.head.weight.device))
            self.head.bias.copy_(bias)

    def forward(self, images, world_views, tan_fov):
        """images (B, V, H, W, 3) in [0, 1], world_views (B, V, 4, 4).
        Returns (the Gaussian dict, as the port's GSLRM returns it; the
        final LayerNorm's tokens (B, N, width))."""
        resolve_device(like=images)
        cfg = self.cfg
        B, V, H, W, _ = images.shape
        p = cfg.patch
        o, d = pixel_rays(world_views, tan_fov, H, W)
        o_px = o[:, :, None, None, :].expand_as(d)
        x = torch.cat([images * 2.0 - 1.0, torch.cross(o_px, d, dim=-1), d],
                      -1)
        gh, gw = H // p, W // p
        # patches: (row, column, channel) within each patch
        x = x.reshape(B, V, gh, p, gw, p, 9).permute(0, 1, 2, 4, 3, 5, 6)
        x = self.tokenizer(x.reshape(B, V * gh * gw, p * p * 9))
        for block in self.blocks:
            x = block(x)
        tokens = self.norm(x)
        out = self.head(tokens).reshape(B, V, gh, gw, p, p, -1)
        out = out.permute(0, 1, 2, 4, 3, 5, 6).reshape(B, V * H * W, -1)
        rgb, scale, rot, opa, dist = out.split(SPLITS, -1)
        t = cfg.near + (cfg.far - cfg.near) * torch.sigmoid(dist)
        xyz = o_px.reshape(B, V * H * W, 3) + t * d.reshape(B, V * H * W, 3)
        g = {"xyz": xyz, "opacity": torch.sigmoid(opa),
             "scaling": torch.exp(scale),
             "rotation": rot / rot.norm(dim=-1, keepdim=True),
             "features_dc": rgb[:, :, None, :],
             "features_rest": rgb.new_zeros((B, V * H * W, 0, 3))}
        return g, tokens
