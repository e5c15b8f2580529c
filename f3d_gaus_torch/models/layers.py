"""EDM-style network primitives as nn.Modules (counterpart of
f3d_gaus_tpu/models/layers.py).

Activations run NCHW inside the network; weights are OIHW, the layout of
the reference's torch state_dict.  The [1,1] resample filter reduces to
nearest-neighbour 2x upsampling / 2x2 mean-pool downsampling before the
convolution.  Attention scores are computed in float32 with a plain matmul
and softmax: `attention` (one head, the SongUNet's and CLIP's lengths) holds
all its scores; `multihead_attention` (GS-LRM's 16,384 tokens) a block of
queries at a time.  Initialization is EDM's xavier_uniform with a gain,
drawn from an explicit torch.Generator.

Not ported, by design: the JAX module's functional `conv2d`, `group_norm`
and `linear` and their `conv_init`, `groupnorm_init` and `linear_init`;
here each layer is an nn.Module that holds and initialises its weights.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import profiling


def silu(x):
    return F.silu(x)


def xavier_uniform(shape, fan_in, fan_out, gain=1.0, generator=None):
    a = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (u * 2.0 - 1.0) * (a * gain)


def resample(x, *, up=False, down=False):
    """Nearest 2x up / 2x2 mean down on NCHW (the reference's [1,1] filter)."""
    if up:
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    if down:
        B, C, H, W = x.shape
        x = x.reshape(B, C, H // 2, 2, W // 2, 2).mean((3, 5))
    return x


class Conv2d(nn.Module):
    """k x k convolution (k in {1, 3}, 'same' padding) with the optional
    fused resample applied first."""

    def __init__(self, cin, cout, kernel, *, up=False, down=False, gain=1.0,
                 generator=None):
        super().__init__()
        self.up, self.down = up, down
        fan_in, fan_out = cin * kernel * kernel, cout * kernel * kernel
        self.weight = nn.Parameter(xavier_uniform(
            (cout, cin, kernel, kernel), fan_in, fan_out, gain, generator))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        x = resample(x, up=self.up, down=self.down)
        k = self.weight.shape[-1]
        return F.conv2d(x, self.weight, self.bias, padding=k // 2)


class GroupNorm(nn.Module):
    """GroupNorm with min(32, C // 4) groups and eps 1e-6."""

    def __init__(self, c):
        super().__init__()
        self.num_groups = min(32, c // 4)
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.weight, self.bias, 1e-6)


def attention(q, k, v):
    """Single-head softmax(q k^T / sqrt(C)) v with float32 scores.
    q, k, v: (B, N, C) token-major.  Returns (B, N, C)."""
    C = q.shape[-1]
    w = torch.matmul(q.float(), (k.float() / math.sqrt(C)).transpose(1, 2))
    w = torch.softmax(w, dim=-1)
    return torch.matmul(w, v.float()).to(q.dtype)


ATTN_BLOCK_BYTES = 1 << 30     # scores held at a time by multihead_attention


@profiling.spanned("attention")
def multihead_attention(q, k, v, block_bytes: int = ATTN_BLOCK_BYTES):
    """softmax(q k^T / sqrt(d)) v of every head in float32, a block of
    queries at a time.  q (B, H, L, d), k and v (B, H, S, d).  Returns
    (B, H, L, d).

    The scores of a block are one cuBLAS batched product (f32 on the FMA
    units while TF32 is off, as core.device.resolve_device leaves it), a
    softmax over the keys and a second batched product.  A block holds at
    most `block_bytes` of scores: whole heads while S·L·4 bytes fit, else
    rows of one head, so all heads' L×S scores are never held at once
    (17.2 GB a layer at 16,384 tokens and 16 heads).  While tracing is on
    (utils.profiling) the call is span `attention` and counts
    `attention.calls` and `attention.tokens` (L)."""
    B, H, L, d = q.shape
    S = k.shape[2]
    profiling.count("attention.calls")
    profiling.count("attention.tokens", L)
    q = (q.float() * (1.0 / math.sqrt(d))).reshape(B * H, L, d)
    kt = k.float().reshape(B * H, S, d).transpose(1, 2)
    v = v.float().reshape(B * H, S, d)
    rows = max(1, block_bytes // (S * 4))
    heads = max(1, rows // L) if rows >= L else 1
    rows = min(rows, L)
    out = q.new_empty((B * H, L, d))
    for h in range(0, B * H, heads):
        hs = slice(h, h + heads)
        for r in range(0, L, rows):
            rs = slice(r, r + rows)
            p = torch.softmax(torch.bmm(q[hs, rs], kt[hs]), dim=-1)
            out[hs, rs] = torch.bmm(p, v[hs])
    return out.reshape(B, H, L, d)
