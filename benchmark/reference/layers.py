# Frozen copy of f3d_gaus_torch/models/layers.py at commit b6ed6e2, the
# benchmark's plain reference; imports rewritten for this flat package;
# xavier_uniform also draws from the benchmark's stream of uniforms.
"""EDM-style network primitives as nn.Modules (counterpart of
f3d_gaus_tpu/models/layers.py).

Activations run NCHW inside the network; weights are OIHW, the layout of
the reference's torch state_dict.  The [1,1] resample filter reduces to
nearest-neighbour 2x upsampling / 2x2 mean-pool downsampling before the
convolution.  Attention scores are computed in float32 with a plain matmul
and softmax.  Initialization is EDM's xavier_uniform with a gain, drawn from
an explicit torch.Generator.

Not ported, by design: the JAX module's functional `conv2d`, `group_norm`
and `linear` and their `conv_init`, `groupnorm_init` and `linear_init`;
here each layer is an nn.Module that holds and initialises its weights.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def silu(x):
    return F.silu(x)


def xavier_uniform(shape, fan_in, fan_out, gain=1.0, generator=None):
    a = math.sqrt(6.0 / (fan_in + fan_out))
    # a generator with `take` is the benchmark's stream of uniforms
    # (benchmark/weights.py), drawn on the card in one call
    u = (generator.take(shape) if hasattr(generator, "take")
         else torch.rand(shape, generator=generator, dtype=torch.float32))
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
