# Frozen copy of f3d_gaus_torch/models/songunet.py at commit b6ed6e2, the
# benchmark's plain reference; imports rewritten for this flat package.
"""SongUNet (the DDPM++ variant used by F3D-Gaus) as nn.Modules
(counterpart of f3d_gaus_tpu/models/songunet.py).

`SongUNet.enc` and `SongUNet.dec` are nn.ModuleDicts keyed "128x128_conv",
"16x16_in0", ... so that state_dict keys read `enc.128x128_conv.weight`,
`dec.16x16_in0.norm0.weight`: the reference's torch names.  No timestep or
label embedding; dropout is inference-off.

Cross-view attention folds the view axis into the token axis: the
reference reshapes (B, C, H, W) -> (B/N, C, N·H, W) before its attention
block, so the GroupNorm statistics of norm2 span all N views.

Not ported, by design: the JAX module's functional `init_params` /
`apply`; `SongUNet(plan, generator)` and its forward take their place.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from . import layers as L


class BlockSpec(NamedTuple):
    kind: str          # 'conv' | 'block' | 'aux_norm' | 'aux_conv'
    cin: int
    cout: int
    up: bool = False
    down: bool = False
    attention: bool = False


class UNetPlan(NamedTuple):
    enc: tuple         # ((name, BlockSpec), ...)
    dec: tuple
    skips: tuple       # channel count per encoder skip


def make_plan(img_resolution=128, in_channels=4, out_channels=23,
              model_channels=128, channel_mult=(1, 2, 2, 2), num_blocks=3,
              attn_resolutions=(16,)) -> UNetPlan:
    """The reference's ModuleDict layout (gaussian_predictor.py:417-463)."""
    enc = []
    cout = in_channels
    for level, mult in enumerate(channel_mult):
        res = img_resolution >> level
        if level == 0:
            cin, cout = cout, model_channels
            enc.append((f"enc.{res}x{res}_conv", BlockSpec("conv", cin, cout)))
        else:
            enc.append((f"enc.{res}x{res}_down",
                        BlockSpec("block", cout, cout, down=True)))
        for idx in range(num_blocks):
            cin, cout = cout, model_channels * mult
            enc.append((f"enc.{res}x{res}_block{idx}",
                        BlockSpec("block", cin, cout,
                                  attention=(res in attn_resolutions))))
    skips = [spec.cout for _, spec in enc]

    dec = []
    spare = list(skips)
    for level, mult in reversed(list(enumerate(channel_mult))):
        res = img_resolution >> level
        if level == len(channel_mult) - 1:
            dec.append((f"dec.{res}x{res}_in0",
                        BlockSpec("block", cout, cout, attention=True)))
            dec.append((f"dec.{res}x{res}_in1", BlockSpec("block", cout, cout)))
        else:
            dec.append((f"dec.{res}x{res}_up",
                        BlockSpec("block", cout, cout, up=True)))
        for idx in range(num_blocks + 1):
            cin = cout + spare.pop()
            cout = model_channels * mult
            attn = (idx == num_blocks and res in attn_resolutions)
            dec.append((f"dec.{res}x{res}_block{idx}",
                        BlockSpec("block", cin, cout, attention=attn)))
        if level == 0:
            dec.append((f"dec.{res}x{res}_aux_norm",
                        BlockSpec("aux_norm", cout, cout)))
            dec.append((f"dec.{res}x{res}_aux_conv",
                        BlockSpec("aux_conv", cout, out_channels)))
    return UNetPlan(tuple(enc), tuple(dec), tuple(skips))


_GAIN_ZERO = 1e-5              # EDM init_zero
_GAIN_ATTN = math.sqrt(0.2)    # EDM init_attn
_SKIP_SCALE = math.sqrt(0.5)


class UNetBlock(nn.Module):
    """UNetBlock without embedding (gaussian_predictor.py:316-358)."""

    def __init__(self, spec: BlockSpec, generator=None):
        super().__init__()
        self.spec = spec
        g = generator
        self.norm0 = L.GroupNorm(spec.cin)
        self.conv0 = L.Conv2d(spec.cin, spec.cout, 3, up=spec.up,
                              down=spec.down, generator=g)
        self.norm1 = L.GroupNorm(spec.cout)
        self.conv1 = L.Conv2d(spec.cout, spec.cout, 3, gain=_GAIN_ZERO,
                              generator=g)
        self.skip = None
        if spec.cout != spec.cin or spec.up or spec.down:
            # resample_proj: the skip is always a 1x1 conv
            self.skip = L.Conv2d(spec.cin, spec.cout, 1, up=spec.up,
                                 down=spec.down, generator=g)
        if spec.attention:
            self.norm2 = L.GroupNorm(spec.cout)
            self.qkv = L.Conv2d(spec.cout, spec.cout * 3, 1, gain=_GAIN_ATTN,
                                generator=g)
            self.proj = L.Conv2d(spec.cout, spec.cout, 1, gain=_GAIN_ZERO,
                                 generator=g)

    def _self_attention(self, x, n_views_xa):
        B, C, H, W = x.shape
        N = n_views_xa
        # fold views BEFORE norm2: (B, C, H, W) -> (B/N, C, N·H, W)
        xf = x.reshape(B // N, N, C, H, W).transpose(1, 2).reshape(
            B // N, C, N * H, W)
        qkv = self.qkv(self.norm2(xf))                   # (B/N, 3C, N·H, W)
        tok = qkv.reshape(B // N, 3 * C, N * H * W).transpose(1, 2)
        q, k, v = tok.split(C, dim=-1)
        a = L.attention(q, k, v).transpose(1, 2).reshape(B // N, C, N * H, W)
        out = xf + self.proj(a)
        return out.reshape(B // N, C, N, H, W).transpose(1, 2).reshape(
            B, C, H, W)

    def forward(self, x, n_views_xa=1):
        orig = x
        x = self.conv0(L.silu(self.norm0(x)))
        x = self.conv1(L.silu(self.norm1(x)))
        x = x + (self.skip(orig) if self.skip is not None else orig)
        x = x * _SKIP_SCALE
        if self.spec.attention:
            x = self._self_attention(x, n_views_xa) * _SKIP_SCALE
        return x


class SongUNet(nn.Module):
    """x: (B, Cin, H, W) NCHW -> (B, out_channels, H, W)."""

    def __init__(self, plan: UNetPlan, generator=None):
        super().__init__()
        self.plan = plan
        self.enc = nn.ModuleDict()
        self.dec = nn.ModuleDict()
        for name, spec in plan.enc + plan.dec:
            where, key = name.split(".", 1)
            if spec.kind == "conv":
                mod = L.Conv2d(spec.cin, spec.cout, 3, generator=generator)
            elif spec.kind == "aux_norm":
                mod = L.GroupNorm(spec.cin)
            elif spec.kind == "aux_conv":
                # reference: init_weight=0.2 xavier (gaussian_predictor.py:462)
                mod = L.Conv2d(spec.cin, spec.cout, 3, gain=0.2,
                               generator=generator)
            else:
                mod = UNetBlock(spec, generator)
            (self.enc if where == "enc" else self.dec)[key] = mod

    def forward(self, x, n_views_xa=1):
        skips = []
        for name, spec in self.plan.enc:
            mod = self.enc[name.split(".", 1)[1]]
            x = mod(x) if spec.kind == "conv" else mod(x, n_views_xa)
            skips.append(x)

        aux = None
        tmp = None
        for name, spec in self.plan.dec:
            mod = self.dec[name.split(".", 1)[1]]
            if spec.kind == "aux_norm":
                tmp = mod(x)
            elif spec.kind == "aux_conv":
                tmp = mod(L.silu(tmp))
                aux = tmp if aux is None else tmp + aux
            else:
                if x.shape[1] != spec.cin:
                    x = torch.cat([x, skips.pop()], dim=1)
                x = mod(x, n_views_xa)
        return aux
