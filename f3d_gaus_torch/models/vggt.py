"""VGGT's geometry transformer and heads (Wang et al., "VGGT: Visual
Geometry Grounded Transformer", CVPR 2025, arXiv:2503.11651), at the
defaults of its `aggregator.py`, `camera_head.py` and `dpt_head.py`, as
AnySplat builds on them.  No JAX counterpart.

`Aggregator`: frames normalised by ImageNet's mean and std go through
DINOv2 (models/dinov2.py); each frame's patch tokens are prefixed by a
camera token and `registers` register tokens (one pair for the first
frame, another for the rest), and `depth` pairs of blocks alternate: a
frame block attends within each frame (B·S sequences), a global block over
every token of every frame (B sequences of S·T tokens).  Both have QK-norm
and 2D RoPE (patch tokens at (row + 1, column + 1), the special tokens at
0, the same positions in every frame), LayerScale at `layer_scale`.  The
outputs of the pairs named in `keep` are returned as the frame block's
and the global block's tokens concatenated, 2·width wide.

`CameraHead`: the last pair's camera tokens, LayerNorm'd, refined by a
trunk of `camera_layers` blocks at 2·width for `camera_iters` iterations,
each modulated (adaLN: shift, scale, gate from the embedding of the
previous estimate, an empty token the first time) and adding a delta to
the pose encoding (`absT_quaR_FoV`: T 3, quaternion (x, y, z, w) 4, the
vertical and horizontal FoV 2; the FoV through a ReLU).

`DPTHead`: four layers' patch tokens, LayerNorm'd, projected to
`channels`, resized to 4×, 2×, 1× and ½× the patch grid, refined by
RefineNet fusion from the coarsest up (residual conv units, bilinear
upsampling with aligned corners), a sinusoidal UV embedding added after
the projections and at the full frame, and a last 3×3 / ReLU / 1×1
output at every pixel, DPT_CHUNK frames at a time.

Weights: N(0, INIT_STD) for every linear and convolution (zero biases),
tokens N(0, 1e-6), LayerNorms one and zero.  State_dict keys are VGGT's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import profiling
from .dinov2 import (EPS, TOKEN_STD, Block, DINOv2, normal, rope_tables)
from .gslrm import INIT_STD, Linear

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
UV_RATIO = 0.1            # the DPT's UV embedding's weight
UV_OMEGA = 100.0
DPT_CHUNK = 8             # frames a DPT pass: its full-frame maps' memory


def conv(cin, cout, k, stride=1, padding=0, bias=True, generator=None,
         transpose=False):
    """A Conv2d (or ConvTranspose2d) with N(0, INIT_STD) weights and zero
    bias."""
    cls = nn.ConvTranspose2d if transpose else nn.Conv2d
    c = cls(cin, cout, k, stride=stride, padding=padding, bias=bias)
    with torch.no_grad():
        c.weight.copy_(torch.randn(c.weight.shape, generator=generator)
                       * INIT_STD)
        if bias:
            c.bias.zero_()
    return c


def token_positions(rows: int, cols: int, special: int, device):
    """(special + rows·cols, 2) int positions of one frame's tokens: the
    special tokens at (0, 0), patch (r, c) at (r + 1, c + 1)."""
    r = torch.arange(rows, device=device)
    c = torch.arange(cols, device=device)
    grid = torch.stack(torch.meshgrid(r, c, indexing="ij"), -1).reshape(-1, 2)
    return torch.cat([grid.new_zeros((special, 2)), grid + 1])


class Aggregator(nn.Module):
    """Frames -> the kept pairs' 2·width tokens (module docstring)."""

    def __init__(self, cfg, generator=None):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.patch_embed = DINOv2(w, cfg.dino_layers, cfg.heads, cfg.mlp,
                                  cfg.patch, cfg.registers, cfg.dino_grid,
                                  cfg.dino_layer_scale, generator)
        self.camera_token = normal((1, 2, 1, w), TOKEN_STD, generator)
        self.register_token = normal((1, 2, cfg.registers, w), TOKEN_STD,
                                     generator)
        self.frame_blocks = nn.ModuleList([
            Block(w, cfg.heads, cfg.mlp, cfg.layer_scale, True, generator)
            for _ in range(cfg.depth)])
        self.global_blocks = nn.ModuleList([
            Block(w, cfg.heads, cfg.mlp, cfg.layer_scale, True, generator)
            for _ in range(cfg.depth)])
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).view(
            1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).view(
            1, 3, 1, 1), persistent=False)

    @profiling.spanned("aggregator")
    def forward(self, images, keep):
        """images (B, S, H, W, 3) in [0, 1].  Returns {pair index: (B, S,
        T, 2·width)} for each index in `keep`, T = 1 + registers + patches
        a frame."""
        cfg = self.cfg
        B, S, H, W, _ = images.shape
        frames = images.reshape(B * S, H, W, 3).permute(0, 3, 1, 2)
        patches = self.patch_embed((frames - self.mean) / self.std)
        C = patches.shape[-1]

        def special(tok):
            # the first frame's token, then the others' for the rest
            t = torch.cat([tok[:, :1], tok[:, 1:].expand(-1, S - 1, -1, -1)],
                          1)
            return t.expand(B, -1, -1, -1).reshape(B * S, -1, C)
        x = torch.cat([special(self.camera_token),
                       special(self.register_token), patches], 1)
        T = x.shape[1]
        pos = token_positions(H // cfg.patch, W // cfg.patch,
                              1 + cfg.registers, x.device)
        rope = rope_tables(pos, C // cfg.heads, cfg.rope_freq)
        rope_all = (rope[0].repeat(S, 1), rope[1].repeat(S, 1))
        out = {}
        for i in range(cfg.depth):
            with profiling.span("frame"):
                x = self.frame_blocks[i](x.reshape(B * S, T, C), rope)
                frame = x.reshape(B, S, T, C)
            with profiling.span("global"):
                x = self.global_blocks[i](x.reshape(B, S * T, C), rope_all)
            if i in keep:
                out[i] = torch.cat([frame, x.reshape(B, S, T, C)], -1)
        return out


def modulate(x, shift, scale):
    return x * (1 + scale) + shift


class PoseBranch(nn.Module):
    """Mlp(2·width -> width -> 9), exact GELU."""

    def __init__(self, dim, hidden, out, generator=None):
        super().__init__()
        self.fc1 = Linear(dim, hidden, INIT_STD, generator)
        self.fc2 = Linear(hidden, out, INIT_STD, generator)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class CameraHead(nn.Module):
    """The last pair's camera tokens -> pose encodings (B, S, 9) (module
    docstring)."""

    def __init__(self, cfg, generator=None):
        super().__init__()
        self.iters = cfg.camera_iters
        d = 2 * cfg.width
        self.token_norm = nn.LayerNorm(d, eps=EPS)
        self.trunk = nn.Sequential(*[
            Block(d, cfg.camera_heads, 4 * d, cfg.layer_scale,
                  generator=generator) for _ in range(cfg.camera_layers)])
        self.trunk_norm = nn.LayerNorm(d, eps=EPS)
        self.empty_pose_tokens = nn.Parameter(torch.zeros(1, 1, 9))
        self.embed_pose = Linear(9, d, INIT_STD, generator)
        self.poseLN_modulation = nn.Sequential(
            nn.SiLU(), Linear(d, 3 * d, INIT_STD, generator))
        self.adaln_norm = nn.LayerNorm(d, eps=EPS, elementwise_affine=False)
        self.pose_branch = PoseBranch(d, d // 2, 9, generator)

    @profiling.spanned("camera_head")
    def forward(self, tokens):
        """tokens (B, S, T, 2·width) -> the last iteration's activated pose
        encodings (B, S, 9)."""
        x = self.token_norm(tokens[:, :, 0])
        B, S, _ = x.shape
        enc = None
        for _ in range(self.iters):
            src = (self.empty_pose_tokens.expand(B, S, -1) if enc is None
                   else enc)
            shift, scale, gate = self.poseLN_modulation(
                self.embed_pose(src)).chunk(3, dim=-1)
            y = gate * modulate(self.adaln_norm(x), shift, scale) + x
            for block in self.trunk:
                y = block(y)
            delta = self.pose_branch(self.trunk_norm(y))
            enc = delta if enc is None else enc + delta
        return torch.cat([enc[..., :7], F.relu(enc[..., 7:])], -1)


def uv_embedding(width: int, height: int, channels: int, aspect: float,
                 device):
    """VGGT's sinusoidal UV embedding (create_uv_grid, then
    position_grid_to_embed at omega 100) of a height × width grid spanning
    the frame's aspect ratio: (channels, height, width) float32."""
    diag = math.sqrt(aspect * aspect + 1.0)
    sx, sy = aspect / diag, 1.0 / diag
    xs = torch.linspace(-sx * (width - 1) / width, sx * (width - 1) / width,
                        width, dtype=torch.float32, device=device)
    ys = torch.linspace(-sy * (height - 1) / height,
                        sy * (height - 1) / height, height,
                        dtype=torch.float32, device=device)
    uu, vv = torch.meshgrid(xs, ys, indexing="xy")          # (H, W)
    half = channels // 2
    omega = torch.arange(half // 2, dtype=torch.float64, device=device)
    omega = 1.0 / UV_OMEGA ** (omega / (half / 2.0))

    def sincos(p):
        out = p.reshape(-1).double()[:, None] * omega[None]
        return torch.cat([torch.sin(out), torch.cos(out)], 1).float()
    emb = torch.cat([sincos(uu), sincos(vv)], -1)
    return emb.view(height, width, channels).permute(2, 0, 1)


class ResidualConvUnit(nn.Module):
    def __init__(self, f, generator=None):
        super().__init__()
        self.conv1 = conv(f, f, 3, padding=1, generator=generator)
        self.conv2 = conv(f, f, 3, padding=1, generator=generator)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FusionBlock(nn.Module):
    """RefineNet fusion: (+ resConfUnit1(skip)), resConfUnit2, bilinear
    upsampling (aligned corners) to `size` (2× without one), 1×1 out_conv."""

    def __init__(self, f, residual: bool = True, generator=None):
        super().__init__()
        if residual:
            self.resConfUnit1 = ResidualConvUnit(f, generator)
        self.resConfUnit2 = ResidualConvUnit(f, generator)
        self.out_conv = conv(f, f, 1, generator=generator)

    def forward(self, x, skip=None, size=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        x = F.interpolate(x, size=size, scale_factor=None if size else 2,
                          mode="bilinear", align_corners=True)
        return self.out_conv(x)


class DPTHead(nn.Module):
    """Four layers' tokens -> (B, S, out, H, W) maps at every pixel, before
    any activation (module docstring)."""

    def __init__(self, cfg, out: int, generator=None):
        super().__init__()
        self.cfg = cfg
        d, f, ch = 2 * cfg.width, cfg.dpt_features, cfg.dpt_channels
        self.norm = nn.LayerNorm(d, eps=EPS)
        self.projects = nn.ModuleList([conv(d, c, 1, generator=generator)
                                       for c in ch])
        self.resize_layers = nn.ModuleList([
            conv(ch[0], ch[0], 4, stride=4, generator=generator,
                 transpose=True),
            conv(ch[1], ch[1], 2, stride=2, generator=generator,
                 transpose=True),
            nn.Identity(),
            conv(ch[3], ch[3], 3, stride=2, padding=1, generator=generator)])
        s = nn.Module()
        for i, c in enumerate(ch):
            setattr(s, f"layer{i + 1}_rn", conv(c, f, 3, padding=1,
                                                bias=False,
                                                generator=generator))
        for i in range(4):
            setattr(s, f"refinenet{i + 1}", FusionBlock(f, i < 3, generator))
        s.output_conv1 = conv(f, f // 2, 3, padding=1, generator=generator)
        s.output_conv2 = nn.Sequential(
            conv(f // 2, 32, 3, padding=1, generator=generator), nn.ReLU(),
            conv(32, out, 1, generator=generator))
        self.scratch = s

    def _frames(self, feats, H, W):
        """The maps of one chunk of frames: feats, four (n, T', 2·width)
        patch-token tensors."""
        cfg, s = self.cfg, self.scratch
        rows, cols = H // cfg.patch, W // cfg.patch
        aspect = W / H
        maps = []
        for i, x in enumerate(feats):
            x = self.norm(x).transpose(1, 2).reshape(x.shape[0], -1, rows,
                                                     cols)
            x = self.projects[i](x)
            x = x + UV_RATIO * uv_embedding(cols, rows, x.shape[1], aspect,
                                            x.device)
            maps.append(self.resize_layers[i](x))
        l1, l2, l3, l4 = [getattr(s, f"layer{i + 1}_rn")(m)
                          for i, m in enumerate(maps)]
        out = s.refinenet4(l4, size=l3.shape[2:])
        out = s.refinenet3(out, l3, size=l2.shape[2:])
        out = s.refinenet2(out, l2, size=l1.shape[2:])
        out = s.output_conv1(s.refinenet1(out, l1))
        out = F.interpolate(out, size=(H, W), mode="bilinear",
                            align_corners=True)
        out = out + UV_RATIO * uv_embedding(W, H, out.shape[1], aspect,
                                            out.device)
        return s.output_conv2(out)

    @profiling.spanned("dpt")
    def forward(self, layers: dict, H: int, W: int):
        """layers: the aggregator's kept tokens by pair index, (B, S, T,
        2·width) each.  Returns (B, S, out, H, W)."""
        cfg = self.cfg
        first = 1 + cfg.registers
        B, S = layers[cfg.dpt_layers[0]].shape[:2]
        out = []
        for s0 in range(0, S, DPT_CHUNK):
            s1 = min(S, s0 + DPT_CHUNK)
            feats = [layers[i][:, s0:s1, first:].reshape(
                B * (s1 - s0), -1, layers[i].shape[-1])
                for i in cfg.dpt_layers]
            y = self._frames(feats, H, W)
            out.append(y.reshape(B, s1 - s0, *y.shape[1:]))
        return torch.cat(out, 1)
