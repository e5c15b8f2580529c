"""Long-LRM, the long-sequence large reconstruction model for wide-coverage
Gaussian splats (Chen et al., arXiv:2410.12781), scene-level: many posed
views in, pixel-aligned Gaussians out, pruned by opacity.  No JAX
counterpart.

Each of V views of W × H pixels carries 9 channels a pixel, GS-LRM's: its
RGB mapped to [-1, 1] and the pixel ray's Plücker coordinates
(core.cameras.plucker_rays).  The frame is padded at the bottom to a
multiple of patch · merge rows (RGB -1, rays continuing the frame's pixel
spacing) and cut into patch × patch tokens, one sequence over every view
in (view, row, column) order.  The blocks follow `layout`: `M` a Mamba2
block, x + Mamba2(LayerNorm(x)) (models/ssm.py), `T` GS-LRM's pre-LN
transformer block (models/gslrm.py:Block), `+` the token merge: per view,
each merge × merge group of tokens concatenated (Swin's patch merging,
arXiv:2103.14030), LayerNorm, and a linear layer back to the width with no
bias.  A final LayerNorm and a linear head give (patch · merge)² · 12
values a token, unpatchified to 12 channels a pixel as GS-LRM has them;
the padded rows are dropped.  The Gaussians are GS-LRM's (xyz = o + t·d,
t = near + (far - near)·sigmoid(w), exp scales, sigmoid opacities, unit
rotations), and pruning keeps the `keep` share of the most opaque: ties to
the lower index, the kept set in index order.

Weights are drawn as N(0, INIT_STD) with zero biases, Mamba2's dt, A and D
as models/ssm.py draws them, and the head scaled and biased per channel
group by gslrm.split_dimensions.  State_dict keys: `tokenizer`,
`blocks.{i}` (a Mamba2 block's `norm`, `mixer.{in_proj, conv1d, dt_bias,
A_log, D, norm, out_proj}`; a transformer block's GS-LRM keys), `merge.
{norm, reduction}`, `norm`, `head`.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from ..core import cameras
from ..utils import profiling
from . import gslrm
from .ssm import Mamba2

SQRT3 = math.sqrt(3.0)
INIT_STD = gslrm.INIT_STD


class LongLRMConfig(NamedTuple):
    """The scene-level model's published shape (arXiv:2410.12781)."""
    views: int = 32
    frame_width: int = 960
    frame_height: int = 540
    patch: int = 8
    width: int = 1024
    # M: Mamba2 block, T: transformer block, +: the token merge
    layout: str = "MMMMMMM+TMMMMMMMTMMMMMMMT"
    heads: int = 16
    mlp: int = 4096
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    ngroups: int = 1
    chunk: int = 256
    merge: int = 2
    gaussian_channels: int = 12
    sh_degree: int = 0
    keep: float = 0.25
    # the camera radius ∓ the scene's half-diagonal
    near: float = 3.0 - SQRT3
    far: float = 3.0 + SQRT3

    @property
    def padded_height(self) -> int:
        step = self.patch * self.merge
        return -(-self.frame_height // step) * step

    @property
    def tokens(self) -> int:
        """Tokens before the merge."""
        return (self.views * (self.padded_height // self.patch)
                * (self.frame_width // self.patch))

    @property
    def gaussians(self) -> int:
        """Pixel-aligned Gaussians before pruning."""
        return self.views * self.frame_height * self.frame_width

    @property
    def kept(self) -> int:
        return int(self.gaussians * self.keep)


class MambaBlock(nn.Module):
    """x + Mamba2(LayerNorm(x))."""

    def __init__(self, cfg: LongLRMConfig, generator=None):
        super().__init__()
        self.norm = nn.LayerNorm(cfg.width, eps=1e-5)
        self.mixer = Mamba2(cfg.width, cfg.d_state, cfg.d_conv, cfg.expand,
                            cfg.head_dim, cfg.ngroups, cfg.chunk, INIT_STD,
                            generator)

    @profiling.spanned("mamba2")
    def forward(self, x):
        return x + self.mixer(self.norm(x))


class PatchMerge(nn.Module):
    """Per view, each merge × merge group of tokens concatenated in Swin's
    order (row offset fastest, then column offset), LayerNorm, and a
    linear layer to `width` with no bias."""

    def __init__(self, cfg: LongLRMConfig, generator=None):
        super().__init__()
        self.m = cfg.merge
        wide = cfg.merge * cfg.merge * cfg.width
        self.norm = nn.LayerNorm(wide, eps=1e-5)
        self.reduction = gslrm.Linear(wide, cfg.width, INIT_STD, generator,
                                      bias=False)

    def forward(self, x, views: int, rows: int, cols: int):
        B, _, C = x.shape
        m = self.m
        x = x.reshape(B, views, rows // m, m, cols // m, m, C)
        x = x.permute(0, 1, 2, 4, 5, 3, 6).reshape(
            B, views * (rows // m) * (cols // m), m * m * C)
        return self.reduction(self.norm(x))


def prune(opacity, k: int):
    """The indices (B, k), ascending, of each row's k largest opacities
    (B, N); equal opacities go to the lower index."""
    order = torch.sort(opacity, dim=-1, descending=True, stable=True).indices
    return order[:, :k].sort(dim=-1).values


class LongLRM(nn.Module):
    """Posed views -> pruned pixel-aligned Gaussians (module docstring)."""

    def __init__(self, cfg: LongLRMConfig,
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.sh_degree != 0:
            raise ValueError("Long-LRM's head gives SH degree 0 colours")
        if set(cfg.layout) - set("MT+") or cfg.layout.count("+") != 1:
            raise ValueError(f"layout {cfg.layout!r}: M, T and one +")
        self.cfg = cfg
        p, std = cfg.patch, INIT_STD
        self.tokenizer = gslrm.Linear(p * p * 9, cfg.width, std, generator)
        self.blocks = nn.ModuleList([
            MambaBlock(cfg, generator) if kind == "M"
            else gslrm.Block(cfg, generator)
            for kind in cfg.layout if kind != "+"])
        self.merge = PatchMerge(cfg, generator)
        self.norm = nn.LayerNorm(cfg.width, eps=1e-5)
        hp = p * cfg.merge
        self.head = gslrm.Linear(cfg.width, hp * hp * cfg.gaussian_channels,
                                 std, generator)
        splits, scales, biases = gslrm.split_dimensions(cfg)
        with torch.no_grad():
            scale = torch.cat([torch.full((n,), s)
                               for n, s in zip(splits, scales)])
            bias = torch.cat([torch.full((n,), b)
                              for n, b in zip(splits, biases)])
            # the head's rows are (row, column, channel) of its patch
            self.head.weight.mul_(scale.repeat(hp * hp)[:, None].to(
                self.head.weight.device))
            self.head.bias.copy_(bias.repeat(hp * hp))

    @profiling.spanned("longlrm")
    def forward(self, images, world_views, tan_fovx: float, tan_fovy: float):
        """images (B, V, H, W, 3) RGB in [0, 1] at the configuration's
        frame size; world_views (B, V, 4, 4) row-vector world->view tensors
        of the input cameras, tan_fovx and tan_fovy their tangents.

        Returns GS-LRM's Gaussian dict of the kept Gaussians, (B, K, ...)
        with K = cfg.kept, and `kept` (B, K) int64: their indices into the
        V·H·W per-pixel Gaussians in (view, row, column) order, ascending.
        While tracing is on (utils.profiling) the call is span `longlrm`
        with children `tokens`, `blocks` (21 `mamba2` spans, each with its
        `ssd`, 3 `attention` spans and `merge` at the published layout),
        `head` and `prune`, and counts `longlrm.gaussians` (before
        pruning) and `prune.kept`."""
        cfg = self.cfg
        B, V, H, W, _ = images.shape
        p, Hp = cfg.patch, cfg.padded_height
        with profiling.span("tokens"):
            o, d, plucker = cameras.plucker_rays(world_views, tan_fovx,
                                                 tan_fovy, H, W, rows=Hp)
            rgb = torch.nn.functional.pad(images * 2.0 - 1.0,
                                          (0, 0, 0, 0, 0, Hp - H),
                                          value=-1.0)
            x = self.tokenizer(gslrm.patchify(torch.cat([rgb, plucker], -1),
                                              p))
        rows, cols = Hp // p, W // p
        blocks = iter(self.blocks)
        with profiling.span("blocks"):
            for kind in cfg.layout:
                if kind == "+":
                    with profiling.span("merge"):
                        x = self.merge(x, V, rows, cols)
                    rows, cols = rows // cfg.merge, cols // cfg.merge
                else:
                    x = next(blocks)(x)
        n = V * H * W
        with profiling.span("head"):
            out = gslrm.unpatchify(self.head(self.norm(x)), V, Hp, W,
                                   p * cfg.merge)[:, :, :H].reshape(B, n, -1)
        profiling.count("longlrm.gaussians", B * n)
        splits = gslrm.split_dimensions(cfg)[0]
        with profiling.span("prune"):
            opa_at = sum(splits[:3])
            kept = prune(torch.sigmoid(out[..., opa_at]), cfg.kept)
            raw = torch.gather(out, 1, kept[..., None].expand(
                -1, -1, out.shape[-1]))
            dirs = torch.gather(d[:, :, :H].reshape(B, n, 3), 1,
                                kept[..., None].expand(-1, -1, 3))
            origin = torch.gather(o, 1, (kept // (H * W))[..., None].expand(
                -1, -1, 3))
            rgb, scale, rot, opa, dist = raw.split(splits, -1)
            t = cfg.near + (cfg.far - cfg.near) * torch.sigmoid(dist)
            g = {"xyz": origin + t * dirs,
                 "opacity": torch.sigmoid(opa),
                 "scaling": torch.exp(scale),
                 "rotation": rot / torch.linalg.norm(rot, dim=-1,
                                                     keepdim=True),
                 "features_dc": rgb[:, :, None, :]}
            g["features_rest"] = g["features_dc"].new_zeros(
                (B, kept.shape[1], 0, 3))
            g["kept"] = kept
        profiling.count("prune.kept", kept.numel())
        return g
