"""AnySplat, feed-forward 3D Gaussian splatting from unposed views (Jiang et
al., "AnySplat: Feed-forward 3D Gaussian Splatting from Unconstrained
Views", arXiv:2505.23716), on VGGT's geometry transformer
(models/vggt.py).  No JAX counterpart.

Images in, no cameras: the aggregator's tokens give each view's camera
(the camera head's `absT_quaR_FoV` encoding, turned into row-vector
cameras by core.cameras.pose_encoding_to_cameras with each view's own
tangents), its depth (a DPT head: depth exp(·), confidence 1 + exp(·))
and its pixels' Gaussians (a second DPT head: colour 3, scale 3, rotation
4, opacity 1 and a merge confidence 1 a pixel).  Each pixel's Gaussian
sits at its depth along its pixel-centre ray through the predicted
camera.  The voxel merge (`voxel_merge`) then folds the pixel Gaussians
that share a voxel of size `voxel` into one: keys floor(xyz / voxel), and
within a voxel every field averaged with weights softmax(confidence)
(rotation renormalised).  The merged set comes out sorted by voxel key
(x, then y, then z), whatever the order of the pixels.

Activations: GS-LRM's (scaling = exp, opacity = sigmoid, rotation =
q / |q|, features_dc = the colour channels).  Initialisation: N(0,
INIT_STD) from the generator, zero biases (models/vggt.py), with these
heads' last layers set so that the seeded model predicts a scene a
capture would hold (`head_biases`): the camera head's pose branch scaled
by CAMERA_SCALE, its bias the identity quaternion and `fov_deg` in each
FoV, over the iterations that add it up; the depth head's depth row
scaled by DEPTH_SCALE and biased to log `depth_bias`; the Gaussian head's
rows scaled and biased per group by gslrm.split_dimensions' table
(colour, scale, rotation, opacity) and (1, 0) for the confidence.
State_dict keys: `aggregator.{patch_embed, camera_token, register_token,
frame_blocks, global_blocks}`, `camera_head`, `depth_head`,
`gaussian_head`.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from ..core import cameras
from ..utils import profiling
from . import gslrm
from .vggt import Aggregator, CameraHead, DPTHead

CAMERA_SCALE = 1e-2       # the pose branch's last layer
DEPTH_SCALE = 0.1         # the depth head's depth row
GAUSS_SPLITS = (3, 3, 4, 1, 1)   # colour, scale, rotation, opacity, conf


class AnySplatConfig(NamedTuple):
    """AnySplat's published widths (VGGT's aggregator and heads)."""
    views: int = 24
    resolution: int = 448       # square frames
    patch: int = 14
    width: int = 1024
    heads: int = 16
    mlp: int = 4096
    registers: int = 4
    dino_layers: int = 24
    dino_grid: int = 37         # DINOv2's 518-pixel position table
    dino_layer_scale: float = 1.0
    depth: int = 24             # frame and global block pairs
    rope_freq: float = 100.0
    layer_scale: float = 0.01
    camera_layers: int = 4
    camera_iters: int = 4
    camera_heads: int = 16
    dpt_layers: tuple = (4, 11, 17, 23)
    dpt_channels: tuple = (256, 512, 1024, 1024)
    dpt_features: int = 256
    sh_degree: int = 0
    voxel: float = 0.008        # about a pixel at depth_bias
    depth_bias: float = 3.0
    fov_deg: float = 60.0
    znear: float = 0.01
    zfar: float = 100.0

    @property
    def tokens_per_frame(self) -> int:
        return 1 + self.registers + (self.resolution // self.patch) ** 2

    @property
    def tokens(self) -> int:
        """The global attention's sequence."""
        return self.views * self.tokens_per_frame

    @property
    def gaussians(self) -> int:
        """Pixel Gaussians before the merge."""
        return self.views * self.resolution ** 2


def head_biases(model: nn.Module, cfg: AnySplatConfig):
    """Scale and bias the heads' last layers (module docstring)."""
    with torch.no_grad():
        fc = model.camera_head.pose_branch.fc2
        fc.weight.mul_(CAMERA_SCALE)
        fov = math.radians(cfg.fov_deg)
        fc.bias.copy_(torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, fov,
                                    fov]) / cfg.camera_iters)
        last = model.depth_head.scratch.output_conv2[2]
        last.weight[0].mul_(DEPTH_SCALE)
        last.bias.copy_(torch.tensor([math.log(cfg.depth_bias), 0.0]))
        last = model.gaussian_head.scratch.output_conv2[2]
        _, scales, biases = gslrm.split_dimensions(gslrm.GSLRMConfig())
        scale = torch.cat([torch.full((n,), s) for n, s in
                           zip(GAUSS_SPLITS, scales[:4] + [1.0])])
        bias = torch.cat([torch.full((n,), b) for n, b in
                          zip(GAUSS_SPLITS, biases[:4] + [0.0])])
        last.weight.mul_(scale.view(-1, 1, 1, 1).to(last.weight.device))
        last.bias.copy_(bias)


def pixel_rays(tan_fovx, tan_fovy, height: int, width: int):
    """Camera-space rays (..., H, W, 3) through the pixel centres, z = 1:
    x = ((2j + 1) / W - 1) tan_fovx, y = ((2i + 1) / H - 1) tan_fovy
    (core.cameras.plucker_rays' convention), for tangents (...)."""
    dev, dt = tan_fovx.device, tan_fovx.dtype
    ys = (2 * torch.arange(height, device=dev, dtype=dt) + 1) / height - 1
    xs = (2 * torch.arange(width, device=dev, dtype=dt) + 1) / width - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    x = gx * tan_fovx[..., None, None]
    y = gy * tan_fovy[..., None, None]
    return torch.stack([x, y, torch.ones_like(x)], -1)


def unproject(depth, cams: dict):
    """World points (B, S, H, W, 3) of z-depth maps (B, S, H, W) through
    pose_encoding_to_cameras' cameras: x_world = (d · ray - T) R."""
    H, W = depth.shape[-2:]
    rays = pixel_rays(cams["tan_fovx"], cams["tan_fovy"], H, W)
    wv = cams["world_view"]
    p_cam = depth[..., None] * rays - wv[..., None, None, 3, :3]
    # x_view = x_world @ wv[:3, :3] + T, and wv[:3, :3] is a rotation
    return torch.einsum("bshwj,bsij->bshwi", p_cam, wv[..., :3, :3])


def voxel_merge(g: dict, conf, voxel: float):
    """Fold the N Gaussians of g (fields (N, ...)) that share a voxel:
    keys floor(xyz / voxel); in each voxel every field is the average with
    weights softmax(conf) over its members (conf (N,)), the rotation then
    renormalised.  Returns (merged fields (K, ...), keys (K, 3) int64),
    sorted by key whatever the order of the input; in float32, each
    voxel's sums in segment reductions over its members in input order
    (no atomics, so a given input gives the same bits every time)."""
    keys = torch.floor(g["xyz"] / voxel).to(torch.int64)
    uniq, inv, counts = torch.unique(keys, dim=0, return_inverse=True,
                                     return_counts=True)
    order = torch.sort(inv, stable=True).indices
    c = conf[order]
    cmax = torch.segment_reduce(c, "max", lengths=counts)
    e = torch.exp(c - torch.repeat_interleave(cmax, counts))
    total = torch.segment_reduce(e, "sum", lengths=counts)
    w = e / torch.repeat_interleave(total, counts)
    out = {}
    for k, v in g.items():
        flat = v[order].reshape(v.shape[0], -1) * w[:, None]
        out[k] = torch.segment_reduce(flat, "sum", lengths=counts,
                                      axis=0).reshape(
            (uniq.shape[0],) + v.shape[1:])
    out["rotation"] = out["rotation"] / torch.linalg.norm(
        out["rotation"], dim=-1, keepdim=True)
    return out, uniq


class AnySplat(nn.Module):
    """Unposed views -> merged Gaussians and predicted cameras (module
    docstring)."""

    def __init__(self, cfg: AnySplatConfig,
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.sh_degree != 0:
            raise ValueError("this AnySplat's Gaussian head gives SH degree "
                             "0 colours")
        self.cfg = cfg
        self.aggregator = Aggregator(cfg, generator)
        self.camera_head = CameraHead(cfg, generator)
        self.depth_head = DPTHead(cfg, 2, generator)
        self.gaussian_head = DPTHead(cfg, sum(GAUSS_SPLITS), generator)
        head_biases(self, cfg)

    @profiling.spanned("anysplat")
    def forward(self, images):
        """images (1, S, H, W, 3) RGB in [0, 1], square frames at the
        configuration's resolution.

        Returns GS-LRM's Gaussian dict of the merged set, (1, K, ...),
        `voxels` (1, K, 3) int64, their voxel keys (ascending), and
        `cameras`: the predicted input cameras, `pose_enc` (1, S, 9) and
        pose_encoding_to_cameras' `world_view`, `full_proj` (1, S, 4, 4),
        `cam_centers` (1, S, 3), `tan_fovx` and `tan_fovy` (1, S).  While
        tracing is on (utils.profiling) the call is span `anysplat` with
        children `dinov2` and `aggregator` (24 `frame` and 24 `global`
        spans, each with its `attention`), `camera_head`, two `dpt` (depth,
        then Gaussians), `unproject` and `voxelize`, and counts
        `anysplat.gaussians` (before the merge) and `voxel.kept`."""
        cfg = self.cfg
        B, S, H, W, _ = images.shape
        if B != 1:
            raise ValueError(f"AnySplat serves one scene a call, got B = {B}")
        keep = set(cfg.dpt_layers) | {cfg.depth - 1}
        layers = self.aggregator(images, keep)
        enc = self.camera_head(layers[cfg.depth - 1])
        cams = cameras.pose_encoding_to_cameras(enc, cfg.znear, cfg.zfar)
        depth = torch.exp(self.depth_head(layers, H, W)[:, :, 0])
        raw = self.gaussian_head(layers, H, W)
        del layers
        with profiling.span("unproject"):
            xyz = unproject(depth, cams)
            n = S * H * W
            raw = raw.permute(0, 1, 3, 4, 2).reshape(n, -1)
            rgb, scale, rot, opa, conf = raw.split(GAUSS_SPLITS, -1)
            pixels = {"xyz": xyz.reshape(n, 3),
                      "opacity": torch.sigmoid(opa),
                      "scaling": torch.exp(scale),
                      "rotation": rot / torch.linalg.norm(rot, dim=-1,
                                                          keepdim=True),
                      "features_dc": rgb[:, None, :]}
        profiling.count("anysplat.gaussians", n)
        with profiling.span("voxelize"):
            g, keys = voxel_merge(pixels, conf[:, 0], cfg.voxel)
            del pixels
            g = {k: v[None] for k, v in g.items()}
            g["features_rest"] = g["features_dc"].new_zeros(
                (1, keys.shape[0], 0, 3))
            g["voxels"] = keys[None]
        profiling.count("voxel.kept", keys.shape[0])
        g["cameras"] = {"pose_enc": enc, **cams}
        return g
