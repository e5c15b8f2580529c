"""A plain PyTorch reference of AnySplat (Jiang et al., "AnySplat:
Feed-forward 3D Gaussian Splatting from Unconstrained Views",
arXiv:2505.23716) on VGGT's aggregator and heads (Wang et al., CVPR 2025,
arXiv:2503.11651), in float32.

It imports torch and math only: nothing of the port and no kernel, so it
stands beside the port as its yardstick, on the CPU at a small size and on
the card at the published widths (24 views at 448², patch 14, DINOv2
ViT-L/14 with 4 registers, 24 frame and 24 global blocks of width 1024,
16 heads of 64, MLP 4096, the camera head's 4-block trunk at 2048 over 4
iterations, two DPT heads on layers 4, 11, 17 and 23).  Written out:
every linear layer as a matrix product, the LayerNorms, GELU, softmax
attention as scores, max, exp, sum and weighted values a block of queries
of one head at a time, the 2D RoPE as a rotation of each pair of features,
the convolutions as im2col products one frame at a time, the transposed
convolutions as products into each output block, the bilinear resizes
(aligned corners) as interpolation matrices, the quaternion to rotation,
and the voxel merge as torch.unique with its inverse and index_add_.
`resolve_device` turns TF32 off for matmuls and cuDNN at every forward.

Departures from the published description, each an assumption of the
benchmark's configuration (benchmark/configs/anysplat_scene_448.json):
- DINOv2's 37 × 37 position table is resized to the frame's patch grid by
  F.interpolate (bicubic, antialiased, to the grid's size), the one
  library resampling left in.
- LayerNorm eps 1e-6 everywhere (DINOv2's; VGGT's camera head's adaLN
  norm's), LayerScale 1.0 in DINOv2 (VGGT's constructor) and 0.01 in the
  aggregator and the camera trunk.
- Pixel rays through pixel centres ((j + 0.5 - W/2) / f), the port's
  renderer's convention, where VGGT's unprojection uses integer pixels.
- The Gaussian head is a second DPT head of the depth head's shape with
  12 outputs a pixel (colour 3, scale 3, rotation 4, opacity 1, merge
  confidence 1), no RGB shortcut, SH degree 0; GS-LRM's activations.
- The voxel merge's weights are softmax over the Gaussian head's raw
  confidence within each voxel, averaging the activated fields (the
  rotation renormalised).
- Weights: N(0, 0.02) with zero biases (tokens N(0, 1e-6)); the heads'
  last layers scaled and biased: the pose branch's weight x 1e-2, bias
  (identity quaternion, FoV 60 degrees) / iterations; the depth row x 0.1,
  bias log 3; the Gaussian head's rows by group: colour (5, 0), scale
  (5e-4, log 0.01), rotation (1, 0), opacity (1e-3, -3), confidence
  (1, 0).
- Precision: float32 throughout (the paper runs mixed precision).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class AnySplatConfig(NamedTuple):
    views: int = 24
    resolution: int = 448
    patch: int = 14
    width: int = 1024
    heads: int = 16
    mlp: int = 4096
    registers: int = 4
    dino_layers: int = 24
    dino_grid: int = 37
    dino_layer_scale: float = 1.0
    depth: int = 24
    rope_freq: float = 100.0
    layer_scale: float = 0.01
    camera_layers: int = 4
    camera_iters: int = 4
    camera_heads: int = 16
    dpt_layers: tuple = (4, 11, 17, 23)
    dpt_channels: tuple = (256, 512, 1024, 1024)
    dpt_features: int = 256
    sh_degree: int = 0
    voxel: float = 0.008
    depth_bias: float = 3.0
    fov_deg: float = 60.0
    znear: float = 0.01
    zfar: float = 100.0


INIT_STD = 0.02
TOKEN_STD = 1e-6
EPS = 1e-6
CAMERA_SCALE = 1e-2
DEPTH_SCALE = 0.1
GAUSS_SPLITS = (3, 3, 4, 1, 1)
GROUP_SCALE = (5.0, 5e-4, 1.0, 1e-3, 1.0)
GROUP_BIAS = (0.0, math.log(0.01), 0.0, -3.0, 0.0)
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
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


def _const(shape, value):
    return torch.nn.Parameter(torch.full(tuple(shape), float(value)))


class Linear(torch.nn.Module):
    def __init__(self, cin, cout, generator):
        super().__init__()
        self.weight = _normal((cout, cin), INIT_STD, generator)
        self.bias = _const((cout,), 0.0)

    def forward(self, x):
        return x @ self.weight.t() + self.bias


class LayerNorm(torch.nn.Module):
    def __init__(self, c, affine=True):
        super().__init__()
        if affine:
            self.weight = _const((c,), 1.0)
            self.bias = _const((c,), 0.0)
        self.affine = affine

    def forward(self, x):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        y = (x - mu) / torch.sqrt(var + EPS)
        return y * self.weight + self.bias if self.affine else y


def gelu(x):
    """Exact GELU: x Φ(x)."""
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def blocked_attention(q, k, v, block_bytes: int = QUERY_BLOCK_BYTES):
    """softmax(q k^T / sqrt(d)) v written out, one head and one block of
    queries at a time.  q, k, v: (N, H, L, d)."""
    N, H, L, d = q.shape
    rows = max(1, min(L, block_bytes // (k.shape[2] * 4)))
    out = torch.empty_like(q)
    for n in range(N):
        for h in range(H):
            kt = k[n, h].t()
            for r in range(0, L, rows):
                s = (q[n, h, r:r + rows] @ kt) / math.sqrt(d)
                e = torch.exp(s - s.max(-1, keepdim=True).values)
                out[n, h, r:r + rows] = (e / e.sum(-1, keepdim=True)) @ v[n, h]
    return out


def rope_angles(pos, head_dim, freq):
    """(L, head_dim / 2) angles: for each half of a head (rows, then
    columns), pair i of its features turns by pos · freq^(-2i / half)."""
    half = head_dim // 2
    inv = torch.tensor([freq ** (-(2.0 * i) / half)
                        for i in range(half // 2)],
                       dtype=torch.float32, device=pos.device)
    return torch.cat([pos[:, 0:1].float() * inv, pos[:, 1:2].float() * inv],
                     1)


def rope(x, ang):
    """Rotate each pair of x's features (..., L, d): within each half of
    d (rows, then columns), feature i and feature i + d/4 as a 2D vector
    by its angle."""
    d = x.shape[-1]
    half, q = d // 2, d // 4
    out = torch.empty_like(x)
    for part in range(2):
        a = ang[:, part * q:(part + 1) * q]
        c, s = torch.cos(a), torch.sin(a)
        lo = x[..., part * half:part * half + q]
        hi = x[..., part * half + q:(part + 1) * half]
        out[..., part * half:part * half + q] = lo * c - hi * s
        out[..., part * half + q:(part + 1) * half] = hi * c + lo * s
    return out


class LayerScale(torch.nn.Module):
    def __init__(self, c, init):
        super().__init__()
        self.gamma = _const((c,), init)

    def forward(self, x):
        return x * self.gamma


class Attention(torch.nn.Module):
    def __init__(self, dim, heads, qk_norm, generator):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim, generator)
        self.proj = Linear(dim, dim, generator)
        if qk_norm:
            self.q_norm = LayerNorm(dim // heads)
            self.k_norm = LayerNorm(dim // heads)
        self.qk_norm = qk_norm

    def forward(self, x, ang=None):
        N, L, C = x.shape
        dh = C // self.heads
        qkv = self.qkv(x)
        q, k, v = [qkv[..., i * C:(i + 1) * C].reshape(
            N, L, self.heads, dh).permute(0, 2, 1, 3) for i in range(3)]
        if self.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        if ang is not None:
            q, k = rope(q, ang), rope(k, ang)
        o = blocked_attention(q, k, v)
        return self.proj(o.permute(0, 2, 1, 3).reshape(N, L, C))


class MLP(torch.nn.Module):
    def __init__(self, dim, hidden, generator):
        super().__init__()
        self.fc1 = Linear(dim, hidden, generator)
        self.fc2 = Linear(hidden, dim, generator)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class Block(torch.nn.Module):
    def __init__(self, dim, heads, mlp, ls, qk_norm, generator):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, heads, qk_norm, generator)
        self.ls1 = LayerScale(dim, ls)
        self.norm2 = LayerNorm(dim)
        self.mlp = MLP(dim, mlp, generator)
        self.ls2 = LayerScale(dim, ls)

    def forward(self, x, ang=None):
        x = x + self.ls1(self.attn(self.norm1(x), ang))
        return x + self.ls2(self.mlp(self.norm2(x)))


class Conv(torch.nn.Module):
    """A k x k convolution (stride, zero padding) or, with `transpose`, a
    transposed one with kernel = stride, one frame at a time."""

    def __init__(self, cin, cout, k, stride=1, padding=0, bias=True,
                 transpose=False, generator=None):
        super().__init__()
        shape = (cin, cout, k, k) if transpose else (cout, cin, k, k)
        self.weight = _normal(shape, INIT_STD, generator)
        if bias:
            self.bias = _const((cout,), 0.0)
        self.has_bias, self.k, self.stride = bias, k, stride
        self.padding, self.transpose = padding, transpose

    def forward(self, x):
        return torch.stack([self._one(f) for f in x])

    def _one(self, x):
        C, H, W = x.shape
        k, s = self.k, self.stride
        if self.transpose:
            # each input pixel writes one k x k block of the output
            y = torch.einsum("chw,coab->ohawb", x, self.weight)
            y = y.reshape(-1, H * k, W * k)
        else:
            Ho = (H + 2 * self.padding - k) // s + 1
            Wo = (W + 2 * self.padding - k) // s + 1
            cols = torch.nn.functional.unfold(x[None], k, padding=self.padding,
                                              stride=s)[0]
            y = (self.weight.reshape(self.weight.shape[0], -1) @ cols)
            y = y.reshape(-1, Ho, Wo)
        return y + self.bias[:, None, None] if self.has_bias else y


def interp_matrix(n_out, n_in, device):
    """(n_out, n_in) bilinear weights with aligned corners."""
    m = torch.zeros(n_out, n_in, device=device)
    if n_in == 1 or n_out == 1:
        m[:, 0] = 1.0
        return m
    for o in range(n_out):
        src = o * (n_in - 1) / (n_out - 1)
        i0 = min(int(math.floor(src)), n_in - 1)
        i1 = min(i0 + 1, n_in - 1)
        f = src - i0
        m[o, i0] += 1.0 - f
        m[o, i1] += f
    return m


def resize(x, h, w):
    """Bilinear resize of (N, C, H, W) to (h, w), corners aligned."""
    mh = interp_matrix(h, x.shape[2], x.device)
    mw = interp_matrix(w, x.shape[3], x.device)
    return torch.einsum("oh,nchw,pw->ncop", mh, x, mw)


def uv_embed(width, height, channels, aspect, device):
    """VGGT's UV grid spanning the aspect ratio, each coordinate's
    sin / cos at frequencies 100^(-i / (channels / 4)): (C, H, W)."""
    diag = math.sqrt(aspect * aspect + 1.0)
    sx, sy = aspect / diag, 1.0 / diag
    xs = torch.linspace(-sx * (width - 1) / width, sx * (width - 1) / width,
                        width, device=device)
    ys = torch.linspace(-sy * (height - 1) / height,
                        sy * (height - 1) / height, height, device=device)
    q = channels // 4
    om = torch.tensor([1.0 / 100.0 ** (i / (channels / 4.0))
                       for i in range(q)], dtype=torch.float64, device=device)
    ex = xs.double()[:, None] * om[None]              # (W, q)
    ey = ys.double()[:, None] * om[None]              # (H, q)
    out = torch.empty(channels, height, width, dtype=torch.float64,
                      device=device)
    out[:q] = torch.sin(ex).t()[:, None, :]
    out[q:2 * q] = torch.cos(ex).t()[:, None, :]
    out[2 * q:3 * q] = torch.sin(ey).t()[:, :, None]
    out[3 * q:] = torch.cos(ey).t()[:, :, None]
    return out.float()


class DINOv2(torch.nn.Module):
    def __init__(self, cfg, generator):
        super().__init__()
        w, p, g = cfg.width, cfg.patch, cfg.dino_grid
        self.cfg = cfg
        self.patch_embed = torch.nn.Module()
        self.patch_embed.proj = Conv(3, w, p, stride=p, generator=generator)
        self.cls_token = _normal((1, 1, w), TOKEN_STD, generator)
        self.register_tokens = _normal((1, cfg.registers, w), TOKEN_STD,
                                       generator)
        self.pos_embed = _normal((1, 1 + g * g, w), INIT_STD, generator)
        self.blocks = torch.nn.ModuleList([
            Block(w, cfg.heads, cfg.mlp, cfg.dino_layer_scale, False,
                  generator) for _ in range(cfg.dino_layers)])
        self.norm = LayerNorm(w)

    def forward(self, frames):
        cfg = self.cfg
        N, _, H, W = frames.shape
        p, g = cfg.patch, cfg.dino_grid
        rows, cols = H // p, W // p
        # the patch embedding: each patch's (channel, row, column) values
        # times the kernel
        x = frames.reshape(N, 3, rows, p, cols, p).permute(0, 2, 4, 1, 3, 5)
        x = x.reshape(N, rows * cols, 3 * p * p)
        wt = self.patch_embed.proj.weight.reshape(cfg.width, -1)
        x = x @ wt.t() + self.patch_embed.proj.bias
        table = self.pos_embed[:, 1:].reshape(1, g, g, -1).permute(0, 3, 1, 2)
        if (rows, cols) != (g, g):
            table = torch.nn.functional.interpolate(
                table, size=(rows, cols), mode="bicubic", align_corners=False,
                antialias=True)
        table = table.permute(0, 2, 3, 1).reshape(1, rows * cols, -1)
        cls = self.cls_token.expand(N, -1, -1) + self.pos_embed[:, :1]
        x = torch.cat([cls, self.register_tokens.expand(N, -1, -1),
                       x + table], 1)
        for b in self.blocks:
            x = b(x)
        return self.norm(x)[:, 1 + cfg.registers:]


class Aggregator(torch.nn.Module):
    def __init__(self, cfg, generator):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.patch_embed = DINOv2(cfg, generator)
        self.camera_token = _normal((1, 2, 1, w), TOKEN_STD, generator)
        self.register_token = _normal((1, 2, cfg.registers, w), TOKEN_STD,
                                      generator)
        self.frame_blocks = torch.nn.ModuleList([
            Block(w, cfg.heads, cfg.mlp, cfg.layer_scale, True, generator)
            for _ in range(cfg.depth)])
        self.global_blocks = torch.nn.ModuleList([
            Block(w, cfg.heads, cfg.mlp, cfg.layer_scale, True, generator)
            for _ in range(cfg.depth)])

    def forward(self, images, keep):
        cfg = self.cfg
        B, S, H, W, _ = images.shape
        dev = images.device
        mean = torch.tensor(MEAN, device=dev)
        std = torch.tensor(STD, device=dev)
        frames = ((images - mean) / std).reshape(B * S, H, W, 3)
        patches = self.patch_embed(frames.permute(0, 3, 1, 2))
        C = cfg.width
        first = torch.cat([self.camera_token[:, 0], self.register_token[:, 0]],
                          1)
        rest = torch.cat([self.camera_token[:, 1], self.register_token[:, 1]],
                         1)
        special = torch.cat([first[:, None], rest[:, None].expand(
            1, S - 1, -1, -1)], 1).expand(B, -1, -1, -1)
        x = torch.cat([special.reshape(B * S, -1, C), patches], 1)
        T = x.shape[1]
        rows, cols = H // cfg.patch, W // cfg.patch
        pos = torch.zeros(T, 2, device=dev)
        r = torch.arange(rows, device=dev).repeat_interleave(cols)
        c = torch.arange(cols, device=dev).repeat(rows)
        pos[1 + cfg.registers:, 0] = r + 1.0
        pos[1 + cfg.registers:, 1] = c + 1.0
        ang = rope_angles(pos, C // cfg.heads, cfg.rope_freq)
        ang_all = ang.repeat(S, 1)
        out = {}
        for i in range(cfg.depth):
            x = self.frame_blocks[i](x.reshape(B * S, T, C), ang)
            frame = x.reshape(B, S, T, C)
            x = self.global_blocks[i](x.reshape(B, S * T, C), ang_all)
            if i in keep:
                out[i] = torch.cat([frame, x.reshape(B, S, T, C)], -1)
        return out, patches


class PoseBranch(torch.nn.Module):
    def __init__(self, dim, generator):
        super().__init__()
        self.fc1 = Linear(dim, dim // 2, generator)
        self.fc2 = Linear(dim // 2, 9, generator)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class CameraHead(torch.nn.Module):
    def __init__(self, cfg, generator):
        super().__init__()
        d = 2 * cfg.width
        self.iters = cfg.camera_iters
        self.token_norm = LayerNorm(d)
        self.trunk = torch.nn.ModuleList([
            Block(d, cfg.camera_heads, 4 * d, cfg.layer_scale, False,
                  generator) for _ in range(cfg.camera_layers)])
        self.trunk_norm = LayerNorm(d)
        self.empty_pose_tokens = _const((1, 1, 9), 0.0)
        self.embed_pose = Linear(9, d, generator)
        self.poseLN_modulation = torch.nn.ModuleList(
            [torch.nn.Identity(), Linear(d, 3 * d, generator)])
        self.adaln_norm = LayerNorm(d, affine=False)
        self.pose_branch = PoseBranch(d, generator)

    def forward(self, tokens):
        x = self.token_norm(tokens[:, :, 0])
        B, S, d = x.shape
        enc = None
        for _ in range(self.iters):
            src = self.empty_pose_tokens.expand(B, S, -1) if enc is None \
                else enc
            e = self.embed_pose(src)
            mod = self.poseLN_modulation[1](e * torch.sigmoid(e))
            shift, scale = mod[..., :d], mod[..., d:2 * d]
            gate = mod[..., 2 * d:]
            y = gate * (self.adaln_norm(x) * (1 + scale) + shift) + x
            for b in self.trunk:
                y = b(y)
            delta = self.pose_branch(self.trunk_norm(y))
            enc = delta if enc is None else enc + delta
        fov = torch.where(enc[..., 7:] > 0, enc[..., 7:],
                          torch.zeros_like(enc[..., 7:]))
        return torch.cat([enc[..., :7], fov], -1)


class RCU(torch.nn.Module):
    def __init__(self, f, generator):
        super().__init__()
        self.conv1 = Conv(f, f, 3, padding=1, generator=generator)
        self.conv2 = Conv(f, f, 3, padding=1, generator=generator)

    def forward(self, x):
        return self.conv2(torch.relu(self.conv1(torch.relu(x)))) + x


class Fusion(torch.nn.Module):
    def __init__(self, f, residual, generator):
        super().__init__()
        if residual:
            self.resConfUnit1 = RCU(f, generator)
        self.resConfUnit2 = RCU(f, generator)
        self.out_conv = Conv(f, f, 1, generator=generator)

    def forward(self, x, skip=None, size=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        h, w = size if size is not None else (2 * x.shape[2], 2 * x.shape[3])
        return self.out_conv(resize(x, h, w))


class DPTHead(torch.nn.Module):
    def __init__(self, cfg, out, generator):
        super().__init__()
        self.cfg = cfg
        d, f, ch = 2 * cfg.width, cfg.dpt_features, cfg.dpt_channels
        self.norm = LayerNorm(d)
        self.projects = torch.nn.ModuleList([Conv(d, c, 1, generator=generator)
                                             for c in ch])
        self.resize_layers = torch.nn.ModuleList([
            Conv(ch[0], ch[0], 4, stride=4, transpose=True,
                 generator=generator),
            Conv(ch[1], ch[1], 2, stride=2, transpose=True,
                 generator=generator),
            torch.nn.Identity(),
            Conv(ch[3], ch[3], 3, stride=2, padding=1, generator=generator)])
        s = torch.nn.Module()
        for i, c in enumerate(ch):
            setattr(s, f"layer{i + 1}_rn", Conv(c, f, 3, padding=1,
                                                bias=False,
                                                generator=generator))
        for i in range(4):
            setattr(s, f"refinenet{i + 1}", Fusion(f, i < 3, generator))
        s.output_conv1 = Conv(f, f // 2, 3, padding=1, generator=generator)
        s.output_conv2 = torch.nn.ModuleList([
            Conv(f // 2, 32, 3, padding=1, generator=generator),
            torch.nn.Identity(), Conv(32, out, 1, generator=generator)])
        self.scratch = s

    def forward(self, layers, H, W):
        cfg, s = self.cfg, self.scratch
        first = 1 + cfg.registers
        rows, cols = H // cfg.patch, W // cfg.patch
        B, S = layers[cfg.dpt_layers[0]].shape[:2]
        out = []
        for f in range(S):
            maps = []
            for i, li in enumerate(cfg.dpt_layers):
                x = self.norm(layers[li][:, f, first:])       # (B, P, 2w)
                x = x.transpose(1, 2).reshape(B, -1, rows, cols)
                x = self.projects[i](x)
                x = x + 0.1 * uv_embed(cols, rows, x.shape[1], W / H,
                                       x.device)
                maps.append(self.resize_layers[i](x))
            l1, l2, l3, l4 = [getattr(s, f"layer{i + 1}_rn")(m)
                              for i, m in enumerate(maps)]
            y = s.refinenet4(l4, size=l3.shape[2:])
            y = s.refinenet3(y, l3, size=l2.shape[2:])
            y = s.refinenet2(y, l2, size=l1.shape[2:])
            y = s.output_conv1(s.refinenet1(y, l1))
            y = resize(y, H, W)
            y = y + 0.1 * uv_embed(W, H, y.shape[1], W / H, y.device)
            y = s.output_conv2[2](torch.relu(s.output_conv2[0](y)))
            out.append(y)
        return torch.stack(out, 1)                          # (B, S, C, H, W)


def pose_to_cameras(enc, znear, zfar):
    """The port's row-vector cameras of VGGT's encodings (..., 9):
    world_view, full_proj, cam_centers, tan_fovx, tan_fovy."""
    T = enc[..., :3]
    x, y, z, w = enc[..., 3], enc[..., 4], enc[..., 5], enc[..., 6]
    n2 = x * x + y * y + z * z + w * w
    R = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z) / n2, 2 * (x * y - z * w) / n2,
                     2 * (x * z + y * w) / n2], -1),
        torch.stack([2 * (x * y + z * w) / n2, 1 - 2 * (x * x + z * z) / n2,
                     2 * (y * z - x * w) / n2], -1),
        torch.stack([2 * (x * z - y * w) / n2, 2 * (y * z + x * w) / n2,
                     1 - 2 * (x * x + y * y) / n2], -1)], -2)
    tan_y = torch.tan(enc[..., 7] * 0.5)
    tan_x = torch.tan(enc[..., 8] * 0.5)
    lead = enc.shape[:-1]
    wv = torch.zeros(lead + (4, 4), device=enc.device)
    wv[..., :3, :3] = R.transpose(-1, -2)
    wv[..., 3, :3] = T
    wv[..., 3, 3] = 1.0
    proj = torch.zeros(lead + (4, 4), device=enc.device)
    proj[..., 0, 0] = 1.0 / tan_x
    proj[..., 1, 1] = 1.0 / tan_y
    proj[..., 2, 2] = (znear + zfar) / (zfar - znear)
    proj[..., 3, 2] = -(zfar * znear) / (zfar - znear)
    proj[..., 2, 3] = 1.0
    centers = -torch.einsum("...j,...ji->...i", T, R)
    return {"world_view": wv, "full_proj": wv @ proj, "cam_centers": centers,
            "tan_fovx": tan_x, "tan_fovy": tan_y}


def merge(pixels, conf, voxel):
    """The voxel merge: keys floor(xyz / voxel), softmax(conf) weights in
    each voxel, weighted sums by index_add_, the rotation renormalised.
    Returns (merged fields, keys (K, 3)), keys ascending."""
    keys = torch.floor(pixels["xyz"] / voxel).long()
    uniq, inv = torch.unique(keys, dim=0, return_inverse=True)
    K = uniq.shape[0]
    cmax = torch.full((K,), -float("inf"), device=conf.device)
    cmax = cmax.scatter_reduce(0, inv, conf, "amax")
    e = torch.exp(conf - cmax[inv])
    tot = torch.zeros(K, device=conf.device).index_add_(0, inv, e)
    w = e / tot[inv]
    out = {}
    for k, v in pixels.items():
        flat = v.reshape(v.shape[0], -1)
        acc = torch.zeros(K, flat.shape[1], device=v.device)
        out[k] = acc.index_add_(0, inv, flat * w[:, None]).reshape(
            (K,) + v.shape[1:])
    out["rotation"] = out["rotation"] / torch.sqrt(
        (out["rotation"] ** 2).sum(-1, keepdim=True))
    return out, uniq


class AnySplat(torch.nn.Module):
    def __init__(self, cfg: AnySplatConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        self.aggregator = Aggregator(cfg, generator)
        self.camera_head = CameraHead(cfg, generator)
        self.depth_head = DPTHead(cfg, 2, generator)
        self.gaussian_head = DPTHead(cfg, sum(GAUSS_SPLITS), generator)
        with torch.no_grad():
            fc = self.camera_head.pose_branch.fc2
            fc.weight.mul_(CAMERA_SCALE)
            fov = math.radians(cfg.fov_deg)
            fc.bias.copy_(torch.tensor([0.0, 0, 0, 0, 0, 0, 1, fov, fov],
                                       device=fc.bias.device)
                          / cfg.camera_iters)
            last = self.depth_head.scratch.output_conv2[2]
            last.weight[0].mul_(DEPTH_SCALE)
            last.bias.copy_(torch.tensor([math.log(cfg.depth_bias), 0.0],
                                         device=last.bias.device))
            last = self.gaussian_head.scratch.output_conv2[2]
            for c0, n, sc, bi in zip(
                    [sum(GAUSS_SPLITS[:i]) for i in range(5)], GAUSS_SPLITS,
                    GROUP_SCALE, GROUP_BIAS):
                last.weight[c0:c0 + n].mul_(sc)
                last.bias[c0:c0 + n] = bi

    def forward(self, images):
        """images (1, S, H, W, 3) in [0, 1] -> (merged Gaussians with
        `voxels` and `cameras`, aux: `patch_tokens` (DINOv2's), `tokens`
        (the last pair's 2048-wide tokens), `depth` (1, S, H, W) and
        `pixels` (each pixel's Gaussian fields and voxel keys))."""
        resolve_device(like=images)
        cfg = self.cfg
        B, S, H, W, _ = images.shape
        keep = set(cfg.dpt_layers) | {cfg.depth - 1}
        layers, patches = self.aggregator(images, keep)
        enc = self.camera_head(layers[cfg.depth - 1])
        cams = pose_to_cameras(enc, cfg.znear, cfg.zfar)
        depth = torch.exp(self.depth_head(layers, H, W)[:, :, 0])
        raw = self.gaussian_head(layers, H, W)
        # unprojection through each view's own pixel-centre rays
        ys = ((torch.arange(H, device=images.device) + 0.5) * 2 / H - 1)
        xs = ((torch.arange(W, device=images.device) + 0.5) * 2 / W - 1)
        rx = xs[None, None, None, :] * cams["tan_fovx"][..., None, None]
        ry = ys[None, None, :, None] * cams["tan_fovy"][..., None, None]
        pc = torch.stack([rx * depth, ry * depth, depth], -1)
        pc = pc - cams["world_view"][:, :, None, None, 3, :3]
        xyz = torch.einsum("bshwj,bsij->bshwi", pc,
                           cams["world_view"][..., :3, :3])
        n = S * H * W
        raw = raw.permute(0, 1, 3, 4, 2).reshape(n, -1)
        c0 = [sum(GAUSS_SPLITS[:i]) for i in range(6)]
        rgb, scale, rot, opa, conf = [raw[:, c0[i]:c0[i + 1]]
                                      for i in range(5)]
        pixels = {"xyz": xyz.reshape(n, 3),
                  "opacity": 1.0 / (1.0 + torch.exp(-opa)),
                  "scaling": torch.exp(scale),
                  "rotation": rot / torch.sqrt((rot ** 2).sum(-1,
                                                             keepdim=True)),
                  "features_dc": rgb[:, None, :]}
        g, keys = merge(pixels, conf[:, 0], cfg.voxel)
        g = {k: v[None] for k, v in g.items()}
        g["features_rest"] = torch.zeros(1, keys.shape[0], 0, 3,
                                         device=images.device)
        g["voxels"] = keys[None]
        g["cameras"] = {"pose_enc": enc, **cams}
        pixels["keys"] = torch.floor(pixels["xyz"] / cfg.voxel).long()
        return g, {"patch_tokens": patches, "tokens": layers[cfg.depth - 1],
                   "depth": depth, "pixels": pixels}
