# Frozen copy of f3d_gaus_torch/models/longlrm_reference.py, the benchmark's
# plain reference of Long-LRM; it imports nothing of the program.
"""A plain PyTorch reference of Long-LRM (Chen, Tan, Zhang, Bi, Luan, Hong,
Li and Xu, "Long-LRM: Long-sequence Large Reconstruction Model for
Wide-coverage Gaussian Splats", arXiv:2410.12781), scene-level, in
float32.

It imports torch, numpy and math only: nothing of the port and no kernel,
so it stands beside the port as its yardstick, on the CPU at a small size
and on the card at the published shape (32 views at 960 × 540 padded to
544 rows, patch 8, width 1024, {7 Mamba2 + 1 transformer} × 3 with a 2 × 2
token merge after the first 7 Mamba2 blocks, 12 channels a pixel, the most
opaque quarter kept).  Everything is written out: the Mamba2 block's
causal conv as shifted sums, its chunked scan one head at a time (segment
sums within a chunk as direct masked cumulative sums, the states passed
from chunk to chunk one step at a time), softmax attention as scores,
max, exp, sum and weighted values a block of queries of one head at a
time, the LayerNorms and the gated RMSNorm.  `resolve_device` turns TF32
off for matmuls and cuDNN at every forward.

Departures from the paper, each an assumption of the benchmark's
configuration (benchmark/configs/longlrm_scene_540.json):
- Merge position: the 2 × 2 merge follows the first 7 Mamba2 blocks, so
  every transformer block sees the merged tokens.
- Mamba2: mamba_ssm's `Mamba2` defaults (d_state 128, d_conv 4, expand 2,
  head dim 64, 1 group, chunk 256, gated RMSNorm eps 1e-5 before the
  out-projection, no bias on the in- and out-projections, a bias on the
  conv, a D skip per head, dt = softplus(raw + dt_bias), A = -exp(A_log));
  one scan direction over the tokens in (view, row, column) order; its
  initialisation mamba_ssm's (dt log-uniform in [1e-3, 0.1] floored at
  1e-4 and stored as its inverse softplus, A_log = log U[1, 16], D = 1).
- Widths and the transformer block: GS-LRM's (pre-LN, 16 heads of 64, MLP
  4096, exact GELU, biases, no positional embedding).
- Merge: Swin's patch merging (concatenation, LayerNorm, a linear layer
  with no bias) with the width kept at 1024.
- Pruning: the top quarter by opacity, ties to the lower index, the kept
  set in index order.
- Weights: none were published; N(0, 0.02) with zero biases, the head's
  rows scaled and biased per channel group (colour (5, 0), scale (5e-4,
  log 0.01), rotation (1, 0), opacity (1e-3, -3), distance (1e-3, 0)).
  A uniform draw is taken from the benchmark's stream of normals through
  the normal CDF.
- Activations and positions: GS-LRM's, t = near + (far - near) sigmoid(w),
  xyz = o + t d, near, far = 3.0 -/+ sqrt(3).
- Padding: 4 rows below each 540-row frame (RGB -1, rays continuing the
  frame's pixel spacing); their Gaussians are dropped.
- Input RGB in [0, 1] is mapped to [-1, 1].
- Precision: float32 throughout (the paper runs mixed precision).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class LongLRMConfig(NamedTuple):
    views: int = 32
    frame_width: int = 960
    frame_height: int = 540
    patch: int = 8
    width: int = 1024
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
    near: float = 3.0 - math.sqrt(3.0)
    far: float = 3.0 + math.sqrt(3.0)


INIT_STD = 0.02
# the head's channel groups: colour, scale, rotation, opacity, distance
SPLITS = (3, 3, 4, 1, 1)
GROUP_SCALE = (5.0, 5e-4, 1.0, 1e-3, 1e-3)
GROUP_BIAS = (0.0, math.log(0.01), 0.0, -3.0, 0.0)
DT_MIN, DT_MAX, DT_FLOOR = 1e-3, 0.1, 1e-4

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


def _draw_normal(shape, generator):
    """Standard normals: from the benchmark's stream when the generator
    has `take`, else from torch.randn."""
    if hasattr(generator, "take"):
        return generator.take(tuple(shape))
    return torch.randn(tuple(shape), generator=generator)


def _normal(shape, std, generator):
    return torch.nn.Parameter(_draw_normal(shape, generator) * std)


def _uniform(shape, generator):
    """U[0, 1) draws: a stream's normals through the normal CDF, else
    torch.rand."""
    if hasattr(generator, "take"):
        z = generator.take(tuple(shape))
        return 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))
    return torch.rand(tuple(shape), generator=generator)


class Linear(torch.nn.Module):
    def __init__(self, cin, cout, std, generator, bias=True):
        super().__init__()
        self.weight = _normal((cout, cin), std, generator)
        self.bias = torch.nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        y = x @ self.weight.t()
        return y if self.bias is None else y + self.bias


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


def silu(x):
    return x * torch.sigmoid(x)


def softplus(x):
    """log(1 + e^x), x itself above 20 (torch's threshold)."""
    return torch.where(x > 20.0, x, torch.log1p(torch.exp(x.clamp_max(20.0))))


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
    """GS-LRM's pre-LN transformer block."""

    def __init__(self, cfg, generator):
        super().__init__()
        self.norm1 = LayerNorm(cfg.width)
        self.attn = Attention(cfg, generator)
        self.norm2 = LayerNorm(cfg.width)
        self.mlp = MLP(cfg, generator)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


def segsum(a):
    """(..., T) -> (..., T, T): out[i, j] = a[j+1] + ... + a[i] for j <= i,
    -inf above the diagonal, as masked cumulative sums."""
    T = a.shape[-1]
    x = a[..., None].repeat(*([1] * a.dim()), T)
    strict = torch.tril(torch.ones(T, T, dtype=torch.bool, device=a.device),
                        diagonal=-1)
    x = x.masked_fill(~strict, 0.0).cumsum(dim=-2)
    keep = torch.tril(torch.ones(T, T, dtype=torch.bool, device=a.device))
    return x.masked_fill(~keep, float("-inf"))


def ssd_scan(x, dt, A, B, C, D, chunk):
    """h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t + D x_t,
    chunked, one head at a time.  x (b, L, h, p), dt (b, L, h), A (h,),
    B, C (b, L, g, n), D (h,).  Returns y (b, L, h, p)."""
    b, L, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    c = -(-L // chunk)
    pad = c * chunk - L

    def chunked(t):
        t = torch.cat([t, t.new_zeros((b, pad) + t.shape[2:])], 1)
        return t.reshape((b, c, chunk) + t.shape[2:])
    xc, dtc, Bc, Cc = chunked(x), chunked(dt), chunked(B), chunked(C)
    per_group = h // g
    y = torch.empty(b, c, chunk, h, p, dtype=x.dtype, device=x.device)
    states = torch.empty(b, c, h, p, n, dtype=x.dtype, device=x.device)
    totals = torch.empty(b, c, h, dtype=x.dtype, device=x.device)
    for j in range(h):
        Bj, Cj = Bc[:, :, :, j // per_group], Cc[:, :, :, j // per_group]
        a = dtc[..., j] * A[j]                              # (b, c, Q)
        xdt = xc[:, :, :, j] * dtc[..., j, None]            # (b, c, Q, p)
        scores = (Cj @ Bj.transpose(-1, -2)) * torch.exp(segsum(a))
        y[:, :, :, j] = scores @ xdt
        acum = a.cumsum(-1)
        tail = torch.exp(acum[..., -1:] - acum)              # (b, c, Q)
        states[:, :, j] = (xdt * tail[..., None]).transpose(-1, -2) @ Bj
        totals[:, :, j] = acum[..., -1]
    # the state entering each chunk, passed one chunk at a time
    enter = torch.empty_like(states)
    s = states.new_zeros(b, h, p, n)
    for k in range(c):
        enter[:, k] = s
        s = torch.exp(totals[:, k])[..., None, None] * s + states[:, k]
    for j in range(h):
        Cj = Cc[:, :, :, j // per_group]
        acum = (dtc[..., j] * A[j]).cumsum(-1)
        y[:, :, :, j] += (Cj @ enter[:, :, j].transpose(-1, -2)) \
            * torch.exp(acum)[..., None]
    y = y.reshape(b, c * chunk, h, p)[:, :L]
    return y + x * D[:, None]


class Conv1d(torch.nn.Module):
    """Depthwise causal convolution as shifted sums: out_t = bias +
    sum_k weight[:, 0, k] x_{t-K+1+k}."""

    def __init__(self, channels, kernel, generator):
        super().__init__()
        self.weight = _normal((channels, 1, kernel), INIT_STD, generator)
        self.bias = torch.nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        b, L, ch = x.shape
        K = self.weight.shape[-1]
        xp = torch.cat([x.new_zeros(b, K - 1, ch), x], 1)
        out = self.bias.expand(b, L, ch).clone()
        for k in range(K):
            out = out + xp[:, k:k + L] * self.weight[:, 0, k]
        return out


class GatedRMSNorm(torch.nn.Module):
    def __init__(self, d, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = torch.nn.Parameter(torch.ones(d))

    def forward(self, y, z):
        y = y * silu(z)
        return y / torch.sqrt((y * y).mean(-1, keepdim=True) + self.eps) \
            * self.weight


class Mamba2(torch.nn.Module):
    """mamba_ssm's Mamba2 mixer at its defaults."""

    def __init__(self, cfg, generator):
        super().__init__()
        d = cfg.width
        self.inner = cfg.expand * d
        self.heads = self.inner // cfg.head_dim
        self.cfg = cfg
        gn = cfg.ngroups * cfg.d_state
        self.in_proj = Linear(d, 2 * self.inner + 2 * gn + self.heads,
                              INIT_STD, generator, bias=False)
        self.conv1d = Conv1d(self.inner + 2 * gn, cfg.d_conv, generator)
        u = _uniform((self.heads,), generator)
        dt = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN))
                       + math.log(DT_MIN)).clamp_min(DT_FLOOR)
        self.dt_bias = torch.nn.Parameter(dt + torch.log(-torch.expm1(-dt)))
        u = _uniform((self.heads,), generator)
        self.A_log = torch.nn.Parameter(torch.log(1.0 + 15.0 * u))
        self.D = torch.nn.Parameter(torch.ones(self.heads))
        self.norm = GatedRMSNorm(self.inner)
        self.out_proj = Linear(self.inner, d, INIT_STD, generator, bias=False)

    def forward(self, u):
        cfg = self.cfg
        b, L, _ = u.shape
        gn = cfg.ngroups * cfg.d_state
        zxbcdt = self.in_proj(u)
        z = zxbcdt[..., :self.inner]
        xbc = silu(self.conv1d(
            zxbcdt[..., self.inner:2 * self.inner + 2 * gn]))
        raw_dt = zxbcdt[..., 2 * self.inner + 2 * gn:]
        x = xbc[..., :self.inner].reshape(b, L, self.heads, cfg.head_dim)
        Bm = xbc[..., self.inner:self.inner + gn].reshape(
            b, L, cfg.ngroups, cfg.d_state)
        Cm = xbc[..., self.inner + gn:].reshape(b, L, cfg.ngroups, cfg.d_state)
        y = ssd_scan(x, softplus(raw_dt + self.dt_bias),
                     -torch.exp(self.A_log), Bm, Cm, self.D, cfg.chunk)
        return self.out_proj(self.norm(y.reshape(b, L, self.inner), z))


class MambaBlock(torch.nn.Module):
    def __init__(self, cfg, generator):
        super().__init__()
        self.norm = LayerNorm(cfg.width)
        self.mixer = Mamba2(cfg, generator)

    def forward(self, x):
        return x + self.mixer(self.norm(x))


class PatchMerge(torch.nn.Module):
    """Swin's patch merging per view: x0 (even row, even column), x1 (odd
    row, even column), x2 (even row, odd column), x3 (odd, odd)
    concatenated, LayerNorm, a linear layer with no bias."""

    def __init__(self, cfg, generator):
        super().__init__()
        wide = cfg.merge * cfg.merge * cfg.width
        self.m = cfg.merge
        self.norm = LayerNorm(wide)
        self.reduction = Linear(wide, cfg.width, INIT_STD, generator,
                                bias=False)

    def forward(self, x, views, rows, cols):
        B, _, C = x.shape
        m = self.m
        grid = x.reshape(B, views, rows, cols, C)
        parts = [grid[:, :, dr::m, dc::m]
                 for dc in range(m) for dr in range(m)]
        x = torch.cat(parts, -1).reshape(B, -1, m * m * C)
        return self.reduction(self.norm(x))


def pixel_rays(world_view, tan_fovx, tan_fovy, height, width, rows):
    """Camera centres (..., 3) and unit world directions through the pixel
    centres (..., rows, W, 3): pixel (i, j) at ((2j + 1) / W - 1) tan_fovx,
    ((2i + 1) / H - 1) tan_fovy, +z forward; rows past H continue the
    spacing."""
    rot = world_view[..., :3, :3]
    trans = world_view[..., 3, :3]
    o = -torch.einsum("...j,...ij->...i", trans, rot)
    dt, dev = world_view.dtype, world_view.device
    ys = ((torch.arange(rows, dtype=dt, device=dev) * 2 + 1) / height - 1)
    xs = ((torch.arange(width, dtype=dt, device=dev) * 2 + 1) / width - 1)
    d_cam = torch.stack([xs[None, :].expand(rows, width) * tan_fovx,
                         ys[:, None].expand(rows, width) * tan_fovy,
                         torch.ones(rows, width, dtype=dt, device=dev)], -1)
    d = torch.einsum("hwj,...ij->...hwi", d_cam, rot)
    return o, d / d.norm(dim=-1, keepdim=True)


def prune(opacity, k):
    """Indices of each row's k largest opacities, ties to the lower index,
    ascending (numpy's stable sort on the host)."""
    rows = []
    for row in opacity.detach().cpu().numpy():
        order = np.argsort(-row, kind="stable")[:k]
        rows.append(np.sort(order))
    return torch.as_tensor(np.stack(rows), device=opacity.device)


class LongLRM(torch.nn.Module):
    def __init__(self, cfg: LongLRMConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        p = cfg.patch
        self.tokenizer = Linear(p * p * 9, cfg.width, INIT_STD, generator)
        self.blocks = torch.nn.ModuleList([
            MambaBlock(cfg, generator) if kind == "M"
            else Block(cfg, generator)
            for kind in cfg.layout if kind != "+"])
        self.merge = PatchMerge(cfg, generator)
        self.norm = LayerNorm(cfg.width)
        hp = p * cfg.merge
        self.head = Linear(cfg.width, hp * hp * cfg.gaussian_channels,
                           INIT_STD, generator)
        with torch.no_grad():
            scale = torch.tensor([s for n, s in zip(SPLITS, GROUP_SCALE)
                                  for _ in range(n)] * (hp * hp))
            bias = torch.tensor([b for n, b in zip(SPLITS, GROUP_BIAS)
                                 for _ in range(n)] * (hp * hp))
            self.head.weight.mul_(scale[:, None].to(self.head.weight.device))
            self.head.bias.copy_(bias)

    def forward(self, images, world_views, tan_fovx, tan_fovy):
        """images (B, V, H, W, 3) in [0, 1], world_views (B, V, 4, 4).
        Returns (the kept Gaussians' dict with `kept`, as the port's
        LongLRM returns it; {"premerge": the tokens entering the merge,
        "tokens": the final LayerNorm's, "fields": every pixel's Gaussian
        fields before pruning})."""
        resolve_device(like=images)
        cfg = self.cfg
        B, V, H, W, _ = images.shape
        p, step = cfg.patch, cfg.patch * cfg.merge
        Hp = -(-H // step) * step
        o, d = pixel_rays(world_views, tan_fovx, tan_fovy, H, W, Hp)
        o_px = o[:, :, None, None, :].expand_as(d)
        rgb = torch.cat([images * 2.0 - 1.0,
                         images.new_full((B, V, Hp - H, W, 3), -1.0)], 2)
        x = torch.cat([rgb, torch.cross(o_px, d, dim=-1), d], -1)
        rows, cols = Hp // p, W // p
        # patches: (row, column, channel) within each patch
        x = x.reshape(B, V, rows, p, cols, p, 9).permute(0, 1, 2, 4, 3, 5, 6)
        x = self.tokenizer(x.reshape(B, V * rows * cols, p * p * 9))
        blocks = iter(self.blocks)
        for kind in cfg.layout:
            if kind == "+":
                premerge = x
                x = self.merge(x, V, rows, cols)
                rows, cols = rows // cfg.merge, cols // cfg.merge
            else:
                x = next(blocks)(x)
        tokens = self.norm(x)
        hp = step
        out = self.head(tokens).reshape(B, V, rows, cols, hp, hp, -1)
        out = out.permute(0, 1, 2, 4, 3, 5, 6).reshape(B, V, Hp, W, -1)
        n = V * H * W
        out = out[:, :, :H].reshape(B, n, -1)
        rgb, scale, rot, opa, dist = out.split(SPLITS, -1)
        t = cfg.near + (cfg.far - cfg.near) * torch.sigmoid(dist)
        xyz = (o_px[:, :, :H].reshape(B, n, 3)
               + t * d[:, :, :H].reshape(B, n, 3))
        fields = {"xyz": xyz, "opacity": torch.sigmoid(opa),
                  "scaling": torch.exp(scale),
                  "rotation": rot / rot.norm(dim=-1, keepdim=True),
                  "features_dc": rgb[:, :, None, :]}
        kept = prune(fields["opacity"][..., 0], int(n * cfg.keep))
        g = {k: torch.stack([v[b, kept[b]] for b in range(B)])
             for k, v in fields.items()}
        g["features_rest"] = rgb.new_zeros((B, kept.shape[1], 0, 3))
        g["kept"] = kept
        return g, {"premerge": premerge, "tokens": tokens, "fields": fields}
