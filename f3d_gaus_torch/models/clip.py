"""CLIP image encoder (ViT-B/32) for the w_clip loss (counterpart of
f3d_gaus_tpu/models/clip.py).

The shipped training config weights a CLIP-embedding similarity term
(`w_clip: 0.35`, reference config/imagenetgs_256x256_v1.yaml:57); the
reference's training script is not public, so, as in the JAX package, the
objective is 1 - cosine(CLIP(render), CLIP(target)) with the OpenAI
ViT-B/32 visual tower.

Architecture (OpenAI CLIP model.py, public): a 32x32 patch conv without
bias, class token and positional embedding, pre-LN, 12 pre-norm
transformer blocks (width 768, 12 heads, QuickGELU MLP x4), post-LN on the
class token, projection to the 512-dim embedding.  The modules' parameter
names are OpenAI's `visual.*` keys without the prefix, so `load_tower`
reads an OpenAI state_dict as it is.  Weights are not bundled: the user
supplies the file.  The matmuls are cuBLAS's in full f32 (TF32 off,
core/device.py), as the JAX package leaves them to XLA.

Not ported, by design: the JAX module's functional `init_params`
(`CLIPVisual(grid, generator)` takes its place) and
`convert_torch_clip_visual`: `load_tower` replaces it, and takes only the
`visual.*` keys, where the JAX function strips `visual.` from the text
tower's keys too.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from ..utils import profiling

WIDTH = 768
HEADS = 12
LAYERS = 12
PATCH = 32
EMBED = 512

_MEAN = (0.48145466, 0.4578275, 0.40821073)
_STD = (0.26862954, 0.26130258, 0.27577711)


def _normal(shape, generator, s=0.02):
    return nn.Parameter(torch.randn(shape, generator=generator) * s)


def _linear(fan_out, fan_in, generator):
    lin = nn.Linear(fan_in, fan_out)
    with torch.no_grad():
        lin.weight.copy_(torch.randn((fan_out, fan_in), generator=generator)
                         * 0.02)
        lin.bias.zero_()
    return lin


class _Attention(nn.Module):
    """Self-attention with torch MultiheadAttention's packed (q|k|v)
    in_proj rows and out_proj, written out as a plain matmul and softmax
    (the JAX package's _mha)."""

    def __init__(self, generator):
        super().__init__()
        self.in_proj_weight = _normal((3 * WIDTH, WIDTH), generator)
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * WIDTH))
        self.out_proj = _linear(WIDTH, WIDTH, generator)

    def forward(self, x):
        N, L, W = x.shape
        hd = W // HEADS
        qkv = x @ self.in_proj_weight.T + self.in_proj_bias
        q, k, v = (t.reshape(N, L, HEADS, hd).transpose(1, 2)
                   for t in qkv.chunk(3, -1))
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), -1)
        o = (att @ v).transpose(1, 2).reshape(N, L, W)
        return self.out_proj(o)


class _MLP(nn.Module):
    def __init__(self, generator):
        super().__init__()
        self.c_fc = _linear(4 * WIDTH, WIDTH, generator)
        self.c_proj = _linear(WIDTH, 4 * WIDTH, generator)

    def forward(self, x):
        h = self.c_fc(x)
        # OpenAI CLIP's QuickGELU, x * sigmoid(1.702 x): converted OpenAI
        # weights assume this activation, not the exact GELU
        return self.c_proj(h * torch.sigmoid(1.702 * h))


class _Block(nn.Module):
    def __init__(self, generator):
        super().__init__()
        self.ln_1 = nn.LayerNorm(WIDTH)
        self.attn = _Attention(generator)
        self.ln_2 = nn.LayerNorm(WIDTH)
        self.mlp = _MLP(generator)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, generator):
        super().__init__()
        self.resblocks = nn.ModuleList(_Block(generator)
                                       for _ in range(LAYERS))


class CLIPVisual(nn.Module):
    """The ViT-B/32 visual tower for inputs of grid x grid patches (7 for
    the pretrained tower's 224), initialised from `generator` as the JAX
    package's init_params."""

    def __init__(self, grid: int = 7, generator: torch.Generator | None = None):
        super().__init__()
        self.conv1 = nn.Conv2d(3, WIDTH, PATCH, stride=PATCH, bias=False)
        with torch.no_grad():
            self.conv1.weight.copy_(torch.randn(
                self.conv1.weight.shape, generator=generator) * 0.02)
        self.class_embedding = _normal((WIDTH,), generator)
        self.positional_embedding = _normal((grid * grid + 1, WIDTH),
                                            generator)
        self.ln_pre = nn.LayerNorm(WIDTH)
        self.transformer = _Transformer(generator)
        self.ln_post = nn.LayerNorm(WIDTH)
        self.proj = _normal((WIDTH, EMBED), generator)
        self.register_buffer("mean", torch.tensor(_MEAN).reshape(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(_STD).reshape(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x):
        return encode_image(self, x)


@profiling.spanned("clip")
def encode_image(model: CLIPVisual, x):
    """x: (N, 3, H, W) in [0, 1], H = W = 32 x the tower's grid (224 for
    the pretrained tower).  Returns L2-normalised (N, 512) embeddings.
    Span `clip` (utils.profiling): clip_loss calls this, not forward."""
    x = (x - model.mean) / model.std
    h = model.conv1(x)                                   # (N, W, gh, gw)
    N, C = h.shape[:2]
    h = h.reshape(N, C, -1).transpose(1, 2)              # (N, L, W)
    cls = model.class_embedding.reshape(1, 1, C).expand(N, 1, C)
    h = torch.cat([cls, h], 1) + model.positional_embedding[None]
    h = model.ln_pre(h)
    for blk in model.transformer.resblocks:
        h = blk(h)
    e = model.ln_post(h[:, 0]) @ model.proj
    return e / torch.linalg.norm(e, dim=-1, keepdim=True)


def resize(x, size: int):
    """Bilinear resize of (N, C, H, W) to size x size with antialiasing on
    a shrink, as jax.image.resize(..., "bilinear") does."""
    if x.shape[-2:] == (size, size):
        return x
    return F.interpolate(x, size=(size, size), mode="bilinear",
                         align_corners=False, antialias=True)


def clip_loss(model: CLIPVisual, x, y, resize_to: int = 224):
    """1 - cosine similarity of CLIP embeddings, images (N, 3, H, W) in
    [0, 1] resized to the tower's native `resize_to`; a scalar."""
    ex = encode_image(model, resize(x, resize_to))
    ey = encode_image(model, resize(y, resize_to))
    return torch.mean(1.0 - torch.sum(ex * ey, -1))


def load_tower(path, device=None):
    """CLIPVisual from a torch .pt state_dict (the full OpenAI model's
    `visual.*` keys or one already stripped to the visual tower) on
    `device` (default `cuda`), frozen and in eval mode."""
    dev = resolve_device(device)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    # a full model's text tower has keys of the same names outside
    # `visual.` (positional_embedding, transformer.resblocks.*): take only
    # the visual ones when any is there
    if any(k.startswith("visual.") for k in sd):
        sd = {k[len("visual."):]: v for k, v in sd.items()
              if k.startswith("visual.")}
    vis = {k: torch.as_tensor(v).float() for k, v in sd.items()}
    grid = math.isqrt(vis["positional_embedding"].shape[0] - 1)
    model = CLIPVisual(grid, torch.Generator())   # every weight is loaded
    model.load_state_dict(vis)
    return model.to(dev).eval().requires_grad_(False)
