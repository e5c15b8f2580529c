"""VGG16 feature tower: the perceptual and LPIPS losses (counterpart of
f3d_gaus_tpu/models/vgg.py).

The reference's training config activates `w_perceptual: 2` and its eval
stack ships an LPIPS criterion built on torchvision's VGG16 features
(reference src/gaussian-splatting/lpipsPyTorch/modules/networks.py:89-103,
lpips.py:33-38):

  * `VGG16` — the 13-conv trunk as an nn.Module whose `features` is an
    nn.Sequential with torchvision's layer indices, so a torchvision
    `vgg16` state_dict loads under its own keys; its forward (and
    `features()`) returns the five post-ReLU taps relu1_2, relu2_2,
    relu3_3, relu4_3 and relu5_3.
  * `lpips()` — z-score by the LPIPS (mean, std) buffers, unit-normalise
    each tap across channels, squared difference, 1x1 linear heads,
    spatial mean, sum over taps (lpips.py:33-38).
  * `perceptual_loss()` — the multi-tap feature L1 of the JAX package.

Weights are not bundled: `load_towers` reads a torchvision vgg16 state_dict
(full or features only; `classifier.*` keys are ignored) and optionally the
LPIPS linear heads from files the user supplies.  The convolutions are
cuDNN's (TF32 off, core/device.py), as the JAX package leaves them to XLA.

Not ported, by design: the JAX module's functional `init_params`;
`VGG16(generator)` draws the same He init from a torch.Generator.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..core.device import abs_tie, resolve_device
from ..utils import profiling

# channels of the 13 convs, blocks separated by 2x2 maxpools
VGG16_PLAN = ((64, 64), (128, 128), (256, 256, 256),
              (512, 512, 512), (512, 512, 512))
# torchvision features indices of the 13 convs
_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
# features indices of the ReLUs whose outputs are the five taps
_TAP_IDX = (3, 8, 15, 22, 29)
# LPIPS tap channel widths (networks.py:103)
N_CHANNELS = (64, 128, 256, 512, 512)
# z-score buffers for inputs in [-1, 1] (networks.py:41-44)
_LPIPS_MEAN = (-0.030, -0.088, -0.188)
_LPIPS_STD = (0.458, 0.448, 0.450)


class VGG16(nn.Module):
    """torchvision's vgg16().features (31 layers, the last maxpool
    included so the indices match), He-initialised from `generator`."""

    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        layers, cin = [], 3
        for block in VGG16_PLAN:
            for cout in block:
                conv = nn.Conv2d(cin, cout, 3, padding=1)
                with torch.no_grad():
                    conv.weight.copy_(torch.randn(
                        conv.weight.shape, generator=generator)
                        * math.sqrt(2.0 / (9 * cin)))
                    conv.bias.zero_()
                layers += [conv, nn.ReLU()]
                cin = cout
            layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)
        self.register_buffer("lpips_mean", torch.tensor(_LPIPS_MEAN)
                             .reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("lpips_std", torch.tensor(_LPIPS_STD)
                             .reshape(1, 3, 1, 1), persistent=False)

    @profiling.spanned("vgg")
    def forward(self, x):
        """x: (N, 3, H, W) -> the five taps (span `vgg`, utils.profiling)."""
        taps = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in _TAP_IDX:
                taps.append(x)
                if len(taps) == len(_TAP_IDX):
                    break
        return taps


def features(vgg: VGG16, x):
    """x: (N, 3, H, W).  Returns the 5 post-ReLU taps (torchvision
    features 1-indexed 4/9/16/23/30)."""
    return vgg(x)


def _z_score(vgg: VGG16, x):
    return (x - vgg.lpips_mean) / vgg.lpips_std


def _unit_normalize(x, eps=1e-10):
    """normalize_activation (lpipsPyTorch/modules/utils.py): unit L2 norm
    over the channel axis per pixel."""
    return x / (torch.sqrt(torch.sum(x * x, 1, keepdim=True)) + eps)


def uniform_heads(device=None):
    """The five uniform 1/C heads that stand for the learned LPIPS heads
    when none are given (the "LPIPS-vgg (unweighted)" variant)."""
    return [torch.full((c,), 1.0 / c, device=device) for c in N_CHANNELS]


def lpips(vgg: VGG16, lin, x, y):
    """LPIPS(x, y) for images in [-1, 1], (N, 3, H, W) -> (N,).  lin: five
    (C,) nonnegative weight vectors (the 1x1 conv heads, lpips.py:36), or
    None for uniform_heads."""
    if lin is None:
        lin = uniform_heads(x.device)
    fx = vgg(_z_score(vgg, x))
    fy = vgg(_z_score(vgg, y))
    total = 0.0
    for tx, ty, lw in zip(fx, fy, lin):
        d = (_unit_normalize(tx) - _unit_normalize(ty)) ** 2
        total = total + torch.einsum("nchw,c->n", d, lw) / (
            d.shape[2] * d.shape[3])
    return total


def perceptual_loss(vgg: VGG16, x, y):
    """Multi-tap VGG feature L1 for images in [0, 1], (N, 3, H, W) -> ().
    Inputs are mapped to [-1, 1] and z-scored like the LPIPS tower so one
    weight file serves both objectives."""
    fx = vgg(_z_score(vgg, 2.0 * x - 1.0))
    fy = vgg(_z_score(vgg, 2.0 * y - 1.0))
    return sum(torch.mean(abs_tie(a - b)) for a, b in zip(fx, fy)) / len(fx)


# ---------------------------------------------------------------------------
# torch checkpoint loading
# ---------------------------------------------------------------------------

def convert_torch_vgg16(state_dict) -> dict:
    """torchvision vgg16 state_dict (features.N.weight (O, I, 3, 3), with
    or without a 'features.' / 'net.layers.' prefix; classifier.* ignored)
    -> a VGG16 state_dict."""
    stripped = {}
    for k, v in state_dict.items():
        for prefix in ("module.", "net.layers.", "features."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        stripped[k] = v
    sd = {}
    for idx in _CONV_IDX:
        for leaf in ("weight", "bias"):
            if f"{idx}.{leaf}" not in stripped:
                raise KeyError(f"{idx}.{leaf}")
            sd[f"features.{idx}.{leaf}"] = torch.as_tensor(
                stripped[f"{idx}.{leaf}"], dtype=torch.float32)
    return sd


def convert_torch_lpips_lin(state_dict) -> list:
    """LPIPS linear-head state_dict (lin.N.1.weight (1, C, 1, 1) or the
    upstream '...lin{N}.model.1.weight' naming) -> five (C,) tensors."""
    out = []
    for i in range(5):
        hit = None
        for k, v in state_dict.items():
            if f"lin.{i}.1.weight" in k or f"lin{i}.model.1.weight" in k:
                hit = torch.as_tensor(v, dtype=torch.float32).reshape(-1)
                break
        if hit is None:
            raise KeyError(f"no linear head {i} in state_dict")
        out.append(hit)
    return out


def _load_sd(path):
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.state_dict() if hasattr(sd, "state_dict") else sd


def load_towers(vgg_path, lpips_path=None, device=None):
    """(VGG16, lin-or-None) from torch .pt/.pth files on `device` (default
    `cuda`), frozen (requires_grad False) and in eval mode.  vgg_path: a
    torchvision vgg16 (full or features-only) state_dict; lpips_path: an
    optional LPIPS linear-head state_dict."""
    dev = resolve_device(device)
    vgg = VGG16(torch.Generator())     # every weight is then loaded
    vgg.load_state_dict(convert_torch_vgg16(_load_sd(vgg_path)))
    vgg = vgg.to(dev).eval().requires_grad_(False)
    lin = None
    if lpips_path is not None:
        lin = [w.to(dev) for w in convert_torch_lpips_lin(_load_sd(lpips_path))]
    return vgg, lin
