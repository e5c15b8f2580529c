"""Image-quality evaluation: PSNR / SSIM and weight-gated LPIPS over
render directories (counterpart of f3d_gaus_tpu/eval.py and of the
vendored metrics runner, reference src/gaussian-splatting/metrics.py:
36-97): walks paired renders/gt directories, reports per-image and mean
metrics, dumps JSON.

LPIPS runs through the VGG16 tower (models/vgg.py) from a torchvision
vgg16 state_dict the user supplies (`lpips_weights`); the pretrained file
is not bundled, so `lpips=True` without it raises NotImplementedError.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from .core.device import resolve_device
from .train import losses

LPIPS_MISSING = (
    "LPIPS needs the VGG16 tower's weights, which were not given: pass "
    "lpips_weights=<torchvision vgg16 .pt> (and optionally "
    "lpips_lin_weights) or rerun with lpips=False")


def _load_image(path: str) -> np.ndarray:
    from PIL import Image
    img = Image.open(path).convert("RGB")
    return np.asarray(img, np.float32) / 255.0


def evaluate_pair(render: np.ndarray, gt: np.ndarray, towers=None,
                  device=None) -> dict:
    """render/gt: (H, W, 3) float in [0, 1].  towers: optional (VGG16,
    lin-or-None) activating LPIPS (uniform 1/C heads without lin).
    Computed on `device` (default `cuda`)."""
    dev = resolve_device(device)
    r = torch.from_numpy(np.ascontiguousarray(render.transpose(2, 0, 1))
                         ).to(dev)[None]
    g = torch.from_numpy(np.ascontiguousarray(gt.transpose(2, 0, 1))
                         ).to(dev)[None]
    out = {"psnr": float(losses.psnr(r, g)[0]),
           "ssim": float(losses.ssim(r, g))}
    if towers is not None:
        from .models import vgg
        with torch.no_grad():
            out["lpips"] = float(vgg.lpips(towers[0], towers[1],
                                           2.0 * r - 1.0, 2.0 * g - 1.0)[0])
    return out


def evaluate_dirs(renders_dir: str, gt_dir: str,
                  out_json: Optional[str] = None, lpips: bool = False,
                  lpips_weights: Optional[str] = None,
                  lpips_lin_weights: Optional[str] = None,
                  device=None) -> dict:
    """Per-image + mean PSNR/SSIM over two directories matched by filename
    (the metrics.py contract).  Returns the result dict.

    lpips=True additionally reports LPIPS and requires `lpips_weights` (a
    torchvision vgg16 state_dict .pt; optionally `lpips_lin_weights` for
    the learned linear heads)."""
    if lpips and not lpips_weights:
        raise NotImplementedError(LPIPS_MISSING)
    dev = resolve_device(device)
    towers = None
    if lpips:
        from .models import vgg
        towers = vgg.load_towers(lpips_weights, lpips_lin_weights, device=dev)
    names = sorted(n for n in os.listdir(renders_dir)
                   if n.lower().endswith((".png", ".jpg", ".jpeg")))
    per_image = {}
    for n in names:
        gt_path = os.path.join(gt_dir, n)
        if not os.path.exists(gt_path):
            continue
        per_image[n] = evaluate_pair(_load_image(os.path.join(renders_dir, n)),
                                     _load_image(gt_path), towers, dev)
    if not per_image:
        raise FileNotFoundError(f"no matched images in {renders_dir} / {gt_dir}")
    keys = ("psnr", "ssim", "lpips") if towers is not None else ("psnr", "ssim")
    result = {
        "mean": {k: float(np.mean([v[k] for v in per_image.values()]))
                 for k in keys},
        "per_image": per_image,
    }
    if out_json:
        with open(out_json, "w") as f:
            json.dump(result, f, indent=2)
    return result
