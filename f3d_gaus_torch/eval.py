"""Image-quality evaluation: PSNR / SSIM over render directories
(counterpart of f3d_gaus_tpu/eval.py and of the vendored metrics runner,
reference src/gaussian-splatting/metrics.py:36-97): walks paired
renders/gt directories, reports per-image and mean metrics, dumps JSON.

LPIPS needs the VGG16 tower (f3d_gaus_tpu/models/vgg.py), which is not
ported to this package yet, so `lpips=True` raises NotImplementedError.
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
    "LPIPS needs the VGG16 tower, which is not ported to f3d_gaus_torch yet "
    "(f3d_gaus_tpu/models/vgg.py); rerun with lpips=False")


def _load_image(path: str) -> np.ndarray:
    from PIL import Image
    img = Image.open(path).convert("RGB")
    return np.asarray(img, np.float32) / 255.0


def evaluate_pair(render: np.ndarray, gt: np.ndarray, device=None) -> dict:
    """render/gt: (H, W, 3) float in [0, 1].  Computed on `device`
    (default `cuda`)."""
    dev = resolve_device(device)
    r = torch.from_numpy(np.ascontiguousarray(render.transpose(2, 0, 1))
                         ).to(dev)[None]
    g = torch.from_numpy(np.ascontiguousarray(gt.transpose(2, 0, 1))
                         ).to(dev)[None]
    return {"psnr": float(losses.psnr(r, g)[0]),
            "ssim": float(losses.ssim(r, g))}


def evaluate_dirs(renders_dir: str, gt_dir: str,
                  out_json: Optional[str] = None, lpips: bool = False,
                  lpips_weights: Optional[str] = None,
                  lpips_lin_weights: Optional[str] = None,
                  device=None) -> dict:
    """Per-image + mean PSNR/SSIM over two directories matched by filename
    (the metrics.py contract).  Returns the result dict.  lpips=True
    raises NotImplementedError: the VGG16 tower LPIPS runs through is not
    ported yet (lpips_weights / lpips_lin_weights keep the JAX package's
    signature)."""
    if lpips:
        raise NotImplementedError(LPIPS_MISSING)
    dev = resolve_device(device)
    names = sorted(n for n in os.listdir(renders_dir)
                   if n.lower().endswith((".png", ".jpg", ".jpeg")))
    per_image = {}
    for n in names:
        gt_path = os.path.join(gt_dir, n)
        if not os.path.exists(gt_path):
            continue
        per_image[n] = evaluate_pair(_load_image(os.path.join(renders_dir, n)),
                                     _load_image(gt_path), dev)
    if not per_image:
        raise FileNotFoundError(f"no matched images in {renders_dir} / {gt_dir}")
    result = {
        "mean": {k: float(np.mean([v[k] for v in per_image.values()]))
                 for k in ("psnr", "ssim")},
        "per_image": per_image,
    }
    if out_json:
        with open(out_json, "w") as f:
            json.dump(result, f, indent=2)
    return result
