"""Weights carried into GaussianPredictor (counterpart of
f3d_gaus_tpu/models/convert.py).

  * `params_from_jax(tree)`: the JAX package's predictor parameter tree
    ({"encoder": {name: ...}, "out": {...}}, HWIO convolutions, numpy
    leaves) -> a GaussianPredictor state_dict (OIHW).  The inverse of the
    JAX converter's layout change.
  * `load_torch_state_dict(path)` / `convert_checkpoint(path)`: the
    reference's pretrained .pt (GaussianSplatPredictor_gtunet weights under
    'gaussian_predictor.network_with_offset.', possibly with a DDP 'module.'
    prefix) -> a GaussianPredictor state_dict.
"""
from __future__ import annotations

import numpy as np
import torch

_REF_PREFIX = "gaussian_predictor.network_with_offset."


def _leaf(name, value):
    a = np.asarray(value, np.float32)
    if a.ndim == 4:                       # conv HWIO -> OIHW
        a = np.transpose(a, (3, 2, 0, 1))
    return name, torch.from_numpy(np.array(a, copy=True))


def params_from_jax(tree) -> dict:
    """JAX predictor params -> GaussianPredictor state_dict."""
    sd = {}
    for name, p in tree["encoder"].items():
        for key, v in p.items():
            if isinstance(v, dict):       # a UNetBlock's sub-layer
                for leaf, w in v.items():
                    k, t = _leaf(f"encoder.{name}.{key}.{leaf}", w)
                    sd[k] = t
            else:                         # a plain conv or norm
                k, t = _leaf(f"encoder.{name}.{key}", v)
                sd[k] = t
    for leaf, w in tree["out"].items():
        k, t = _leaf(f"out.{leaf}", w)
        sd[k] = t
    return sd


def load_torch_state_dict(path):
    """A torch checkpoint's flat state_dict with any DDP 'module.' prefix
    stripped (visualize.py:204-210)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def convert_checkpoint(path) -> dict:
    """Path to the reference .pt -> GaussianPredictor state_dict."""
    sd = load_torch_state_dict(path)
    return {k[len(_REF_PREFIX):]: v.float() for k, v in sd.items()
            if k.startswith(_REF_PREFIX)}
