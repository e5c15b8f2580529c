"""Weights carried into GaussianPredictor (counterpart of
f3d_gaus_tpu/models/convert.py).

  * `params_from_jax(tree)`: the JAX package's predictor parameter tree
    ({"encoder": {name: ...}, "out": {...}}, HWIO convolutions, numpy
    leaves) -> a GaussianPredictor state_dict (OIHW).  The inverse of the
    JAX converter's layout change.
  * `vgg_from_jax(params)`, `lpips_lin_from_jax(lin)`, `clip_from_jax(
    tree)`: the JAX package's VGG16 parameter list, LPIPS heads and CLIP
    visual tree (numpy leaves) -> the port's models/vgg.py and
    models/clip.py state_dicts, so both packages can compute the same
    losses.
  * `load_torch_state_dict(path)`, `convert_predictor(sd, cfg)` and
    `convert_checkpoint(path, cfg)`: the reference's pretrained .pt
    (GaussianSplatPredictor_gtunet weights under
    'gaussian_predictor.network_with_offset.', possibly with a DDP 'module.'
    prefix) -> a GaussianPredictor(cfg) state_dict.  The JAX package's
    converters return its parameter tree (HWIO convolutions); these return
    the state_dict, whose layout is the reference's own (OIHW).  As there,
    every key the predictor needs must be present (KeyError otherwise) and
    other keys are left out.
"""
from __future__ import annotations

import numpy as np
import torch


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


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _hwio_to_oihw(a):
    return _t(np.transpose(np.asarray(a, np.float32), (3, 2, 0, 1)))


def vgg_from_jax(params) -> dict:
    """JAX models/vgg.py params (13 {"w": HWIO, "b"}) -> VGG16 state_dict."""
    from .vgg import _CONV_IDX
    sd = {}
    for idx, p in zip(_CONV_IDX, params, strict=True):
        sd[f"features.{idx}.weight"] = _hwio_to_oihw(p["w"])
        sd[f"features.{idx}.bias"] = _t(p["b"])
    return sd


def lpips_lin_from_jax(lin) -> list:
    """JAX LPIPS heads (five (C,) arrays) -> five (C,) tensors."""
    return [_t(w).reshape(-1) for w in lin]


def clip_from_jax(tree) -> dict:
    """JAX models/clip.py visual tree -> CLIPVisual state_dict (OpenAI's
    `visual.*` names without the prefix; the patch conv HWIO -> OIHW)."""
    def ln(name, p):
        return {f"{name}.weight": _t(p["g"]), f"{name}.bias": _t(p["b"])}
    sd = {"conv1.weight": _hwio_to_oihw(tree["conv1_w"]),
          "class_embedding": _t(tree["class_embedding"]),
          "positional_embedding": _t(tree["positional_embedding"]),
          "proj": _t(tree["proj"]),
          **ln("ln_pre", tree["ln_pre"]), **ln("ln_post", tree["ln_post"])}
    for i, b in enumerate(tree["blocks"]):
        pfx = f"transformer.resblocks.{i}"
        sd.update(ln(f"{pfx}.ln_1", b["ln_1"]))
        sd.update(ln(f"{pfx}.ln_2", b["ln_2"]))
        sd[f"{pfx}.attn.in_proj_weight"] = _t(b["attn"]["in_w"])
        sd[f"{pfx}.attn.in_proj_bias"] = _t(b["attn"]["in_b"])
        sd[f"{pfx}.attn.out_proj.weight"] = _t(b["attn"]["out_w"])
        sd[f"{pfx}.attn.out_proj.bias"] = _t(b["attn"]["out_b"])
        sd[f"{pfx}.mlp.c_fc.weight"] = _t(b["mlp_fc_w"])
        sd[f"{pfx}.mlp.c_fc.bias"] = _t(b["mlp_fc_b"])
        sd[f"{pfx}.mlp.c_proj.weight"] = _t(b["mlp_proj_w"])
        sd[f"{pfx}.mlp.c_proj.bias"] = _t(b["mlp_proj_b"])
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


def convert_predictor(sd, cfg, net_name="network_with_offset") -> dict:
    """The reference's flat state_dict -> a GaussianPredictor(cfg)
    state_dict (cfg: a PredictorConfig): exactly the keys the predictor
    has, read under 'gaussian_predictor.{net_name}.'.  A missing key raises
    KeyError, as the JAX converter's plan walk does; other keys are left
    out."""
    from .predictor import GaussianPredictor
    with torch.device("meta"):                 # the key set, no weights
        keys = GaussianPredictor(cfg).state_dict().keys()
    base = f"gaussian_predictor.{net_name}."
    return {k: torch.as_tensor(sd[base + k]).detach().float() for k in keys}


def convert_checkpoint(path, cfg) -> dict:
    """Path to the reference .pt -> GaussianPredictor(cfg) state_dict (the
    JAX package's returns its parameter tree)."""
    return convert_predictor(load_torch_state_dict(path), cfg)
