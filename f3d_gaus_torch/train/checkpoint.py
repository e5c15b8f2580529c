"""Checkpoint save/restore with torch.save / torch.load (counterpart of
f3d_gaus_tpu/train/checkpoint.py, which writes JAX pytrees with orbax).

A checkpoint is a directory holding `state.pt`.  Two kinds, as in the
JAX package:
  * the feed-forward train state (train.feedforward.TrainState): the
    predictor's state_dict, the optimizer's state_dict and the step;
  * a tree of tensors -- NamedTuples, tuples and lists of tensors and
    numbers, such as the per-scene trainer's (SceneParams, AdamState)
    with its step (the functional analog of torch.save((gaussians.
    capture(), iteration)), train.py:130-132) -- stored as nested dicts
    and lists and restored into the structure of a template.
"""
from __future__ import annotations

import os
import re

import torch

_FILE = "state.pt"


def _is_train_state(state) -> bool:
    return hasattr(state, "model") and hasattr(state, "optimizer")


def _plain(tree):
    """A tree of NamedTuples / tuples / lists as dicts and lists that
    torch.load(weights_only=True) reads back."""
    if hasattr(tree, "_fields"):
        return {k: _plain(v) for k, v in zip(tree._fields, tree)}
    if isinstance(tree, (tuple, list)):
        return [_plain(v) for v in tree]
    return tree


def _fill(template, loaded):
    """`loaded` (_plain's form) in the structure, devices and dtypes of
    `template`."""
    if hasattr(template, "_fields"):
        return type(template)(*[_fill(t, loaded[k]) for k, t in
                                zip(template._fields, template)])
    if isinstance(template, (tuple, list)):
        return type(template)(_fill(t, v) for t, v in zip(template, loaded))
    if torch.is_tensor(template):
        if tuple(loaded.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint tensor {tuple(loaded.shape)} does "
                             f"not match the template's "
                             f"{tuple(template.shape)}")
        return loaded.to(device=template.device, dtype=template.dtype)
    return loaded


def save(path: str, state) -> None:
    """Write a train.feedforward.TrainState, or a tree of tensors (e.g.
    the per-scene (SceneParams, AdamState)), into directory `path`."""
    os.makedirs(path, exist_ok=True)
    if _is_train_state(state):
        payload = {"model": state.model.state_dict(),
                   "optimizer": state.optimizer.state_dict(),
                   "step": int(state.step)}
    else:
        payload = {"tree": _plain(state)}
    torch.save(payload, os.path.join(path, _FILE))


def restore(path: str, state):
    """Load the checkpoint in directory `path`.  A TrainState template (of
    the same configuration) is loaded in place and returned; for a tree of
    tensors a new tree in the template's structure, on its devices, is
    returned (the JAX package's restore(path, template))."""
    if _is_train_state(state):
        device = next(state.model.parameters()).device
        ckpt = torch.load(os.path.join(path, _FILE), map_location=device,
                          weights_only=True)
        state.model.load_state_dict(ckpt["model"])
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = ckpt["step"]
        return state
    ckpt = torch.load(os.path.join(path, _FILE), map_location="cpu",
                      weights_only=True)
    return _fill(state, ckpt["tree"])


def latest_step_dir(root: str):
    """The newest `step_<N>` checkpoint directory under `root`, or None
    (searchForMaxIteration semantics, utils/system_utils.py:26)."""
    if not os.path.isdir(root):
        return None
    best, best_n = None, -1
    for name in os.listdir(root):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and int(m.group(1)) > best_n:
            best, best_n = os.path.join(root, name), int(m.group(1))
    return best
