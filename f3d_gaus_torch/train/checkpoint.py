"""Checkpoint save/restore of the feed-forward train state with
torch.save / torch.load (counterpart of f3d_gaus_tpu/train/checkpoint.py,
which writes the JAX TrainState pytree with orbax).

A checkpoint is a directory holding `state.pt`: the predictor's
state_dict, the optimizer's state_dict and the step.
"""
from __future__ import annotations

import os
import re

import torch

_FILE = "state.pt"


def save(path: str, state) -> None:
    """Write a train.feedforward.TrainState into directory `path`."""
    os.makedirs(path, exist_ok=True)
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": int(state.step)}, os.path.join(path, _FILE))


def restore(path: str, state):
    """Load the checkpoint in directory `path` into `state` (a TrainState of
    the same configuration) in place, and return it."""
    device = next(state.model.parameters()).device
    ckpt = torch.load(os.path.join(path, _FILE), map_location=device,
                      weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = ckpt["step"]
    return state


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
