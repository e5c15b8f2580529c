# Frozen copy of f3d_gaus_torch/core/device.py at commit b6ed6e2, the
# benchmark's plain reference; imports rewritten for this flat package.
"""Device selection and stage timing shared by the port's entry points."""
from __future__ import annotations

import time

import torch


def resolve_device(device=None, like: torch.Tensor | None = None) -> torch.device:
    """The device an entry point runs on.

    `device` wins when given; otherwise the device of `like`; otherwise
    `cuda`.  A CUDA device without a card raises: the port never carries on
    on the CPU unless the caller asked for it.

    Also turns TF32 off for matmuls and cuDNN convolutions: the JAX
    reference computes in full float32, and cuDNN's default TF32 keeps only
    about three decimal digits.
    """
    if device is None:
        device = like.device if like is not None else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or CPU tensors) "
            "to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


# Clamps on a differentiable path follow jnp.maximum / jnp.minimum /
# jnp.clip, which pass half the cotangent where x equals the bound;
# torch.clamp passes all of it there.  torch.maximum / torch.minimum against
# a 0-d tensor split it as JAX does.
def max_tie(x: torch.Tensor, lo: float) -> torch.Tensor:
    """max(x, lo) with jnp.maximum's gradient: 1 above, 1/2 at, 0 below."""
    return torch.maximum(x, x.new_full((), lo))


def min_tie(x: torch.Tensor, hi: float) -> torch.Tensor:
    """min(x, hi) with jnp.minimum's gradient: 1 below, 1/2 at, 0 above."""
    return torch.minimum(x, x.new_full((), hi))


def clip_tie(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip(x, lo, hi): min_tie(max_tie(x, lo), hi)."""
    return min_tie(max_tie(x, lo), hi)


# |x| on a differentiable path follows jnp.abs, which passes +g at x = 0
# (-0.0 included); torch.abs passes 0 there.
class _AbsTie(torch.autograd.Function):
    @staticmethod
    def forward(x):
        return x.abs()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def abs_tie(x: torch.Tensor) -> torch.Tensor:
    """|x| with jnp.abs's gradient: -1 below 0, +1 at -0.0, 0.0 and above.

    The value is torch.abs's (+0.0 at -0.0, as jnp.abs).  One kernel
    forward, three backward (torch.abs's takes two); torch.where(x >= 0, x,
    -x) has the same gradient but takes three forward and about four
    backward, and gives -0.0 at -0.0."""
    return _AbsTie.apply(x)


class StageClock:
    """Wall seconds per stage into `timings` (a dict), synchronising the
    card at each lap; does nothing when `timings` is None."""

    def __init__(self, device, timings):
        self.device, self.timings = device, timings
        self.t = time.perf_counter()

    def lap(self, name):
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[name] = now - self.t
        self.t = now


class EventClock:
    """Milliseconds per stage into `timings` (a dict) from CUDA events
    recorded between the stages, with no sync until `close`, which waits
    for the last event (host clock on the CPU); does nothing when
    `timings` is None."""

    def __init__(self, device, timings):
        self.device, self.timings = device, timings
        self.marks = [(None, self._now())] if timings is not None else None

    def _now(self):
        if self.device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def lap(self, name):
        if self.marks is not None:
            self.marks.append((name, self._now()))

    def close(self):
        if self.marks is None:
            return
        if self.device.type == "cuda":
            self.marks[-1][1].synchronize()
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            self.timings[name] = (a.elapsed_time(b) if self.device.type ==
                                  "cuda" else (b - a) * 1e3)
