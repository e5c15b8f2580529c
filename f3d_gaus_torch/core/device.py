"""Device selection and the gradient ties shared by the port's modules."""
from __future__ import annotations

import numpy as np
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


def upload(array, device: torch.device) -> torch.Tensor:
    """A float32 copy of the host `array` on `device`, made without the
    host waiting: on CUDA through pinned memory and a non-blocking copy
    (torch's caching host allocator keeps the pinned buffer until the copy
    has run), so no stream is synchronised, as a copy from pageable memory
    would; elsewhere a copy of the array."""
    host = np.asarray(array, np.float32)
    if device.type != "cuda":
        return torch.tensor(host, device=device)
    pinned = torch.empty(host.shape, dtype=torch.float32, pin_memory=True)
    pinned.numpy()[...] = host
    return pinned.to(device, non_blocking=True)


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
