"""Device selection shared by the port's entry points."""
from __future__ import annotations

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
