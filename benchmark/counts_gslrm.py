"""The work the benchmark charges GS-LRM, counted from the configuration's
shapes and never from the program: the FLOPs of one forward (tokenizer,
blocks, head; matrix products, a multiply-add counting 2) and the
attention's least time on the card.

A forward over N tokens of width w (N = views · (resolution / patch)²):
the tokenizer 2 N (p² 9) w, each block 2 N (4 w² + 2 w m) for its four
linear layers (qkv 3 w², proj w², fc1 and fc2 w m each, m the MLP's
width) and 4 N² w for its
attention (q kᵀ and the weighted values, N² w multiply-adds each, summed
over the heads), the head 2 N w (p² 12).  Biases, LayerNorms, GELU and
the softmax are left out.  At the published widths this is 36.3 TFLOP.
"""
from __future__ import annotations

from .counts import bound


def forward_flops(model: dict) -> dict:
    """FLOPs of one GS-LRM forward, by part and in total, for the
    configuration's `model` section (one object)."""
    p, w = model["patch"], model["width"]
    n = model["views"] * (model["resolution"] // p) ** 2
    parts = {
        "tokenizer": 2 * n * p * p * 9 * w,
        "linear": model["layers"] * 2 * n * (4 * w * w + 2 * w * model["mlp"]),
        "attention": model["layers"] * attention_ops(n, w),
        "head": 2 * n * w * p * p * model["gaussian_channels"],
    }
    return {**parts, "total": sum(parts.values())}


def attention_ops(tokens: int, width: int) -> int:
    """FP32 operations of one self-attention over `tokens` tokens of
    `width` (all heads): 4 tokens² width."""
    return 4 * tokens * tokens * width


def attention_bound(tokens: int, width: int) -> dict:
    """One attention's least time on the card: its operations at the FP32
    peak or its bytes at the memory rate (q, k, v read and the output
    written once, f32), whichever is larger."""
    return bound(attention_ops(tokens, width), 4 * tokens * width * 4)
