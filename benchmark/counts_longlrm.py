"""The work the benchmark charges Long-LRM, counted from the configuration's
shapes and never from the program: the FLOPs of one forward and each
Mamba2 scan's least time on the card.

A forward (a multiply-add counting 2) over N tokens of width w before the
merge and N / merge² after it: the tokenizer 2 N (p² 9) w; a Mamba2 block
over L tokens its in-projection 2 L w (2 d + 2 g n + H), its causal conv
2 L (d + 2 g n) K, its out-projection 2 L d w and its scan (`ssd_ops`),
with d the inner width, H heads of P, g groups of state n, conv width K;
a transformer block over L tokens 2 L (4 w² + 2 w m) for its four linear
layers and 4 L² w for its attention; the merge 2 (N / merge²) (merge² w) w;
the head 2 (N / merge²) w (hp² 12), hp = p · merge.  LayerNorms, the
activations, the softmax and the gathers are left out.  At the published
shape this is 100.6 TFLOP a scene, 52 % of it the 3 attentions.

A scan over L tokens in chunks of Q: 2 L Q n g (C Bᵀ within each chunk)
+ 2 L Q H P (the masked product with x dt) + 4 L H n P (each chunk's
state, and each output's read of the state entering its chunk); its bytes
are x, dt, B and C read once and y written once, f32.  Its least time is
the larger of its FLOPs at the FP32 peak and its bytes at the memory rate
(counts.bound): 8.4 ms before the merge, 2.1 after it.
"""
from __future__ import annotations

from .counts import bound


def _inner(model: dict):
    d = model["expand"] * model["width"]
    return d, d // model["head_dim"]


def token_counts(model: dict):
    """Tokens before and after the merge."""
    p, m = model["patch"], model["merge"]
    rows = -(-model["frame_height"] // (p * m)) * m
    n = model["views"] * rows * (model["frame_width"] // p)
    return n, n // (m * m)


def scan_lengths(model: dict) -> list:
    """The token count of each Mamba2 block's scan, in layout order."""
    n, merged = token_counts(model)
    out, L = [], n
    for kind in model["layout"]:
        if kind == "+":
            L = merged
        elif kind == "M":
            out.append(L)
    return out


def ssd_ops(L: int, model: dict) -> int:
    d, H = _inner(model)
    Q, n, g, P = (model["chunk"], model["d_state"], model["ngroups"],
                  model["head_dim"])
    return 2 * L * Q * n * g + 2 * L * Q * H * P + 4 * L * H * n * P


def ssd_bytes(L: int, model: dict) -> int:
    d, H = _inner(model)
    gn = model["ngroups"] * model["d_state"]
    return 4 * L * (d + H + 2 * gn + d)


def ssd_bound(L: int, model: dict) -> dict:
    """One scan's least time on the card (counts.bound)."""
    return bound(ssd_ops(L, model), ssd_bytes(L, model))


def forward_flops(model: dict) -> dict:
    """FLOPs of one Long-LRM forward, by part and in total, for the
    configuration's `model` section (one scene)."""
    p, m, w = model["patch"], model["merge"], model["width"]
    d, H = _inner(model)
    gn = model["ngroups"] * model["d_state"]
    n, merged = token_counts(model)
    parts = {"tokenizer": 2 * n * p * p * 9 * w, "mamba_linear": 0,
             "ssd": 0, "linear": 0, "attention": 0,
             "merge": 2 * merged * m * m * w * w,
             "head": 2 * merged * w * (p * m) ** 2
             * model["gaussian_channels"]}
    L = n
    for kind in model["layout"]:
        if kind == "+":
            L = merged
        elif kind == "M":
            parts["mamba_linear"] += (2 * L * w * (2 * d + 2 * gn + H)
                                      + 2 * L * (d + 2 * gn)
                                      * model["d_conv"] + 2 * L * d * w)
            parts["ssd"] += ssd_ops(L, model)
        else:
            parts["linear"] += 2 * L * (4 * w * w + 2 * w * model["mlp"])
            parts["attention"] += 4 * L * L * w
    return {**parts, "total": sum(parts.values())}
