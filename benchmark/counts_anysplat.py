"""The work the benchmark charges AnySplat, counted from the configuration's
shapes and never from the program: the FLOPs of one forward and the least
time of every attention in it.

A forward over S frames of T = 1 + registers + (H/p)(W/p) tokens, width
w, MLP m (a multiply-add counting 2): DINOv2's patch embedding 2 S P (3
p²) w over the P patches a frame and its `dino_layers` blocks over S
sequences of T tokens; the aggregator's `depth` frame blocks over S
sequences of T and as many global blocks over one sequence of S T; a
block's linear layers 2 L (4 w² + 2 w m) and its attention 4 L² w over a
sequence of L.  The camera head, at d = 2 w over the S camera tokens,
each of `camera_iters` iterations: the pose embedding 2 S 9 d, the adaLN
modulation 2 S d (3 d), `camera_layers` blocks (MLP 4 d) and the pose
branch 2 S (d · d/2 + d/2 · 9).  Each DPT head, a frame: the four 1×1
projections of the P tokens, the two transposed convolutions and the
strided one, the four 3×3 `layer_rn`, the RefineNet units (two 3×3
convolutions each, at the finer input of each fusion) and 1×1 out_convs
(at each fusion's output size), output_conv1 at the finest fusion's size
and output_conv2 (3×3 to 32, 1×1 to the outputs) at every pixel; a
convolution 2 Hout Wout Cin Cout k².  LayerNorms, activations, softmax,
the resizes, unprojection and the voxel merge are left out.  At the
published widths this is 120.5 TFLOP a request, 50 % of it the global
attention.

An attention's least time is its 4 L² d FLOPs a head at the FP32 peak (it
is bound by operations at these lengths): the request's 24 DINOv2, 24
frame and 24 global attentions, and the camera trunk's 16 over S tokens.
"""
from __future__ import annotations

from .counts import bound


def _linear(L: int, w: int, m: int) -> int:
    return 2 * L * (4 * w * w + 2 * w * m)


def tokens_per_frame(model: dict) -> int:
    return 1 + model["registers"] + (model["resolution"]
                                     // model["patch"]) ** 2


def _dpt_frame(model: dict, outputs: int) -> int:
    """One DPT head's FLOPs on one frame."""
    g = model["resolution"] // model["patch"]
    d, f = 2 * model["width"], model["dpt_features"]
    ch = model["dpt_channels"]
    P = g * g
    sizes = [4 * g, 2 * g, g, g // 2 + g % 2]        # each level's side
    flops = sum(2 * P * d * c for c in ch)           # projections
    flops += 2 * P * ch[0] * ch[0] * 16              # convT 4x4 stride 4
    flops += 2 * P * ch[1] * ch[1] * 4               # convT 2x2 stride 2
    flops += 2 * sizes[3] ** 2 * ch[3] * ch[3] * 9   # conv 3x3 stride 2
    flops += sum(2 * s * s * c * f * 9 for s, c in zip(sizes, ch))
    rcu = 2 * 2 * f * f * 9                          # a unit, per pixel
    out_sizes = [sizes[2], sizes[1], sizes[0], 2 * sizes[0]]
    for level, (s, o) in enumerate(zip(reversed(sizes), out_sizes)):
        units = 1 if level == 0 else 2
        flops += units * s * s * rcu + 2 * o * o * f * f
    fine, H = out_sizes[-1], model["resolution"]
    flops += 2 * fine * fine * f * (f // 2) * 9
    flops += 2 * H * H * ((f // 2) * 32 * 9 + 32 * outputs)
    return flops


def forward_flops(model: dict) -> dict:
    """FLOPs of one AnySplat forward, by part and in total, for the
    configuration's `model` section (one scene of `views` frames)."""
    S, w, m = model["views"], model["width"], model["mlp"]
    T, p = tokens_per_frame(model), model["patch"]
    P = T - 1 - model["registers"]
    d = 2 * w
    cam_block = _linear(S, d, 4 * d) + 4 * S * S * d
    camera = model["camera_iters"] * (
        2 * S * 9 * d + 2 * S * d * 3 * d
        + model["camera_layers"] * cam_block
        + 2 * S * (d * (d // 2) + (d // 2) * 9))
    parts = {
        "dinov2_linear": 2 * S * P * 3 * p * p * w
        + model["dino_layers"] * S * _linear(T, w, m),
        "dinov2_attention": model["dino_layers"] * S * 4 * T * T * w,
        "aggregator_linear": 2 * model["depth"] * _linear(S * T, w, m),
        "frame_attention": model["depth"] * S * 4 * T * T * w,
        "global_attention": model["depth"] * 4 * (S * T) ** 2 * w,
        "camera_head": camera,
        "dpt": S * (_dpt_frame(model, 2) + _dpt_frame(model, 12)),
    }
    return {**parts, "total": sum(parts.values())}


def attention_calls(model: dict) -> list:
    """(sequences, heads, L, head dim) of every attention call in a
    request, in the order the program makes them."""
    S, w, h = model["views"], model["width"], model["heads"]
    T = tokens_per_frame(model)
    calls = [(S, h, T, w // h)] * model["dino_layers"]
    for _ in range(model["depth"]):
        calls += [(S, h, T, w // h), (1, h, S * T, w // h)]
    ch = model["camera_heads"]
    calls += [(1, ch, S, 2 * w // ch)] * (model["camera_iters"]
                                         * model["camera_layers"])
    return calls


def attention_bound(model: dict) -> dict:
    """The request's attentions' least time on the card together
    (counts.bound of their 4 L² d FLOPs a head, no bytes charged) and
    their number of calls."""
    calls = attention_calls(model)
    ops = sum(4 * n * h * L * L * dh for n, h, L, dh in calls)
    return {**bound(ops, 0), "calls": len(calls)}
