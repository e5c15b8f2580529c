"""The work the benchmark charges, counted from the inputs and never from
the program: K1's least time at a render, and the predictor's FLOPs.

The operation constants, `surely_fails`, `pair_work`, `decide_ops` and
`bound` are frozen from chip_smoke.py (commit b6ed6e2) with two changes:
the windows come from the reference's own preprocess and binning
(`reference/rasterize.py:prepare`), and K1 is charged only for the pairs
its inputs need (each pixel's window up to and including the Gaussian
that stops it, and the contributing pairs), whatever window the program
walks.  The FLOPs are counted with torch.utils.flop_counter on the meta
device over the reference's predictor at the configuration's shapes
(convolutions and matrix products, 2 per multiply-add).
"""
from __future__ import annotations

import collections

import torch

from .harness import PEAK_BYTES_PER_S, PEAK_FP32_FLOPS

# FP32 operations per (pixel, pair), counted from the port's
# csrc/gof_pair.cuh and csrc/raster_fwd.cu at commit b6ed6e2 (an FMA counts
# 2).  Deciding a pair takes its two quadratic forms and the test of
# gof_pair.cuh:surely_fails (23), which rules most pairs out; the rest take
# the whole decision, BB, t, alpha and the tests (41).  A contributing pair
# adds normal, colour, depth and distortion accumulation (64).
OPS_PER_REJECTED = 23
OPS_PER_DECIDED = 41
OPS_PER_CONTRIB = 64


def _quad(q, U, V):
    """_chunk_eval's quadratic form of six monomial rows."""
    return (q[0] * U + q[1] * V + q[3]) * U + (q[2] * V + q[4]) * V + q[5]


def surely_fails(wfeat_c, u, v):
    """gof_pair.cuh:surely_fails in f32: (T, PIX, C) bool, set where num >
    max(AA, 1e-12) thr with thr = 2 ln(opa / (1/255)) (1 + 1e-4) + 2e-3
    (-inf for an opacity below 1/255).  wfeat_c (T, C, NFEAT) window
    features, u and v (T, PIX, 1) rays."""
    from .reference import rasterize as R
    f = wfeat_c[:, None]
    AA = _quad([f[..., R.ROW_QA + i] for i in range(6)], u, v)
    num = _quad([f[..., R.ROW_QK + i] for i in range(6)], u, v)
    opa = f[..., R.ROW_OPA]
    eps = torch.tensor(R.ALPHA_EPS, dtype=opa.dtype, device=opa.device)
    thr = torch.where(opa < eps, float("-inf"),
                      2.0 * torch.log(opa / eps) * 1.0001 + 2e-3)
    return num > AA.clamp_min(1e-12) * thr


@torch.no_grad()
def pair_work(inp):
    """The (pixel, pair)s the forward needs for the reference's prepared
    input `inp`, summed over pixels: `walked`, each pixel's window up to
    and including the Gaussian that stops it, with `walked_rejected`, those
    surely_fails rules out; `contrib`, the contributing pairs.  Follows
    the reference's _composite_fwd_impl; raises if surely_fails rules out
    a pair that passes the decision."""
    from .reference import rasterize as R
    s, bng = inp.statics, inp.binning
    feat = R._all_features(inp.pre.v2g_mb, inp.rgb, inp.opa)
    dev = feat.device
    u, v = R._tile_rays(s, dev)
    C = s.chunk
    _, valid, wfeat, n = R._windows(feat, bng.point_list, bng.tile_start,
                                    bng.tile_count, s)
    T = torch.ones(u.shape, device=dev)
    live = torch.ones(u.shape, dtype=torch.bool, device=dev)
    work = collections.Counter()
    for ci in range(n):
        sl = slice(ci * C, (ci + 1) * C)
        ct = R._chunk_eval(wfeat[:, sl], u, v)
        vc = R._decide(ct, valid[:, sl])
        rejected = surely_fails(wfeat[:, sl], u[..., None], v[..., None])
        if bool((rejected & vc).any()):
            raise RuntimeError("surely_fails ruled out a pair that passes")
        alpha = torch.where(vc, ct["alpha_raw"], 0.0)
        T_before = T[..., None] * R._exclusive_cumprod(1.0 - alpha, -1)
        stop = vc & (T_before * (1.0 - ct["alpha_raw"]) < R.STOP_T)
        stop_i = stop.int()
        reach = (torch.cumsum(stop_i, -1) - stop_i) == 0
        inside = valid[:, None, sl].expand_as(vc)
        walked = reach & inside & live[..., None]
        work["walked"] += int(walked.sum())
        work["walked_rejected"] += int((walked & rejected).sum())
        contrib = vc & ~stop & walked
        work["contrib"] += int(contrib.sum())
        T = T * torch.prod(torch.where(contrib, 1.0 - alpha, 1.0), -1)
        live = live & ~stop.any(-1)
    return dict(work)


def decide_ops(work):
    """FP32 operations of deciding the walked pairs of pair_work."""
    rejected = work["walked_rejected"]
    return (rejected * OPS_PER_REJECTED
            + (work["walked"] - rejected) * OPS_PER_DECIDED)


def bound(ops, nbytes):
    """The least time the card could take: operations over the FP32 peak
    or bytes over the memory rate, whichever is larger."""
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"ops": ops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def k1_bound(inp):
    """K1's least time (decision and compositing) at the reference's
    prepared input: the needed pairs' operations, and the bytes its inputs
    and outputs need (each kept pair's id and each referenced Gaussian's
    feature row read once, the per-tile offsets and counts, the 9 + 6
    per-pixel outputs written once)."""
    from .reference import rasterize as R
    work = pair_work(inp)
    bng, s = inp.binning, inp.statics
    ids = bng.point_list[bng.point_list < inp.pre.radii.shape[0]]
    tiles = s.grid_x * s.grid_y
    in_bytes = (ids.numel() * 4 + int(torch.unique(ids).numel()) * R.NFEAT * 4
                + 2 * tiles * 4)
    out_bytes = 3 * 4 + tiles * R.PIX * (9 + 6) * 4
    ops = decide_ops(work) + work["contrib"] * OPS_PER_CONTRIB
    return {**bound(ops, in_bytes + out_bytes), "work": work}


def predictor_flops(pipeline_fields: dict, batch: int, views: int,
                    backward: bool = False) -> int:
    """FLOPs of one call of the reference's predictor on (batch, views)
    images at the configuration's resolution (with `backward`, the
    forward and the backward of every parameter and input that needs a
    gradient), on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode
    from .reference import config as RC
    from .reference import predictor as RP
    cfg = RC.PipelineConfig(**pipeline_fields)
    with torch.device("meta"):
        model = RP.GaussianPredictor(cfg.predictor_config())
    model = model.to("meta")
    r = cfg.resolution
    with torch.device("meta"):
        feat = torch.zeros(batch, views, r, r, 4)
        v2w = torch.eye(4).expand(batch, views, 4, 4)
        quat = torch.tensor([1.0, 0, 0, 0]).expand(batch, views, 4)
        depth = torch.ones(batch, views, r, r)
    with FlopCounterMode(display=False) as fc:
        out = model(feat, v2w, quat, depth)
        if backward:
            sum(v.sum() for v in out.values()).backward()
    return int(fc.get_total_flops())


def tower_flops(batch: int, resolution: int, loss_weights: dict) -> int:
    """FLOPs of the VGG16 perceptual and CLIP terms of one training step
    (forward, and backward to the render) on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode
    from .reference import clip as RCL
    from .reference import vgg as RVG
    with torch.device("meta"):
        vgg, clip = RVG.VGG16(), RCL.CLIPVisual(7)
        x = torch.zeros(batch, 3, resolution, resolution, requires_grad=True)
        target = torch.zeros(batch, 3, resolution, resolution)
    terms = []
    with FlopCounterMode(display=False) as fc:
        if loss_weights.get("w_perceptual"):
            terms.append(loss_weights["w_perceptual"]
                         * RVG.perceptual_loss(vgg, x, target))
        if loss_weights.get("w_clip"):
            terms.append(loss_weights["w_clip"]
                         * RCL.clip_loss(clip, x, target))
        if terms:
            sum(terms).backward()
    return int(fc.get_total_flops())


def train_step_flops(pipeline_fields: dict, batch: int,
                     loss_weights: dict) -> int:
    """FLOPs of one feed-forward training step: the predictor's two calls
    (B images, then B pairs in the cycle's N = 2 call), forward and
    backward, and the towers' terms."""
    from .reference import config as RC
    r = RC.PipelineConfig(**pipeline_fields).resolution
    return (predictor_flops(pipeline_fields, batch, 1, backward=True)
            + predictor_flops(pipeline_fields, batch, 2, backward=True)
            + tower_flops(batch, r, loss_weights))
