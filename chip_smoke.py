#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (f3d_gaus_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--num_nvs_views 128]

Phases, one JSON line each:
  1. environment: torch, CUDA, nvcc, the card; builds the decision pass
     csrc/gof_decide.cu, csrc/raster_fwd.cu, csrc/raster_bwd.cu (all
     including csrc/gof_pair.cuh) and csrc/integrate.cu anew for sm_90a
     (one nvcc each, in parallel) and prints ptxas's register/shared-memory
     lines;
  2. decide_vs_plain: the decision pass's mask against its plain version
     (rasterize._contrib_mask_impl): word for word on the 32^2 cases of
     tests/torch_cases.py; on the flagship each differing bit must be a
     pair whose decision f32 rounding can flip (flip_margins);
     kernel_vs_plain: the compositing forward (K1 = decision pass +
     compositing pass) against its plain PyTorch version on the 32^2 cases
     (out9 and final_T at atol 1e-4, last_pos / max_pos equal) and on the
     256^2 65,536-Gaussian flagship (bench.py's anchor: channels 0-5, 7, 8,
     max error < 2e-2, <= 0.1 % of values above 1e-3);
     kernel_vs_plain_bwd: the backward (K2 = decision pass + backward
     pass) against its plain
     version on the same inputs and a seeded out9 cotangent (alpha channel
     zeroed): d_feat and d_stats within 5e-3 x max |g| per column on every
     32^2 case and on >= 99.9 % of the flagship's Gaussian rows, each row
     outside holding a pair whose f32 decision can flip (flip_margins);
     and autograd of a render loss to the five inputs and means2d_stats,
     kernel path against backend="torch", on the 32^2 cases;
     given_mask_vs_plain: on the flagship, the compositing and backward
     passes against their plain versions given the same decision mask
     (compare_given_mask: no alpha or t decision left to flip);
     integrate_vs_plain: the field-query kernel csrc/integrate.cu
     against its plain version (ops/integrate.py:_alpha_impl): one view's
     field and the running minimum over a 3-view orbit within 2e-5 (the
     JAX package's tolerance) on the 32^2 cases of
     tests/torch_cases.integrate_cases; on the flagship cloud's
     9-per-Gaussian seed points at the frontal NVS view and the bench
     camera, bench.py's anchor (max < 2e-2, <= 0.1 % above 1e-3);
  3. main_path (serving): cycle.run_nvs_replanned at PipelineConfig() width
     (256^2, base_dim 128, 8 aggregation views, 128+1 NVS views) with
     random EDM weights from a seeded torch.Generator on a numpy-made RGB-D
     input; checks shapes, finiteness, no overflow, and that every render
     went through K1 (launch count == (8 + 129) per attempt, as many
     decision passes, no K2);
  4. kernel_timing: K1 with CUDA events at the serving path's two shapes
     (aggregation render, P = 65,536; NVS render, P = 589,824), whole and
     each pass alone (decide_ms, composite_ms), beside the plain version
     and the bounds (operations and bytes this run's data needs, with the
     pairs the decision's shortcut rules out counted as such: pair_work),
     the decision pass's mask against the plain mask, whether
     two launches agree bit for bit, and the split of one
     NVS render into preprocess, binning, compositing and the rest, with
     a torch.profiler trace of that render;
  5. mesh_path: cli.main without --skip_mesh at PipelineConfig() width
     (128 + 1 NVS views) on one numpy-made RGB-D image written as PNG and
     16-bit _depth.png, with the seeded EDM weights' opacity bias raised
     to 1.0 (at the init no point reaches alpha 0.5 and the mesh is
     empty); requires a mesh_binary_search.ply with faces that reads
     back, no truncated field view, 129 x (1 + 8) field-query launches
     and (8 + 129) K1 launches per attempt; reports extract_mesh's stage
     seconds and counts, the CLI's wall time and peak memory;
  6. integrate_timing: the field query at that run's first-forward
     Gaussians, seed points, frontal NVS camera and caps: kernel and
     plain times, the view's preprocess / binning / projection times
     each alone, the agreement under the anchor (one view's field, and
     the running minimum written in place into a seeded field), the
     bound (the pairs whose alpha fails 1/255 charged less:
     field_pair_work), and a traced piece of the real sweep
     (sweep_profile: each stage's share of a view, the device's busy
     share);
  7. train_path: feedforward.train_step at PipelineConfig() width on
     TRAIN_BATCH numpy-made RGB-D images (the yaml's 7 does not fit in
     80 GB), one fixed novel camera, lr 1e-4, TRAIN_STEPS applied steps;
     the caps double on RenderOverflow (the step runs again, unapplied);
     checks finite terms, moved parameters, a falling loss, and that K1
     and K2 each launch 3 times per image per applied step, the decision
     pass once for each of them; per-step forward / backward / optimizer
     seconds and peak allocated memory; then a torch.profiler trace of one
     more step;
  8. kernel_timing_bwd: K2 at the training step's two shapes (canonical
     render, P = 65,536; cycle render, P = 131,072) of image 0, whole and
     each pass alone (decide_ms, backward_ms), beside the plain backward
     and the bound, and whether two launches agree bit for bit; K2 held
     against the plain backward there and, at another cotangent seed, on
     image 1's two renders: >= 99.7 % of rows within 5e-3 x max |g|, each
     row outside holding a pair that can flip; the decision pass's mask on
     all four renders, each differing bit a pair that can flip; and
     compare_given_mask on all four.
Then the `kernels` line, the card's name and power limit, and last the
result line.  Any failure raises, so the script exits non-zero and prints
no result; it also refuses to run without a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# FP32 operations per (pixel, pair), counted from csrc/gof_pair.cuh,
# csrc/raster_fwd.cu and csrc/raster_bwd.cu (an FMA counts 2).  Deciding a
# pair takes its two quadratic forms and the test of
# gof_pair.cuh:surely_fails (23), which rules most pairs out; the rest take
# the whole decision, BB, t, alpha and the tests (41).  A contributing pair
# adds normal, colour, depth and distortion accumulation (64) in the
# forward, and in the backward about 181 (T rebuild, dL/dalpha, the
# pull-back to the 19 monomial rows, the stats, and 22 sums over the pixels)
OPS_PER_REJECTED = 23
OPS_PER_DECIDED = 41
OPS_PER_CONTRIB = 64
OPS_PER_CONTRIB_BWD = 181
TIMED_LAUNCHES = 20        # kernel launches per CUDA-event timing
# gradient tolerance, x max |g| per column: the JAX package's own
# (tests/test_pallas_raster.py:51-53); K2's atomics reorder the sums
GRAD_TOL = 5e-3
# shares of Gaussian rows K2 must hold within GRAD_TOL, where alpha = 1/255
# flips move a few (PERF.md): the flagship, and the training step's renders
FLAGSHIP_ROWS = 0.999
TRAIN_ROWS = 0.997
FLIP_KINDS = ("alpha", "t", "num")   # the decisions flip_margins witnesses
# bench.py's anchor, for renders in which f32 rounding moves single
# pixels: the largest error, and the share of values above ANCHOR_ABOVE
ANCHOR_MAX_ERR = 2e-2
ANCHOR_ABOVE = 1e-3
ANCHOR_SHARE = 1e-3
# the compositing forward against its plain version given the same mask:
# the stop and median-depth positions (last_pos, max_pos) may differ on
# at most this share of pixels (an f32 flip of T (1 - alpha) < 1e-4 or
# T > 0.5); where they agree, all of out9, depth included, and final_T
# are held to the anchor
GIVEN_MASK_POS_SHARE = 1e-3
GIVEN_MASK_TOL_TEXT = (
    f"fwd: positions equal on >= {1 - GIVEN_MASK_POS_SHARE} of pixels; "
    f"there out9 (depth included) and final_T max < {ANCHOR_MAX_ERR}, <= "
    f"{ANCHOR_SHARE} of pixels above {ANCHOR_ABOVE}; bwd: {GRAD_TOL} x "
    "max|g| per column, each row outside with a pair whose clamp of num "
    "can flip")
# the field query: the JAX package's own tolerance at 32^2
# (tests/test_integrate.py:83); FP32 operations per (point, pair), counted
# from csrc/integrate.cu:pair_factor (an FMA counts 2): 43 for a pair whose
# alpha reaches 1/255, 37 for one that fails (its ray quadratic, 36, and a
# compare of val against 2 ln(255 opa); no exp); the mesh path's bisection
# steps (extract_mesh's binary_steps)
INTEGRATE_TOL = 2e-5
OPS_PER_PAIR_INTEGRATE = 43
OPS_PER_FAILING_INTEGRATE = 37
MESH_STEPS = 8
TRAIN_BATCH = 6            # images per step; 7 need ~86.5e9 bytes (PERF.md)
TRAIN_STEPS = 5            # applied steps (tests/test_feedforward.py:64-95)
GRAD_NAMES = ("means", "scales", "quats", "opacities", "shs", "means2d_stats")


def require(ok, what):
    """A check that holds under `python -O` too."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0].strip()


def cloud_to(cloud, dev):
    import torch
    return [torch.from_numpy(a).to(dev) for a in cloud]


def compare(inp, exact=True, case=None):
    """Kernel vs plain version on one prepared input; raises on
    disagreement, or when the kernel's render of small case `case` misses
    what the case is there to exercise (torch_cases.exercised)."""
    import numpy as np
    import torch
    from f3d_gaus_torch.ops import rasterize as R
    import torch_cases

    ko, ka = R.composite(inp)
    po, pa = R.composite(inp, "torch")
    torch.cuda.synchronize()
    res = {"out9_err": float((ko - po).abs().max()),
           "final_T_err": float((ka.final_T - pa.final_T).abs().max())}
    if exact:
        res["pos_equal"] = bool(torch.equal(ka.last_pos, pa.last_pos)
                                and torch.equal(ka.max_pos, pa.max_pos))
        require(res["out9_err"] <= 1e-4 and res["final_T_err"] <= 1e-4
                and res["pos_equal"], res)
    if case is not None:
        res["exercised"] = torch_cases.exercised(
            case, inp.binning.tile_count, ka, inp.statics.max_per_tile)
        require(all(res["exercised"].values()), res)
    ki = R._tiles_to_image(ko, inp.statics).cpu().numpy()
    pi = R._tiles_to_image(po, inp.statics).cpu().numpy()
    err, frac = torch_cases.bench_parity(ki, pi)
    res.update(anchor_err=err, anchor_frac_above_1e3=frac,
               depth_px_differ=float(np.mean(np.abs(ki[6] - pi[6]) > 1e-3)))
    require(err < ANCHOR_MAX_ERR and frac <= ANCHOR_SHARE, res)
    return res


def quad(q, U, V):
    """_chunk_eval's quadratic form of six monomial rows."""
    return (q[0] * U + q[1] * V + q[3]) * U + (q[2] * V + q[4]) * V + q[5]


def surely_fails(wfeat_c, u, v):
    """gof_pair.cuh:surely_fails in f32, the decision's shortcut past the
    divisions and the exp: (T, PIX, C) bool, set where num > max(AA,
    1e-12) thr with thr = 2 ln(opa / (1/255)) (1 + 1e-4) + 2e-3 (-inf for
    an opacity below 1/255).  wfeat_c (T, C, NFEAT) window features, u and
    v (T, PIX, 1) rays.  It counts work: PyTorch's roundings may differ
    from the kernel's by an ulp."""
    import torch
    from f3d_gaus_torch.ops import rasterize as R

    f = wfeat_c[:, None]
    AA = quad([f[..., R.ROW_QA + i] for i in range(6)], u, v)
    num = quad([f[..., R.ROW_QK + i] for i in range(6)], u, v)
    opa = f[..., R.ROW_OPA]
    eps = torch.tensor(R.ALPHA_EPS, dtype=opa.dtype, device=opa.device)
    thr = torch.where(opa < eps, float("-inf"),
                      2.0 * torch.log(opa / eps) * 1.0001 + 2e-3)
    return num > AA.clamp_min(1e-12) * thr


def pair_work(inp, last_pos=None):
    """The (pixel, pair)s the kernels need for this input, summed over
    pixels: `window`, every slot of every tile's window (the decision
    pass); `walked`, each pixel's window up to and including the Gaussian
    that stops it (K1); with the forward's `last_pos`, `bwd`, each pixel's
    window up to its last contributor (K2); and `contrib`, the
    contributing pairs.  Each of the three walks comes with the count of
    its pairs that surely_fails rules out (`<name>_rejected`).  Follows
    rasterize._composite_fwd_impl; raises if surely_fails rules out a pair
    that passes the decision."""
    import collections
    import torch
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.ops import rasterize as R

    s, bng = inp.statics, inp.binning
    feat = cuda_raster._all_features(inp.pre.v2g_mb, inp.rgb, inp.opa)
    dev = feat.device
    u, v = R._tile_rays(s, dev)
    C = s.chunk
    _, valid, wfeat, n = R._windows(feat, bng.point_list, bng.tile_start,
                                    bng.tile_count, s)
    T = torch.ones(u.shape, device=dev)
    live = torch.ones(u.shape, dtype=torch.bool, device=dev)
    work = collections.Counter()
    with torch.no_grad():
        for ci in range(n):
            sl = slice(ci * C, (ci + 1) * C)
            ct = R._chunk_eval(wfeat[:, sl], u, v)
            vc = R._decide(ct, valid[:, sl])
            rejected = surely_fails(wfeat[:, sl], u[..., None], v[..., None])
            require(not bool((rejected & vc).any()),
                    "surely_fails ruled out a pair that passes")
            alpha = torch.where(vc, ct["alpha_raw"], 0.0)
            T_before = T[..., None] * R._exclusive_cumprod(1.0 - alpha, -1)
            stop = vc & (T_before * (1.0 - ct["alpha_raw"]) < R.STOP_T)
            stop_i = stop.int()
            reach = (torch.cumsum(stop_i, -1) - stop_i) == 0
            inside = valid[:, None, sl].expand_as(vc)
            walks = {"window": inside,
                     "walked": reach & inside & live[..., None]}
            if last_pos is not None:
                pos = torch.arange(ci * C, (ci + 1) * C, device=dev)
                walks["bwd"] = inside & (pos <= last_pos[..., None].long())
            for name, m in walks.items():
                work[name] += int(m.sum())
                work[name + "_rejected"] += int((m & rejected).sum())
            contrib = vc & ~stop & walks["walked"]
            work["contrib"] += int(contrib.sum())
            T = T * torch.prod(torch.where(contrib, 1.0 - alpha, 1.0), -1)
            live = live & ~stop.any(-1)
    return dict(work)


def decide_ops(work, walk):
    """FP32 operations of deciding the pairs of one walk of pair_work."""
    rejected = work[walk + "_rejected"]
    return (rejected * OPS_PER_REJECTED
            + (work[walk] - rejected) * OPS_PER_DECIDED)


def time_ms(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def work_fields(work):
    """pair_work's counts for a JSON line, with the share of each walk's
    pairs that surely_fails rules out."""
    return {"pairs_px": work, "rejected_share": {
        k: work[k + "_rejected"] / max(work[k], 1)
        for k in ("window", "walked", "bwd") if k in work}}


def time_kernel(inp, iters, plain_iters):
    """Kernel and plain-version times on one prepared input, whole and
    each pass alone, the bounds, the kernel-vs-plain errors and the
    decision pass's mask against the plain mask."""
    import torch
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.ops import rasterize as R

    pre, bng, s = inp.pre, inp.binning, inp.statics
    feat = cuda_raster._all_features(pre.v2g_mb, inp.rgb, inp.opa).detach()
    args = (bng.point_list, bng.tile_start, bng.tile_count, inp.bg)
    ms = time_ms(lambda: cuda_raster.composite_fwd(feat, *args, s), iters)
    mask = cuda_raster.decide(feat, *args[:3], s)
    decide_ms = time_ms(lambda: cuda_raster.decide(feat, *args[:3], s), iters)
    composite_ms = time_ms(
        lambda: cuda_raster.composite_fwd(feat, *args, s, mask=mask), iters)
    (o1, a1), (o2, a2) = (cuda_raster.composite_fwd(feat, *args, s)
                          for _ in range(2))
    bitwise = torch.equal(o1, o2) and all(map(torch.equal, a1, a2))
    plain_ms = time_ms(lambda: R._composite_fwd_impl(feat, *args, s),
                       plain_iters, warmup=1)
    plain_mask = []
    decide_plain_ms = time_ms(lambda: plain_mask.append(
        R._contrib_mask_impl(feat, *args[:3], s)), 1, warmup=0)
    mask_check = compare_mask(inp, exact=False, plain=plain_mask.pop())
    work = pair_work(inp)
    # bytes this input needs: each kept pair's id and each referenced
    # Gaussian's NFEAT feature columns read once, the per-tile offsets and
    # counts, and the 9 + 6 per-pixel outputs written once; the passes
    # apart also write (decision) or read (compositing) the mask words of
    # the windows, 4 bytes per 32 slots and pixel
    ids = bng.point_list[bng.point_list < pre.radii.shape[0]]
    tiles = s.grid_x * s.grid_y
    in_bytes = (ids.numel() * 4 + int(torch.unique(ids).numel()) * R.NFEAT * 4
                + 2 * tiles * 4)
    out_bytes = 3 * 4 + tiles * R.PIX * (9 + 6) * 4
    n_win = torch.clamp_max(bng.tile_count.long(), s.max_per_tile)
    mask_bytes = int(((n_win + 31) // 32).sum()) * R.PIX * 4
    contrib_ops = work["contrib"] * OPS_PER_CONTRIB
    bounds = {name: bound(o, b) for name, o, b in (
        ("", decide_ops(work, "walked") + contrib_ops, in_bytes + out_bytes),
        ("decide_", decide_ops(work, "window"), in_bytes + mask_bytes),
        ("composite_", contrib_ops, in_bytes + mask_bytes + out_bytes))}
    return dict(P=int(pre.radii.shape[0]), pairs=int(bng.num_pairs),
                max_per_tile=s.max_per_tile, **work_fields(work),
                bitwise_repeatable=bitwise, ms=ms,
                decide_ms=decide_ms, composite_ms=composite_ms,
                plain_ms=plain_ms, decide_plain_ms=decide_plain_ms,
                **{k + f: v for k, b in bounds.items() for f, v in b.items()},
                **compare(inp, exact=False), mask=mask_check)


def bound(ops, nbytes):
    """The least time the card could take: operations over the FP32 peak
    or bytes over the memory rate, whichever is larger."""
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return {"ops": ops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def bwd_inputs(inp, seed):
    """K2's inputs for one prepared render: the feature and conic/means2d
    tables, the slab, K1's residuals and a seeded out9 cotangent with the
    alpha channel (7) zeroed, as tests/test_pallas_raster.py:33-34."""
    import numpy as np
    import torch
    from f3d_gaus_torch.ops import cuda_raster

    feat = cuda_raster._all_features(inp.pre.v2g_mb, inp.rgb, inp.opa).detach()
    extra = torch.cat([inp.pre.conic, inp.pre.means2d], 1).detach()
    b = inp.binning
    slab = (b.point_list, b.tile_start, b.tile_count, inp.bg)
    out, aux = cuda_raster.composite_fwd(feat, *slab, inp.statics)
    g = np.random.default_rng(seed).normal(size=tuple(out.shape))
    g[..., 7] = 0.0
    return feat, extra, slab, aux, torch.from_numpy(g.astype(np.float32)).to(
        feat.device)


def pair_margins(wfeat_c, u, v):
    """Each (pixel, pair)'s distance from a decision that two f32
    evaluations can take differently, in units of a first-order bound on
    any f32 evaluation's error (a flip is possible only at <= 1): wfeat_c
    (T, C, NFEAT) window features, u and v (T, PIX, 1) f64 rays.  The f64
    evaluation of the same f32 inputs stands for the exact value; the
    bound takes 6 roundings of the sum of |terms| for each quadratic form,
    3 for BB, one for the division, 2 ulp for expf and one for the product
    with the opacity.  Returns (3, T, PIX, C) margins of the alpha test
    (where t can pass), the t test (where alpha can pass) and the sign of
    num (where both can)."""
    import numpy as np
    import torch
    from f3d_gaus_torch.ops import rasterize as R

    au, av = u.abs(), v.abs()
    # the thresholds as the f32 comparisons see them; f32's unit roundoff
    eps_a, near = float(np.float32(R.ALPHA_EPS)), float(np.float32(R.NEAR_PLANE))
    ur = 2.0 ** -24
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=u.device)
    tiny = 1e-300

    f = wfeat_c[:, None].double()                            # (T, 1, C, NFEAT)
    qa = [f[..., R.ROW_QA + i] for i in range(6)]
    qk = [f[..., R.ROW_QK + i] for i in range(6)]
    bv = [f[..., R.ROW_B + i] for i in range(3)]
    A, N = quad(qa, u, v), quad(qk, u, v)
    BB = 2.0 * (bv[0] * u + bv[1] * v + bv[2])
    dA = 6 * ur * quad([x.abs() for x in qa], au, av)
    dN = 6 * ur * quad([x.abs() for x in qk], au, av)
    dB = 3 * ur * 2.0 * (bv[0].abs() * au + bv[1].abs() * av + bv[2].abs())
    A_s = A.clamp_min(1e-12)
    t = -BB / (2.0 * A_s)
    mv = N.clamp_min(0.0) / A_s
    alpha = (f[..., R.ROW_OPA] * torch.exp(-0.5 * mv)).clamp_max(0.99)
    keep = 1.0 / (1.0 - dA / A_s).clamp_min(tiny)   # AA's error in 1/AA
    d_t = t.abs() * (dB / BB.abs().clamp_min(tiny) + dA / A_s + 2 * ur) * keep
    d_mv = (dN + mv * dA) / A_s * keep + ur * mv
    d_alpha = alpha * (torch.expm1(0.5 * d_mv) + 6 * ur)
    t_ok, a_ok = t + d_t > near, alpha + d_alpha >= eps_a
    # a test can flip the pair only where the other one can pass, the
    # clamp of num only where the pair can contribute
    return torch.stack([
        torch.where(t_ok, (alpha - eps_a).abs() / d_alpha.clamp_min(tiny), inf),
        torch.where(a_ok, (t - near).abs() / d_t.clamp_min(tiny), inf),
        torch.where(a_ok & t_ok, N.abs() / dN.clamp_min(tiny), inf)])


def flip_margins(inp, aux):
    """Each Gaussian's least distance from a decision that two f32
    evaluations can take differently.  K2 decides each (pixel, pair) with
    K1's f32 formulas, the plain backward with PyTorch's: where alpha sits
    at 1/255 or t at the near plane within the f32 error, the two can
    disagree on whether the pair contributes; where num = |b x Md|^2 sits
    at 0, on whether its gradient passes the clamp of num.  Either way the
    pair carries its Gaussian's gradient in that pixel on one side only.

    For every walked pair (window position <= the pixel's last
    contributor, which both sides take from K1) the margin is
    pair_margins'.  Two f32 evaluations can decide differently only at a
    margin <= 1.  Returns the (3, P) least margin over each Gaussian's
    walked pairs by decision (alpha, t, num; inf for none) and the (P,)
    mask of the Gaussians walked at all."""
    import torch
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.ops import rasterize as R

    s, b = inp.statics, inp.binning
    feat = cuda_raster._all_features(inp.pre.v2g_mb, inp.rgb, inp.opa).detach()
    P, dev = feat.shape[0], feat.device
    C = s.chunk
    gids, valid, wfeat, n = R._windows(feat, b.point_list, b.tile_start,
                                       b.tile_count, s)
    gids = torch.where(valid, gids, P)
    margin = torch.full((3, P + 1), float("inf"), dtype=torch.float64,
                        device=dev)
    walked_rows = torch.zeros(P + 1, dtype=torch.bool, device=dev)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=dev)
    rays = tuple(x.double()[..., None] for x in R._tile_rays(s, dev))

    with torch.no_grad():
        for ci in range(n):
            sl = slice(ci * C, (ci + 1) * C)
            m = pair_margins(wfeat[:, sl], *rays)
            pos = torch.arange(ci * C, (ci + 1) * C, device=dev)
            walked = valid[:, None, sl] & (pos <= aux.last_pos[..., None].long())
            ids = gids[:, sl].reshape(-1)
            m = torch.where(walked, m, inf).amin(2).reshape(3, -1)
            margin.scatter_reduce_(1, ids.expand(3, -1), m, "amin")
            walked_rows[ids[walked.any(1).reshape(-1)]] = True
    return margin[:, :P], walked_rows[:P]


def popcount(words):
    """Set bits of int32 mask words, summed (SWAR in int64)."""
    x = words.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return int((((x * 0x01010101) & 0xFFFFFFFF) >> 24).sum())


def compare_mask(inp, exact=True, plain=None):
    """The decision pass's mask against its plain version on one prepared
    input (or `plain`, that version's mask already computed), over the
    words the pass writes: equal word for word (`exact`), or each
    differing bit a pair of some tile's window whose alpha or t decision
    f32 rounding can flip (pair_margins <= 1)."""
    import torch
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.ops import rasterize as R

    s, b = inp.statics, inp.binning
    feat = cuda_raster._all_features(inp.pre.v2g_mb, inp.rgb, inp.opa).detach()
    slab = (b.point_list, b.tile_start, b.tile_count)
    k = cuda_raster.decide(feat, *slab, s)
    p = R._contrib_mask_impl(feat, *slab, s) if plain is None else plain
    used = R.mask_words_used(b.tile_start, b.tile_count, s)
    diff = torch.zeros_like(p)
    diff[:used] = k[:used] ^ p[:used]
    res = {"words": used * R.PIX, "bits_set": popcount(k[:used]),
           "bits_differ": popcount(diff[:used])}
    if exact or res["bits_differ"] == 0:
        require(res["bits_differ"] == 0, res)
        return res
    _, valid, wfeat, n = R._windows(feat, *slab, s)
    rays = tuple(x.double()[..., None] for x in R._tile_rays(s, feat.device))
    C = s.chunk
    inside = flip_a = flip_t = witnessed = 0
    for ci in range(n):
        sl = slice(ci * C, (ci + 1) * C)
        d = (R._unpack_window_bits(diff, b.tile_start, ci * C, C)
             & valid[:, None, sl])
        if not bool(d.any()):
            continue
        m = pair_margins(wfeat[:, sl], *rays) <= 1.0
        inside += int(d.sum())
        flip_a += int((d & m[0]).sum())
        flip_t += int((d & m[1]).sum())
        witnessed += int((d & (m[0] | m[1])).sum())
    res.update(bits_differ_in_windows=inside, can_flip_alpha=flip_a,
               can_flip_t=flip_t, unwitnessed_bits=inside - witnessed)
    require(inside == res["bits_differ"] and witnessed == inside, res)
    return res


def grad_agreement(kernel, plain):
    """K2's (d_feat, d_stats) against the plain version's: the largest
    absolute error and the share of Gaussian rows whose every column is
    within GRAD_TOL x that column's largest |g|; and the mask of the rows
    outside."""
    import torch
    k, p = torch.cat(kernel, 1), torch.cat(plain, 1)
    require(bool(torch.isfinite(k).all()), "finite K2 gradients")
    err = (k - p).abs()
    ok = (err <= GRAD_TOL * p.abs().amax(0, keepdim=True)).all(1)
    return {"max_abs_err": float(err.max()),
            "max_abs_grad": float(p.abs().max()), "rows": int(ok.numel()),
            "rows_within_tol": float(ok.float().mean())}, ~ok


def held_bwd(inp, args, kernel, plain, min_rows, kinds=FLIP_KINDS):
    """grad_agreement, required: at least `min_rows` of the rows within
    GRAD_TOL and, where that is below 1, each row outside holding a pair
    whose decision of one of `kinds` (of FLIP_KINDS) can flip
    (flip_margins)."""
    res, bad = grad_agreement(kernel, plain)
    if min_rows < 1.0:
        by_kind, walked = flip_margins(inp, args[6])
        can_flip = by_kind <= 1.0
        any_flip = can_flip[[FLIP_KINDS.index(k) for k in kinds]].any(0)
        res.update(
            rows_outside_tol=int(bad.sum()), witnesses=list(kinds),
            unwitnessed_rows=int((bad & ~any_flip).sum()),
            outside_tol_can_flip={k: int((bad & can_flip[i]).sum())
                                  for i, k in enumerate(FLIP_KINDS)},
            walked_rows=int(walked.sum()),
            walked_rows_can_flip={
                **{k: int((walked & can_flip[i]).sum())
                   for i, k in enumerate(FLIP_KINDS)},
                "any": int((walked & any_flip).sum())})
        require(res["unwitnessed_rows"] == 0, res)
    require(res["rows_within_tol"] >= min_rows, res)
    return res


def compare_bwd(inp, seed, min_rows=1.0):
    """K2 against the plain backward on one prepared input (held_bwd)."""
    import torch
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.ops import rasterize as R

    feat, extra, slab, aux, g = bwd_inputs(inp, seed)
    args = (feat, extra, *slab, aux, g, inp.statics)
    k = cuda_raster.composite_bwd(*args)
    p = R._composite_bwd_impl(*args)
    torch.cuda.synchronize()
    return held_bwd(inp, args, k, p, min_rows)


def compare_given_mask(inp, seed, min_rows):
    """The compositing and backward passes against their plain versions
    with both given the decision pass's mask, so that no alpha or t
    decision is left to flip.  The forwards must agree on the stop and
    median-depth positions (last_pos, max_pos) on all but
    GIVEN_MASK_POS_SHARE of the pixels, and on the pixels where they agree
    hold all of out9 and final_T to bench.py's anchor (ANCHOR_*: what is
    left is the f32 rounding of alpha's monomial form).  The backwards, on
    the kernel forward's residuals and a seeded cotangent, must hold
    held_bwd with only the clamp of num left as a witness."""
    import torch
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.ops import rasterize as R

    feat, extra, slab, _, g = bwd_inputs(inp, seed)
    s = inp.statics
    mask = cuda_raster.decide(feat, *slab[:3], s)
    ko, ka = cuda_raster.composite_fwd(feat, *slab, s, mask=mask)
    po, pa = R._composite_fwd_impl(feat, *slab, s, mask=mask)
    same = (ka.last_pos == pa.last_pos) & (ka.max_pos == pa.max_pos)
    err = torch.cat([(ko - po).abs(), (ka.final_T - pa.final_T).abs()[
        ..., None]], -1)[same]
    require(err.numel() > 0, "the forwards agree on no pixel's positions")
    worst = err.amax(1)
    fwd = {"pixels": same.numel(), "pos_differ": int((~same).sum()),
           "max_abs_err": float(worst.max()),
           "channel_max_abs_err": err.amax(0).tolist(),
           "share_above": {f"{x:g}": float((worst > x).float().mean())
                           for x in (1e-5, 1e-4, ANCHOR_ABOVE)}}
    require(fwd["pos_differ"] <= GIVEN_MASK_POS_SHARE * fwd["pixels"]
            and fwd["max_abs_err"] < ANCHOR_MAX_ERR
            and fwd["share_above"][f"{ANCHOR_ABOVE:g}"] <= ANCHOR_SHARE, fwd)
    args = (feat, extra, *slab, ka, g, s)
    kb = cuda_raster.composite_bwd(*args, mask=mask)
    pb = R._composite_bwd_impl(*args, mask=mask)
    return {"fwd": fwd, "bwd": held_bwd(inp, args, kb, pb, min_rows,
                                        kinds=("num",))}


def compare_chain(cam, cloud, bg, kw, dev, seed):
    """Autograd of sum(out9 * w9) to the five inputs and means2d_stats, the
    kernel path against backend="torch": each input's largest error over
    its largest |g|, required within GRAD_TOL."""
    import numpy as np
    import torch
    from f3d_gaus_torch.ops import rasterize as R

    w9 = np.random.default_rng(seed).normal(size=(9, cam.height, cam.width))
    w9[7] = 0.0
    w9 = torch.from_numpy(w9.astype(np.float32)).to(dev)
    grads = []
    for backend in ("auto", "torch"):
        ts = [torch.from_numpy(a).to(dev).requires_grad_() for a in cloud]
        ts.append(torch.zeros((cloud[0].shape[0], 3), device=dev,
                              requires_grad=True))
        out = R.render(*ts[:5], cam, torch.from_numpy(bg).to(dev),
                       means2d_stats=ts[5], backend=backend, **kw)
        (out["out9"] * w9).sum().backward()
        grads.append([t.grad for t in ts])
    res = {}
    for name, k, p in zip(GRAD_NAMES, *grads):
        scale = float(p.abs().max())
        res[name] = float((k - p).abs().max()) / max(scale, 1e-30)
        require(bool(torch.isfinite(k).all()) and res[name] <= GRAD_TOL,
                f"chain d/d{name}: {res[name]}")
    return res


def time_kernel_bwd(inp, iters, seed):
    """K2's times on one prepared input, whole and each pass alone, the
    plain backward's, the bounds, the agreement (of the gradients and of
    the decision mask) and whether two launches agree bit for bit."""
    import torch
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.ops import rasterize as R

    s, b = inp.statics, inp.binning
    feat, extra, slab, aux, g = bwd_inputs(inp, seed)
    args = (feat, extra, *slab, aux, g, s)
    ms = time_ms(lambda: cuda_raster.composite_bwd(*args), iters)
    mask = cuda_raster.decide(feat, *slab[:3], s)
    decide_ms = time_ms(lambda: cuda_raster.decide(feat, *slab[:3], s), iters)
    backward_ms = time_ms(lambda: cuda_raster.composite_bwd(*args, mask=mask),
                          iters)
    k1, k2 = (cuda_raster.composite_bwd(*args) for _ in range(2))
    torch.cuda.synchronize()
    bitwise = all(torch.equal(x, y) for x, y in zip(k1, k2))
    plain = []
    plain_ms = time_ms(lambda: plain.append(R._composite_bwd_impl(*args)), 1,
                       warmup=0)
    agree = held_bwd(inp, args, k1, plain[0], TRAIN_ROWS)
    agree["mask"] = compare_mask(inp, exact=False)
    agree["given_mask"] = compare_given_mask(inp, seed, TRAIN_ROWS)

    # the work this input needs: every (pixel, pair) up to the pixel's last
    # contributor is decided, every contributor pulled back; the decision
    # pass alone decides every pair of the windows
    work = pair_work(inp, aux.last_pos)
    contrib_ops = work["contrib"] * OPS_PER_CONTRIB_BWD
    # bytes: the ids of each tile's walked window and the 24 columns of each
    # Gaussian in it read once, the 13 per-pixel inputs, the tile offsets,
    # and a read-modify-write of each such Gaussian's 22 gradient columns;
    # the passes apart also write or read the windows' mask words
    gids, valid, _ = R._gather_windows(feat[:, :1], b.point_list,
                                       b.tile_start, b.tile_count,
                                       s.max_per_tile)
    last = aux.last_pos.amax(1)
    walked_slots = valid & (torch.arange(s.max_per_tile, device=feat.device)
                            <= last[:, None])
    n_ids = int(walked_slots.sum())
    uniq = int(torch.unique(gids[walked_slots]).numel())
    tiles = s.grid_x * s.grid_y
    in_bytes = n_ids * 4 + uniq * (R.NFEAT + 5) * 4 + 2 * tiles * 4 + 3 * 4
    rest_bytes = tiles * R.PIX * 13 * 4 + uniq * (R.NFEAT + 3) * 4 * 2
    n_win = torch.clamp_max(b.tile_count.long(), s.max_per_tile)
    mask_bytes = int(((n_win + 31) // 32).sum()) * R.PIX * 4
    bounds = {name: bound(o, nb) for name, o, nb in (
        ("", decide_ops(work, "bwd") + contrib_ops, in_bytes + rest_bytes),
        ("decide_", decide_ops(work, "window"), in_bytes + mask_bytes),
        ("backward_", contrib_ops, in_bytes + mask_bytes + rest_bytes))}
    return dict(P=int(feat.shape[0]), pairs=int(b.num_pairs),
                max_per_tile=s.max_per_tile, **work_fields(work),
                bitwise_repeatable=bitwise, ms=ms, decide_ms=decide_ms,
                backward_ms=backward_ms, plain_ms=plain_ms,
                **{k + f: v for k, b in bounds.items() for f, v in b.items()},
                **agree)


def prepared(g, cam, cfg, b=0):
    """rasterize.prepare of element b of a Gaussian dict at cfg's caps."""
    import torch
    from f3d_gaus_torch.ops import rasterize as R

    shs = torch.cat([g["features_dc"][b], g["features_rest"][b]], 1)
    return R.prepare(g["xyz"][b], g["scaling"][b], g["rotation"][b],
                     g["opacity"][b], shs, cam,
                     torch.zeros(3, device=shs.device),
                     sh_degree=cfg.max_sh_degree, kernel_size=cfg.kernel_size,
                     pair_cap=cfg.pair_cap, max_per_tile=cfg.max_per_tile,
                     chunk=cfg.chunk)


def render_breakdown(g, cam, cfg, reps=3):
    """Milliseconds of one render through renderer.render_gaussians, split
    into preprocess, binning, compositing (feature table + kernel) and the
    image/normal assembly after it; the card is synchronised around each
    part."""
    import torch
    from f3d_gaus_torch.core import gaussians as G
    from f3d_gaus_torch.ops import rasterize as R
    from f3d_gaus_torch.pipeline import renderer

    shs = torch.cat([g["features_dc"][0], g["features_rest"][0]], 1)
    args = (g["xyz"][0], g["scaling"][0], g["rotation"][0], g["opacity"][0],
            shs)
    bg = torch.zeros(3, device=shs.device)

    def wall(fn):
        out = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3, out

    pre_ms, _ = wall(lambda: G.preprocess(*args, cfg.max_sh_degree, cam,
                                          cfg.kernel_size))
    prep_ms, inp = wall(lambda: R.prepare(
        *args, cam, bg, sh_degree=cfg.max_sh_degree,
        kernel_size=cfg.kernel_size, pair_cap=cfg.pair_cap,
        max_per_tile=cfg.max_per_tile, chunk=cfg.chunk))
    comp_ms, _ = wall(lambda: R.composite(inp))
    total_ms, _ = wall(lambda: renderer.render_gaussians(
        g, 0, cam.world_view, cam.full_proj, cam.cam_center, bg, cfg))
    return {"preprocess_ms": pre_ms, "binning_ms": prep_ms - pre_ms,
            "composite_ms": comp_ms,
            "image_and_normals_ms": total_ms - prep_ms - comp_ms,
            "render_ms": total_ms}


def device_profile(run, top=10):
    """torch.profiler over one call of `run` (warmed up by one call
    before): the device's busy share of the window and the `top`
    operators with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies), so no time counts twice
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    return {"wall_us": wall_us, "device_busy_us": busy_us,
            "busy_share": busy_us / wall_us,
            "raster_kernels_us": {k: sum(r[1] for r in rows if k in r[0])
                                  for k in ("gof_decide", "raster_fwd",
                                            "raster_bwd", "integrate_kernel")},
            "top": [{"op": k[:80], "device_us": t, "calls": c}
                    for k, t, c in rows[:top]]}


def profile_render(g, cam, cfg):
    """device_profile of one NVS render."""
    import torch
    from f3d_gaus_torch.pipeline import renderer

    bg = torch.zeros(3, device=g["xyz"].device)
    return device_profile(lambda: renderer.render_gaussians(
        g, 0, cam.world_view, cam.full_proj, cam.cam_center, bg, cfg))


def smooth_rgbd(rng, r):
    """A smooth random RGB image in [0, 1] and a depth map normalised to
    [6.667, 8.667] (the demo dataset's depth range), both (1, r, r, ...)."""
    import numpy as np
    yy, xx = np.meshgrid(np.linspace(0, 1, r), np.linspace(0, 1, r),
                         indexing="ij")

    def field():
        f = sum(np.cos(2 * np.pi * (rng.uniform(0.5, 3) * xx
                                    + rng.uniform(0.5, 3) * yy
                                    + rng.uniform())) * rng.uniform(0.2, 1)
                for _ in range(4))
        return (f - f.min()) / (f.max() - f.min())
    img = np.stack([field() for _ in range(3)], -1)
    img = np.clip(img + rng.normal(size=img.shape) * 0.02, 0, 1)
    depth = field() * 2.0 + 6.667
    return img[None].astype(np.float32), depth[None].astype(np.float32)


def build(card):
    """Phase 1: the environment, and every kernel built anew."""
    import torch
    from f3d_gaus_torch.ops import cuda_raster

    nvcc = subprocess.run([cuda_raster._nvcc(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    t0 = time.perf_counter()
    cuda_raster.load(rebuild=True)
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in cuda_raster.build_log.splitlines()
             if "registers" in ln or "spill" in ln or ln.startswith("[")]
    emit("environment", python=sys.version.split()[0], torch=torch.__version__,
         torch_cuda=torch.version.cuda, nvcc=nvcc.strip().splitlines()[-1],
         card=card, device=torch.cuda.get_device_name(0),
         build_s=build_s, ptxas=ptxas)


def kernels_vs_plain(dev, seed):
    """Phase 2: the decision pass, K1 and K2 against their plain versions
    on the 32^2 cases and the flagship; returns the flagship's K2
    agreement and the mask comparisons."""
    import numpy as np
    import torch
    from f3d_gaus_torch.ops import rasterize as R
    import torch_cases

    masks = []
    for name, cam, cloud, bg, kw in torch_cases.small_cases(seed):
        inp = R.prepare(*cloud_to(cloud, dev), cam,
                        torch.from_numpy(bg).to(dev), **kw)
        masks.append(compare_mask(inp))
        emit("decide_vs_plain", case=name, tol="equal words", **masks[-1])
        emit("kernel_vs_plain", case=name, tol=1e-4,
             **compare(inp, case=name))
        res = compare_bwd(inp, seed)
        emit("kernel_vs_plain_bwd", case=name, tol=f"{GRAD_TOL} x max|g| "
             "per column", **res,
             chain_rel_err=compare_chain(cam, cloud, bg, kw, dev, seed))
    cam, cloud = torch_cases.bench_scene(np.random.default_rng(seed))
    tc = cloud_to(cloud, dev)
    caps = R.plan_caps(*tc[:4], cam)
    inp = R.prepare(*tc, cam, **caps)
    require(not bool(inp.binning.overflow), "flagship caps overflow")
    masks.append(compare_mask(inp, exact=False))
    emit("decide_vs_plain", case="flagship_256_65536", caps=caps,
         tol="each differing bit a pair that can flip", **masks[-1])
    emit("kernel_vs_plain", case="flagship_256_65536", caps=caps,
         tol="anchor: channels 0-5,7,8 max < 2e-2, <= 0.1% above 1e-3",
         **compare(inp, exact=False))
    flag = compare_bwd(inp, seed, FLAGSHIP_ROWS)
    emit("kernel_vs_plain_bwd", case="flagship_256_65536", caps=caps,
         tol=f"{GRAD_TOL} x max|g| per column on >= {FLAGSHIP_ROWS} of rows, "
             "each row outside with a pair that can flip", **flag)
    given = [compare_given_mask(inp, seed, FLAGSHIP_ROWS)]
    emit("given_mask_vs_plain", case="flagship_256_65536",
         tol=GIVEN_MASK_TOL_TEXT, **given[-1])
    torch.cuda.synchronize()
    return flag, masks, given


def serving_path(args, dev, card):
    """Phases 3 and 4: run_nvs_replanned at full width with the launch
    counts set to 0 just before it, then K1's timing at its shapes."""
    import numpy as np
    import torch
    from f3d_gaus_torch.core.cameras import Camera
    from f3d_gaus_torch.models import predictor as P
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.pipeline import config as C
    from f3d_gaus_torch.pipeline import cycle
    from f3d_gaus_torch.pipeline import dataset as D

    cfg = dataclasses.replace(C.PipelineConfig(),
                              num_nvs_views=args.num_nvs_views)
    model = P.GaussianPredictor(cfg.predictor_config(),
                                torch.Generator().manual_seed(args.seed))
    n_params = sum(p.numel() for p in model.parameters())
    images, depth = smooth_rgbd(np.random.default_rng(args.seed),
                                cfg.resolution)
    cams = D.canonical_cameras(cfg)
    replans = []
    timings = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_raster.launches = cuda_raster.launches_bwd = 0
    cuda_raster.launches_decide = 0
    t0 = time.perf_counter()
    res = cycle.run_nvs_replanned(model, cfg, cams, images, depth,
                                  device=dev, log=replans.append,
                                  timings=timings)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, launches_bwd = cuda_raster.launches, cuda_raster.launches_bwd
    launches_decide = cuda_raster.launches_decide
    peak = torch.cuda.max_memory_allocated()

    P_px = cfg.resolution ** 2
    n_agg, n_nvs = cfg.num_aggregation_views, cfg.num_nvs_views + 1
    require(res.merged["xyz"].shape == (1, (1 + n_agg) * P_px, 3),
            f"merged xyz {tuple(res.merged['xyz'].shape)}")
    require(res.renders["render"].shape == (1, n_nvs, 3, cfg.resolution,
                                            cfg.resolution),
            f"renders {tuple(res.renders['render'].shape)}")
    for part in (res.merged, res.renders, res.agg_views):
        for k, v in part.items():
            if v.is_floating_point():
                require(bool(torch.isfinite(v).all()), f"finite {k}")
    require(not bool(res.renders["overflow"].any())
            and not bool(res.agg_views["overflow"].any()),
            "overflow after replanning")
    require(launches == launches_decide == (n_agg + n_nvs) * res.attempts > 0
            and launches_bwd == 0,
            f"{launches} K1 / {launches_decide} decision / {launches_bwd} K2 "
            f"launches for {res.attempts} attempts")
    emit("main_path", card=card, config="PipelineConfig()",
         num_nvs_views=cfg.num_nvs_views, params=n_params,
         attempts=res.attempts, replans=replans,
         caps={"pair_cap": res.cfg.pair_cap,
               "max_per_tile": res.cfg.max_per_tile},
         kernel_launches=launches, decide_launches=launches_decide,
         wall_s=wall_s,
         stage_s_last_attempt=timings, peak_allocated_bytes=peak,
         merged_points=int(res.merged["xyz"].shape[1]))

    fcfg = res.cfg

    def camera(cams_set, i):
        return Camera(cams_set.world_view[i], cams_set.full_proj[i],
                      cams_set.cam_centers[i], fcfg.resolution,
                      fcfg.resolution, fcfg.tan_fov, fcfg.tan_fov)

    agg_cam = camera(cycle.aggregation_cameras(fcfg, cams.inverse_first_camera), 0)
    nvs_cam = camera(cycle.nvs_cameras(fcfg, cams.inverse_first_camera), 0)
    shapes = {"aggregation": time_kernel(prepared(res.first, agg_cam, fcfg),
                                         TIMED_LAUNCHES, 3),
              "nvs": time_kernel(prepared(res.merged, nvs_cam, fcfg),
                                 TIMED_LAUNCHES, 2)}
    for k, v in shapes.items():
        emit("kernel_timing", card=card, shape=k, **v)
    emit("nvs_render_breakdown", card=card,
         caps={"pair_cap": fcfg.pair_cap, "max_per_tile": fcfg.max_per_tile},
         **render_breakdown(res.merged, nvs_cam, fcfg))
    emit("nvs_render_profile", card=card,
         **profile_render(res.merged, nvs_cam, fcfg))
    return (launches, launches_decide), shapes, (n_nvs, n_agg + n_nvs)


def training_path(args, dev, card):
    """Phases 7 and 8: feedforward.train_step at full width with the launch
    counts set to 0 just before the steps, then K2's timing at the
    canonical and cycle renders of the trained weights."""
    import numpy as np
    import torch
    from f3d_gaus_torch.core.cameras import Camera
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.pipeline import config as C
    from f3d_gaus_torch.pipeline import dataset as D
    from f3d_gaus_torch.pipeline import cycle, renderer
    from f3d_gaus_torch.train import feedforward as F

    cfg, B = C.PipelineConfig(), TRAIN_BATCH
    state = F.init_state(torch.Generator().manual_seed(args.seed), cfg,
                         lr=1e-4)
    # one fixed novel camera keeps the objective the same across steps
    pack = F.make_cameras_pack(cfg, D.canonical_cameras(cfg), n_banks=1,
                               views_per_bank=1)
    rng = np.random.default_rng(args.seed + 1)
    images, depths = zip(*(smooth_rgbd(rng, cfg.resolution) for _ in range(B)))
    batch = {"images": torch.from_numpy(np.concatenate(images)).to(dev),
             "depth": torch.from_numpy(np.concatenate(depths)).to(dev)}
    p0 = {k: v.detach().clone() for k, v in state.model.named_parameters()}
    attempts, steps = [], []
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_raster.launches = cuda_raster.launches_bwd = 0
    cuda_raster.launches_decide = 0
    t_start = time.perf_counter()
    while len(steps) < TRAIN_STEPS:
        f0, b0 = cuda_raster.launches, cuda_raster.launches_bwd
        d0 = cuda_raster.launches_decide
        timings = {}
        t0 = time.perf_counter()
        try:
            loss, aux = F.train_step(state, cfg, batch, pack, timings=timings)
        except renderer.RenderOverflow as e:
            require(len(attempts) < cycle.MAX_DOUBLINGS, "caps keep overflowing")
            cfg = dataclasses.replace(cfg, pair_cap=cfg.pair_cap * 2,
                                      max_per_tile=cfg.max_per_tile * 2)
            attempts.append(f"step {state.step}: {e}; caps now "
                            f"{cfg.pair_cap} / {cfg.max_per_tile}")
            continue
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        terms = {k: v.item() for k, v in aux.items() if k != "overflow"}
        require(all(np.isfinite(v) for v in terms.values())
                and np.isfinite(loss.item()), terms)
        require(not bool(aux["overflow"].any()), "overflow in an applied step")
        k1, k2 = cuda_raster.launches - f0, cuda_raster.launches_bwd - b0
        kd = cuda_raster.launches_decide - d0
        require(k1 == k2 == 3 * B and kd == 6 * B,
                f"step launches K1 {k1}, K2 {k2}, decision {kd}, B {B}")
        steps.append({"loss": loss.item(), **terms, "wall_s": wall,
                      **{f"{k}_s": v for k, v in timings.items()}})
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t_start
    launches = (cuda_raster.launches, cuda_raster.launches_bwd,
                cuda_raster.launches_decide)
    peak = torch.cuda.max_memory_allocated()
    require(launches == (3 * B * (len(steps) + len(attempts)),
                         3 * B * len(steps),
                         3 * B * (2 * len(steps) + len(attempts))),
            f"launches {launches}")
    moved = max(float((v.detach() - p0[k]).abs().max())
                for k, v in state.model.named_parameters())
    require(moved > 0, "parameters did not move")
    require(steps[-1]["loss"] < steps[0]["loss"],
            f"loss {steps[0]['loss']} -> {steps[-1]['loss']}")
    emit("train_path", card=card, config="PipelineConfig()", batch=B,
         lr=1e-4, applied_steps=len(steps), replans=attempts,
         caps={"pair_cap": cfg.pair_cap, "max_per_tile": cfg.max_per_tile},
         launches_k1=launches[0], launches_k2=launches[1],
         launches_decide=launches[2], total_s=total_s,
         peak_allocated_bytes=peak, max_param_change=moved, steps=steps)
    # two more steps, after the counted ones: where a step's time goes
    emit("train_step_profile", card=card, batch=B, **device_profile(
        lambda: F.train_step(state, cfg, batch, pack), top=15))

    # K2 at the step's two shapes: the canonical and cycle renders of
    # images 0 (timed) and 1
    cam = Camera(pack.cano_wv, pack.cano_fp, pack.cano_cc, cfg.resolution,
                 cfg.resolution, cfg.tan_fov, cfg.tan_fov)
    v2w, quat, wv, fp, cc = F.select_novel_camera(pack, state.step,
                                                  F.Curriculum())

    @torch.no_grad()
    def renders_of(i):
        target = batch["images"][i:i + 1].permute(0, 3, 1, 2)
        depth = batch["depth"][i:i + 1]
        g = F._predict(state.model, target, torch.ones_like(target[:, :1]),
                       depth, pack.cano_v2w, pack.cano_quat)
        o = renderer.render_gaussians(g, 0, wv, fp, cc,
                                      torch.zeros(3, device=dev), cfg)
        g2 = F.cycle_predict(state.model, target, depth, o["render"][None],
                             o["rendered_alpha"][None],
                             o["rendered_depth"][None, 0], pack, v2w, quat)
        return {"canonical": g, "cycle": g2}

    timed, other = renders_of(0), renders_of(1)
    del state, p0
    torch.cuda.empty_cache()
    shapes = {k: time_kernel_bwd(prepared(g, cam, cfg), TIMED_LAUNCHES,
                                 args.seed) for k, g in timed.items()}
    for k, v in shapes.items():
        emit("kernel_timing_bwd", card=card, shape=k, **v)
    masks = [v["mask"] for v in shapes.values()]
    given = [v["given_mask"] for v in shapes.values()]
    for k, g in other.items():
        inp = prepared(g, cam, cfg)
        emit("kernel_vs_plain_bwd", case=f"train_{k}_image1",
             tol=f"{GRAD_TOL} x max|g| per column on >= {TRAIN_ROWS} of "
                 "rows, each row outside with a pair that can flip",
             **compare_bwd(inp, args.seed + 1, TRAIN_ROWS))
        masks.append(compare_mask(inp, exact=False))
        emit("decide_vs_plain", case=f"train_{k}_image1",
             tol="each differing bit a pair that can flip", **masks[-1])
        given.append(compare_given_mask(inp, args.seed + 1, TRAIN_ROWS))
        emit("given_mask_vs_plain", case=f"train_{k}_image1",
             tol=GIVEN_MASK_TOL_TEXT, **given[-1])
    return launches, shapes, B, masks, given


def field_agreement(kernel, plain):
    """The field-query kernel's alpha against the plain version's: the
    largest error and the share of points above ANCHOR_ABOVE."""
    err = (kernel - plain).abs()
    return {"points": int(err.numel()),
            "max_abs_err": float(err.max()) if err.numel() else 0.0,
            "share_above_1e3": float((err > ANCHOR_ABOVE).float().mean())}


def integrate_vs_plain(dev, seed):
    """Phase 2, integrate_vs_plain: the field-query kernel against its plain
    version: one view's field and the running minimum over a 3-view orbit
    within 2e-5 on the 32^2 cases of tests/torch_cases.integrate_cases; on
    the flagship cloud, its 9-per-Gaussian seed points at the frontal NVS
    view and at the bench camera under bench.py's anchor.  Returns the
    largest error on the 32^2 cases."""
    import numpy as np
    import torch
    from f3d_gaus_torch.mesh import points as MP
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.ops import integrate as TI
    from f3d_gaus_torch.ops import rasterize as R
    from f3d_gaus_torch.pipeline import config as C
    from f3d_gaus_torch.pipeline import cycle
    from f3d_gaus_torch.pipeline import dataset as D
    import torch_cases

    orbit = torch_cases.orbit_views(3)
    views = (orbit.world_view, orbit.full_proj, orbit.cam_centers)
    size = dict(width=32, height=32, tan_fovx=torch_cases.TAN,
                tan_fovy=torch_cases.TAN)
    worst = 0.0
    for name, cam, cloud, pts, kw in torch_cases.integrate_cases(seed):
        tc, tp = cloud_to(cloud, dev), torch.from_numpy(pts).to(dev)
        n0 = cuda_raster.launches_integrate
        k = TI.integrate_points(*tc, cam, tp, **kw)["alpha_integrated"]
        km = TI.integrate_min_alpha(*tc, *views, tp, **size, **kw)
        torch.cuda.synchronize()
        n = cuda_raster.launches_integrate - n0
        p = TI.integrate_points(*tc, cam, tp, backend="torch",
                                **kw)["alpha_integrated"]
        pm = TI.integrate_min_alpha(*tc, *views, tp, backend="torch", **size,
                                    **kw)
        res = {"view": field_agreement(k, p),
               "min_over_3_views": field_agreement(km, pm), "launches": n}
        err = max(res["view"]["max_abs_err"],
                  res["min_over_3_views"]["max_abs_err"])
        worst = max(worst, err)
        require(n == 4 and err <= INTEGRATE_TOL, res)
        emit("integrate_vs_plain", case=name, tol=INTEGRATE_TOL, **res)
    cfg = C.PipelineConfig()
    cam, cloud = torch_cases.bench_scene(np.random.default_rng(seed))
    tc = cloud_to(cloud, dev)
    frontal = cycle.nvs_cameras(cfg, D.canonical_cameras(
        cfg).inverse_first_camera).camera(0, cfg.resolution, cfg.resolution,
                                          cfg.tan_fov, cfg.tan_fov)
    for view, c in (("frontal", frontal), ("bench_camera", cam)):
        pts, _ = MP.tetra_points(cloud[0], cloud[1], cloud[2],
                                 c.world_view[None], cfg.fov_deg,
                                 resolution=cfg.resolution)
        tp = torch.from_numpy(pts).to(dev)
        caps = R.plan_caps(*tc[:4], c)
        over = TI.overflow_views
        k = TI.integrate_points(*tc, c, tp, **caps)["alpha_integrated"]
        p = TI.integrate_points(*tc, c, tp, backend="torch",
                                **caps)["alpha_integrated"]
        res = field_agreement(k, p)
        require(TI.overflow_views == over, "flagship binning truncated")
        require(res["max_abs_err"] < ANCHOR_MAX_ERR
                and res["share_above_1e3"] <= ANCHOR_SHARE, res)
        emit("integrate_vs_plain", case=f"flagship_256_65536_{view}",
             caps=caps, tol="anchor: max < 2e-2, <= 0.1% of points above 1e-3",
             field_mean=float(k.mean()), **res)
    torch.cuda.synchronize()
    return worst


def write_rgbd(folder, image, depth):
    """One input of the demo dataset: s0.png and its 16-bit s0_depth.png
    (pipeline/dataset.py reads the depth as I / 65536 and normalises it)."""
    import numpy as np
    from PIL import Image
    os.makedirs(folder, exist_ok=True)
    Image.fromarray((np.clip(image, 0, 1) * 255).round().astype(np.uint8)
                    ).save(os.path.join(folder, "s0.png"))
    d = (depth - depth.min()) / (depth.max() - depth.min())
    Image.fromarray((d * 65535).round().astype(np.uint16)).save(
        os.path.join(folder, "s0_depth.png"))


def mesh_path(args, dev, card):
    """Phase 5: cli.main without --skip_mesh at PipelineConfig() width on one
    numpy-made RGB-D image written as PNGs, with the raised-opacity
    weights, the launch counts and integrate's overflow count set to 0
    just before it.  Requires a non-empty mesh that reads back, no
    truncated view and 129 x (1 + 8) field-query launches."""
    import contextlib
    import io
    import shutil
    import numpy as np
    import torch
    from f3d_gaus_torch import cli
    from f3d_gaus_torch.io import ply
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.ops import integrate as TI
    from f3d_gaus_torch.pipeline import config as C
    import torch_cases

    cfg = C.PipelineConfig()
    work = os.path.join(ROOT, "build", "mesh_smoke")
    shutil.rmtree(work, ignore_errors=True)
    images, depth = smooth_rgbd(np.random.default_rng(args.seed + 2),
                                cfg.resolution)
    write_rgbd(os.path.join(work, "input"), images[0], depth[0])
    ckpt = os.path.join(work, "raised_opacity.pt")
    torch_cases.raised_opacity_checkpoint(ckpt, cfg, args.seed)
    out = os.path.join(work, "out")
    argv = ["--folder", os.path.join(work, "input"), "--output_path", out,
            "--load_model", ckpt, "--num_nvs_views", str(args.num_nvs_views)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_raster.launches = cuda_raster.launches_bwd = 0
    cuda_raster.launches_decide = cuda_raster.launches_integrate = 0
    TI.overflow_views = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"integrate": cuda_raster.launches_integrate,
                "raster_fwd": cuda_raster.launches,
                "gof_decide": cuda_raster.launches_decide,
                "raster_bwd": cuda_raster.launches_bwd}
    overflow_views = TI.overflow_views
    peak = torch.cuda.max_memory_allocated()
    lines = log.getvalue().splitlines()
    require(rc == 0, f"cli exit {rc}: {lines[-5:]}")
    d = os.path.join(out, "00_00")
    with open(os.path.join(d, "mesh_stats.json")) as f:
        stats = json.load(f)
    v, faces, _ = ply.read_mesh_ply(os.path.join(d, "mesh_binary_search.ply"))
    n_views = args.num_nvs_views + 1
    n_renders = (cfg.num_aggregation_views + n_views) * stats["attempts"]
    require(overflow_views == 0, f"{overflow_views} truncated field views")
    require(len(v) > 0 and len(faces) > 0 and bool(np.isfinite(v).all())
            and faces.min() >= 0 and faces.max() < len(v)
            and stats["counts"]["faces"] == len(faces),
            f"mesh {v.shape} {faces.shape}")
    require(launches["integrate"] == n_views * (1 + MESH_STEPS)
            and launches["raster_fwd"] == launches["gof_decide"] == n_renders
            and launches["raster_bwd"] == 0, launches)
    emit("mesh_path", card=card, config="PipelineConfig()",
         weights="seeded EDM init, out.bias[3] = 1.0 (opacity logit)",
         num_nvs_views=args.num_nvs_views, method=stats["method"],
         attempts=stats["attempts"],
         caps={"pair_cap": stats["pair_cap"],
               "max_per_tile": stats["max_per_tile"]},
         counts=stats["counts"], mesh_stage_s=stats["stage_s"],
         cli_wall_s=wall_s, peak_allocated_bytes=peak, launches=launches,
         overflow_views=overflow_views,
         cli_log=[ln for ln in lines if "replanning" in ln or "mesh:" in ln])
    return {"out_dir": d, "stats": stats, "launches": launches,
            "n_views": n_views}


def field_pair_work(slab, q, s):
    """The (point, pair)s the field query needs at one view: `pairs`, each
    inside point against every slot of its tile's window
    min(tile_count, max_per_tile), and `passing`, those whose alpha reaches
    1/255 (integrate._pair_alpha in f32: it counts work, and PyTorch's
    roundings may differ from the kernel's by an ulp).  Walks the windows
    as integrate._alpha_impl does."""
    import torch
    from f3d_gaus_torch.ops import integrate as TI

    v2g_mb, opa, point_list, tile_start, tile_count = slab
    P, T = v2g_mb.shape[0], tile_start.shape[0]
    rows = torch.cat([v2g_mb, opa[:, None]], 1)
    rows = torch.cat([rows, rows.new_zeros((1, 13))], 0)
    order = torch.argsort(torch.where(q.inside, q.tile, T), stable=True)
    n_pts = torch.bincount(q.tile[q.inside].long(), minlength=T).tolist()
    count = torch.clamp_max(tile_count, s.max_per_tile).tolist()
    start = tile_start.tolist()
    pairs, passing, pos = 0, torch.zeros((), dtype=torch.int64), 0
    passing = passing.to(v2g_mb.device)
    with torch.no_grad():
        for t in range(T):
            pts = order[pos:pos + n_pts[t]]
            pos += n_pts[t]
            pairs += len(pts) * count[t]
            for lo in range(0, len(pts), s.point_chunk):
                sel = pts[lo:lo + s.point_chunk]
                for c0 in range(0, count[t], s.chunk):
                    ids = point_list[start[t] + c0:
                                     start[t] + min(c0 + s.chunk, count[t])]
                    alpha = TI._pair_alpha(rows[ids.long().clamp(0, P)][None],
                                           q.u[sel], q.v[sel], q.depth[sel])
                    passing += (alpha > 0).sum()
    return {"pairs": pairs, "passing": int(passing)}


def sweep_profile(gauss, cams, pts, cfg, pair_cap, mpt, n_views=8):
    """The first n_views views of the real integrate_min_alpha at the mesh
    run's shape: the time per view on the device's clock and each stage's
    share of it (CUDA events recorded around preprocess, binning, the
    points' projection and the field query as the sweep calls them, with
    no sync between them, so a stage's time includes the device's waits on
    the host inside it; `other` is what lies between the stages), and
    device_profile's busy share and top operators of the same call."""
    import torch
    from f3d_gaus_torch.core import gaussians as G
    from f3d_gaus_torch.ops import binning as B
    from f3d_gaus_torch.ops import integrate as TI

    views = tuple(a[:n_views] for a in (cams.world_view, cams.full_proj,
                                         cams.cam_centers))

    def sweep():
        TI.integrate_min_alpha(
            *gauss, *views, pts, width=cfg.resolution,
            height=cfg.resolution, tan_fovx=cfg.tan_fov,
            tan_fovy=cfg.tan_fov, sh_degree=cfg.max_sh_degree,
            pair_cap=pair_cap, max_per_tile=mpt, chunk=cfg.chunk)

    marks = []

    def timed(name, fn):
        def run(*a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            r = fn(*a, **k)
            e1.record()
            marks.append((name, e0, e1))
            return r
        return run

    stages = {"preprocess": (G, "preprocess"),
              "binning": (B, "bin_gaussians"),
              "query_rays": (TI, "query_rays"),
              "field_query": (TI, "_view_alpha")}
    saved = {k: getattr(*mod) for k, mod in stages.items()}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    try:
        for k, (mod, attr) in stages.items():
            setattr(mod, attr, timed(k, saved[k]))
        sweep()
        torch.cuda.synchronize()
        marks.clear()
        start.record()
        sweep()
        end.record()
        torch.cuda.synchronize()
    finally:
        for k, (mod, attr) in stages.items():
            setattr(mod, attr, saved[k])
    total = start.elapsed_time(end)
    stage_ms = {k: sum(e0.elapsed_time(e1) for n, e0, e1 in marks if n == k)
                for k in stages}
    require(all(sum(n == k for n, _, _ in marks) == n_views for k in stages),
            "a sweep stage ran other than once per view")
    prof = device_profile(sweep)
    return {"views": n_views, "ms_per_view": total / n_views,
            "stage_ms_per_view": {k: v / n_views for k, v in stage_ms.items()},
            "stage_share": {**{k: v / total for k, v in stage_ms.items()},
                            "other": 1 - sum(stage_ms.values()) / total},
            "profile_wall_ms_per_view": prof["wall_us"] / 1e3 / n_views,
            "busy_share": prof["busy_share"],
            "device_busy_ms_per_view": prof["device_busy_us"] / 1e3 / n_views,
            "top": prof["top"]}


def integrate_timing(mesh, args, dev, card):
    """Phase 6: the field query at the mesh run's shape: its first-forward
    Gaussians (read back from its gaussians.ply), its seed points, the
    frontal NVS camera and its settled caps.  The kernel (with the
    wrapper's sort of the points by tile) by CUDA events, its device time
    alone by the profiler, the plain version, the same view's preprocess,
    binning and projection each alone, the agreement under bench.py's
    anchor in both modes (one view's field, and the running minimum written
    in place into a seeded field), the bound from this view's data, and
    sweep_profile: where the time of a view goes inside a sweep."""
    import numpy as np
    import torch
    from f3d_gaus_torch.core import gaussians as G
    from f3d_gaus_torch.io import ply
    from f3d_gaus_torch.mesh import points as MP
    from f3d_gaus_torch.ops import binning as B
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.ops import integrate as TI
    from f3d_gaus_torch.ops import rasterize as R
    from f3d_gaus_torch.pipeline import config as C
    from f3d_gaus_torch.pipeline import cycle
    from f3d_gaus_torch.pipeline import dataset as D

    cfg = dataclasses.replace(C.PipelineConfig(),
                              num_nvs_views=args.num_nvs_views)
    st = mesh["stats"]
    pair_cap, mpt = st["pair_cap"], st["max_per_tile"]
    g = ply.read_gaussian_ply(os.path.join(mesh["out_dir"], "gaussians.ply"))
    nvs = cycle.nvs_cameras(cfg, D.canonical_cameras(cfg).inverse_first_camera)
    pts, _ = MP.tetra_points(g["xyz"], g["scaling"], g["rotation"],
                             nvs.world_view, cfg.fov_deg,
                             resolution=cfg.resolution)
    require(len(pts) == st["counts"]["seed_points"],
            f"{len(pts)} seed points, the run had {st['counts']}")
    res = cfg.resolution
    cam = nvs.camera(0, res, res, cfg.tan_fov, cfg.tan_fov)
    shs = np.concatenate([g["f_dc"], g["f_rest"]], 1)
    gauss = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        g["xyz"], g["scaling"], g["rotation"], g["opacity"], shs))
    s = TI._statics(cam, mpt, cfg.chunk, 1 << 14)
    tp = torch.from_numpy(pts).to(dev)
    preprocess_ms = time_ms(lambda: G.preprocess(*gauss, cfg.max_sh_degree,
                                                 cam, 0.0), 5)
    pre, bng, trunc = TI._prepare_view(gauss, cam, cfg.max_sh_degree, 0.0,
                                       pair_cap, mpt)
    require(not bool(trunc), "the timed view's binning is truncated")
    binning_ms = time_ms(lambda: B.bin_gaussians(
        pre.means2d, pre.radii, pre.depths, res, res, pair_cap,
        max_per_tile=mpt), 5)
    query_rays_ms = time_ms(lambda: TI.query_rays(tp, cam, s), 5)
    q = TI.query_rays(tp, cam, s)
    slab = (pre.v2g_mb, pre.opa_coef, bng.point_list, bng.tile_start,
            bng.tile_count)
    kargs = (*slab, q.u, q.v, q.depth, q.tile, q.inside, mpt)
    ms = time_ms(lambda: cuda_raster.integrate(*kargs), TIMED_LAUNCHES)
    prof = device_profile(lambda: cuda_raster.integrate(*kargs))
    k = cuda_raster.integrate(*kargs)
    plain = []
    plain_ms = time_ms(lambda: plain.append(TI._alpha_impl(*slab, q, s)), 1,
                       warmup=0)
    agree = field_agreement(k, plain[0])
    # the sweep's mode: min(out, 1 - T) written in place, into a seeded
    # field in [0, 1] so that both sides of the minimum occur
    Q = tp.shape[0]
    seeded = torch.rand(Q, device=dev, generator=torch.Generator(
        device=dev).manual_seed(args.seed))
    out = seeded.clone()
    require(cuda_raster.integrate(*kargs, out=out) is out,
            "the running minimum was not written in place")
    running_min = field_agreement(out, torch.minimum(seeded, plain[0]))
    for a in (agree, running_min):
        require(a["max_abs_err"] < ANCHOR_MAX_ERR
                and a["share_above_1e3"] <= ANCHOR_SHARE, a)

    # the work this view's data needs: each inside point against each slot
    # of its tile's window, those whose alpha fails 1/255 charged
    # OPS_PER_FAILING_INTEGRATE; the bytes: the points' u, v, depth and
    # sorted index read and their field written once, the window ids and
    # the 13-float row of each Gaussian in them (tiles that hold points),
    # and the tiles' offsets, counts and segment starts
    work = field_pair_work(slab, q, s)
    pairs = work["pairs"]
    ops = (work["passing"] * OPS_PER_PAIR_INTEGRATE
           + (pairs - work["passing"]) * OPS_PER_FAILING_INTEGRATE)
    tiles_in = q.tile.long()[q.inside]
    occupied = torch.unique(tiles_in)
    gids, valid, _ = R._gather_windows(pre.opa_coef[:, None], bng.point_list,
                                       bng.tile_start, bng.tile_count, mpt)
    sel = valid[occupied]
    n_ids = int(sel.sum())
    uniq = int(torch.unique(gids[occupied][sel]).numel())
    T = bng.tile_start.shape[0]
    nbytes = Q * 5 * 4 + n_ids * 4 + uniq * 13 * 4 + (2 * T + 2 * (T + 2)) * 4
    kernel_us = sum(r["device_us"] for r in prof["top"]
                    if "integrate_kernel" in r["op"])
    sweep = sweep_profile(gauss, nvs, tp, cfg, pair_cap, mpt)
    return dict(P=int(gauss[0].shape[0]), seed_points=Q,
                inside=int(q.inside.sum()),
                occupied_tiles=int(occupied.numel()),
                caps={"pair_cap": pair_cap, "max_per_tile": mpt},
                pairs=pairs, passing_pairs=work["passing"],
                failing_share=1 - work["passing"] / max(pairs, 1),
                ms=ms, kernel_device_ms=kernel_us / 1e3,
                plain_ms=plain_ms, alone_ms={
                    "preprocess": preprocess_ms, "binning": binning_ms,
                    "query_rays": query_rays_ms},
                wrapper_profile=prof, sweep=sweep, **bound(ops, nbytes),
                **agree, running_min=running_min)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num_nvs_views", type=int, default=128)
    args = ap.parse_args(argv)

    # the training step fills most of the card; segments that grow keep
    # the allocator's cache from fragmenting it
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; it runs only on the card",
              file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    dev = torch.device("cuda")
    card = card_line()

    build(card)
    flagship_bwd, masks, given = kernels_vs_plain(dev, args.seed)
    integrate_small_err = integrate_vs_plain(dev, args.seed)
    (serve_k1, serve_decide), fwd_shapes, (n_nvs, n_render) = serving_path(
        args, dev, card)
    masks += [v["mask"] for v in fwd_shapes.values()]
    mesh = mesh_path(args, dev, card)
    field = integrate_timing(mesh, args, dev, card)
    emit("integrate_timing", card=card, view="frontal NVS camera", **field)
    mesh_k1 = mesh["launches"]["raster_fwd"]
    (train_k1, train_k2, train_decide), bwd_shapes, B, train_masks, \
        train_given = training_path(args, dev, card)
    masks += train_masks
    given += train_given

    nvs, cano = fwd_shapes["nvs"], bwd_shapes["canonical"]
    given_note = (f"; given the decision pass's mask, on {len(given)} inputs "
                  "(flagship, 4 training renders)")
    csrc = "f3d_gaus_torch/csrc/"
    kernels = [{
        "name": "raster_fwd", "route": "cuda",
        "source": csrc + "raster_fwd.cu",
        "sources": [csrc + f for f in ("gof_decide.cu", "raster_fwd.cu",
                                       "gof_pair.cuh")],
        "replaces": "f3d_gaus_tpu/ops/pallas_raster.py:230",
        "launches": serve_k1 + train_k1 + mesh_k1,
        "launches_by_path": {"serving": serve_k1, "training": train_k1,
                             "mesh": mesh_k1},
        "max_abs_err": nvs["anchor_err"],
        "ms": nvs["ms"], "plain_ms": nvs["plain_ms"],
        "bound_ms": nvs["bound_ms"], "bound_by": nvs["bound_by"],
        "library_ms": None,
        "at": f"NVS render, P={nvs['P']} ({n_nvs} of {n_render} serving "
              f"launches per attempt; {3 * B} per training step); ms is "
              "the decision pass and the compositing pass together; "
              "max_abs_err over out9 channels 0-5,7,8; given_mask_* "
              "against the plain version" + given_note,
        "given_mask_max_abs_err": max(x["fwd"]["max_abs_err"] for x in given),
        "given_mask_pos_differ": sum(x["fwd"]["pos_differ"] for x in given),
        "passes": {k: {f: v[f] for f in (
            "decide_ms", "decide_bound_ms", "composite_ms",
            "composite_bound_ms")} for k, v in fwd_shapes.items()},
        "shapes": {k: {f: v[f] for f in ("P", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "anchor_err")}
                   for k, v in fwd_shapes.items()},
    }, {
        "name": "raster_bwd", "route": "cuda",
        "source": csrc + "raster_bwd.cu",
        "sources": [csrc + f for f in ("gof_decide.cu", "raster_bwd.cu",
                                       "gof_pair.cuh")],
        "replaces": "f3d_gaus_tpu/ops/pallas_raster.py:401",
        "launches": train_k2,
        "launches_by_path": {"serving": 0, "training": train_k2, "mesh": 0},
        "max_abs_err": cano["max_abs_err"],
        "ms": cano["ms"], "plain_ms": cano["plain_ms"],
        "bound_ms": cano["bound_ms"], "bound_by": cano["bound_by"],
        "library_ms": None,
        "at": f"canonical training render, P={cano['P']} ({B} of {3 * B} "
              "launches per training step); ms is the decision pass and "
              "the backward pass together; max_abs_err over d_feat and "
              f"d_stats (largest |g| {cano['max_abs_grad']:.6g}, rows within "
              f"{GRAD_TOL} x max|g| {cano['rows_within_tol']:.6g}); flagship "
              f"max_abs_err {flagship_bwd['max_abs_err']:.6g}; given_mask_* "
              "against the plain backward" + given_note,
        "given_mask_rows_within_tol": min(x["bwd"]["rows_within_tol"]
                                          for x in given),
        "given_mask_rows_outside_tol": sum(x["bwd"]["rows_outside_tol"]
                                           for x in given),
        "passes": {k: {f: v[f] for f in (
            "decide_ms", "decide_bound_ms", "backward_ms",
            "backward_bound_ms")} for k, v in bwd_shapes.items()},
        "shapes": {k: {f: v[f] for f in ("P", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "max_abs_err",
                                         "bitwise_repeatable")}
                   for k, v in bwd_shapes.items()},
    }, {
        "name": "gof_decide", "route": "cuda",
        "source": csrc + "gof_decide.cu",
        "replaces": "f3d_gaus_tpu/ops/pallas_raster.py:262",
        "launches": serve_decide + train_decide + mesh_k1,
        "launches_by_path": {"serving": serve_decide,
                             "training": train_decide, "mesh": mesh_k1},
        "max_abs_err": int(any(m["bits_differ"] for m in masks)),
        "bits_differ": sum(m["bits_differ"] for m in masks),
        "ms": nvs["decide_ms"], "plain_ms": nvs["decide_plain_ms"],
        "bound_ms": nvs["decide_bound_ms"],
        "bound_by": nvs["decide_bound_by"], "library_ms": None,
        "at": f"NVS render, P={nvs['P']}: the decision of K1 and K2 (the vc "
              "of _fwd_kernel :262 and _bwd_kernel :444), launched once by "
              "each; max_abs_err is 1 where any mask bit differed from the "
              f"plain mask over {len(masks)} inputs, "
              f"{sum(m['bits_differ'] for m in masks)} of "
              f"{sum(m['bits_set'] for m in masks)} set bits differing, "
              "each a pair whose decision can flip; rejected_share: the "
              "windows' pairs gof_pair.cuh:surely_fails rules out",
        "shapes": {k: {"rejected_share": v["rejected_share"]["window"],
                       **{f: v[f] for f in ("P", "decide_ms",
                                            "decide_plain_ms",
                                            "decide_bound_ms") if f in v}}
                   for k, v in {**fwd_shapes, **bwd_shapes}.items()},
    }, {
        "name": "integrate", "route": "cuda",
        "source": csrc + "integrate.cu",
        "replaces": "f3d_gaus_tpu/ops/integrate.py:82",
        "launches": mesh["launches"]["integrate"],
        "launches_by_path": {"serving": 0, "training": 0,
                             "mesh": mesh["launches"]["integrate"]},
        "max_abs_err": max(field["max_abs_err"],
                           field["running_min"]["max_abs_err"]),
        "ms": field["ms"], "plain_ms": field["plain_ms"],
        "bound_ms": field["bound_ms"], "bound_by": field["bound_by"],
        "library_ms": None,
        "at": "replaces XLA code, not a Pallas kernel: the JAX package's "
              "_point_alpha_product (:82) and the window walk of "
              "_integrate_chunk (:104); the mesh path's frontal NVS view, "
              f"P={field['P']}, {field['seed_points']} seed points, "
              f"{mesh['n_views']} x (1 + {MESH_STEPS}) launches per mesh; "
              "ms includes the wrapper's sort of the points by tile "
              "(kernel_device_ms: the kernel alone); max_abs_err at that "
              "view against the plain version, one view's field and the "
              "running minimum into a seeded field (on the 32^2 cases "
              f"{integrate_small_err:.3g}, tolerance {INTEGRATE_TOL}); "
              f"bound_ms charges the pairs whose alpha fails 1/255 "
              f"{OPS_PER_FAILING_INTEGRATE} operations, the rest "
              f"{OPS_PER_PAIR_INTEGRATE}",
        "kernel_device_ms": field["kernel_device_ms"],
        "pairs": field["pairs"], "failing_share": field["failing_share"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
