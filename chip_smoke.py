#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (f3d_gaus_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--num_nvs_views 128]
                          [--scene_iterations 2000]

Phases, one JSON line each:
  1. environment: torch, CUDA, nvcc, the card; builds the decision pass
     csrc/gof_decide.cu, csrc/raster_fwd.cu, csrc/raster_bwd.cu (all
     including csrc/gof_pair.cuh), csrc/integrate.cu, csrc/preprocess.cu
     and csrc/footprint.cu (both including csrc/screen.cuh) anew for sm_90a
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
     on the flagship also where the gradient is consumed (param_holds:
     K2's and the plain version's feature-row gradients pulled back
     through the feature table and preprocess to (v2g_mb, rgb, opa) and
     to the five inputs, >= 99.9 % of rows at each level) with the tie
     census of the clamps of num and AA (tie_census);
     and autograd of a render loss to the five inputs and means2d_stats,
     kernel path against backend="torch", on the 32^2 cases;
     given_mask_vs_plain: on the flagship, the compositing and backward
     passes against their plain versions given the same decision mask
     (compare_given_mask: no alpha or t decision left to flip);
     integrate_vs_plain: the field-query kernel csrc/integrate.cu
     against its plain version (ops/integrate.py:_alpha_impl): one view's
     field and the running minimum over a 3-view orbit within 2e-5 (the
     JAX package's tolerance) on the 32^2 cases of
     tests/torch_cases.integrate_cases, through the wrapper at the
     default slice length and at one that splits the long windows, two
     launches equal; the rejection ruling out no passing pair there, on
     a thin-Gaussian case and at both flagship views; on the flagship cloud's
     9-per-Gaussian seed points at the frontal NVS view and the bench
     camera, bench.py's anchor (max < 2e-2, <= 0.1 % above 1e-3);
     preprocess_vs_plain: the preprocess kernel csrc/preprocess.cu
     against its plain version (rasterize._preprocess_impl, the composed
     route) on the main path's three shapes (an orbit view of a request's
     589,824 merged Gaussians, an aggregation view of 65,536, GS-LRM's
     1,048,576 at 512^2) and two edge clouds of tests/torch_cases.
     preprocess_cases: every field and table it writes equal bit for bit,
     and the binning; at the three shapes its device time a launch, cold
     (L2 flushed) and warm, beside the composed route's device, host and
     CUDA-event times and the byte bound;
     footprint_vs_plain: the stage cap planner's kernel csrc/footprint.cu
     against its plain version (binning._footprint_need_impl) at the
     serving orbit's and aggregation's shapes: the two counts equal; the
     kernel's device time a launch with the L2 flushed, the whole call's
     device and CUDA-event times, beside the plain version's CUDA-event
     and device times and the bound;
  3. main_path (serving): cycle.run_nvs_replanned at PipelineConfig() width
     (256^2, base_dim 128, 8 aggregation views, 128+1 NVS views) with
     random EDM weights from a seeded torch.Generator on a numpy-made RGB-D
     input; checks shapes, finiteness, no overflow, and that every render
     went through K1 and the preprocess kernel (launch count == (8 + 129)
     per attempt, as many decision passes and preprocess launches, no K2)
     and each stage's plan through the footprint kernel (2 a request:
     only the first attempt plans, a doubling reruns at static caps);
  4. kernel_timing: K1 with CUDA events at the serving path's two shapes
     (aggregation render, P = 65,536; NVS render, P = 589,824), whole and
     each pass alone (decide_ms, composite_ms), beside the plain version
     and the bounds (operations and bytes this run's data needs, with the
     pairs the decision's shortcut rules out counted as such: pair_work),
     the decision pass's mask against the plain mask, whether
     two launches agree bit for bit, and the split of one
     NVS render into preprocess (the route prepare takes), binning,
     compositing and the rest, with
     a torch.profiler trace of that render; band_vs_plain: that NVS render
     split into NVS_BANDS bands of its 16 tile rows, each rendered through
     the kernels with its row_off (rasterize.prepare(tile_rows=...)) and
     held against the plain band (compare_mask, the anchor, held_bwd on
     >= NVS_ROWS of rows, as the full frame is, and param_holds on >= 99.9
     % with the tie census, frame and bands), the stacked bands against the
     full frame's kernel render (channels 0-5, 7, 8 at 1e-4, the depth at
     5e-3) and the summed
     band gradients against the full frame's (>= 99.9 % of rows); each
     band's forward and backward launch K1 / K2 and the decision pass once
     each; each band's K1 and K2 timed beside the full frame's;
  5. mesh_path: cli.main without --skip_mesh at PipelineConfig() width
     (128 + 1 NVS views) on one numpy-made RGB-D image written as PNG and
     16-bit _depth.png, with the seeded EDM weights' opacity bias raised
     to 1.0 (at the init no point reaches alpha 0.5 and the mesh is
     empty); requires a mesh_binary_search.ply with faces that reads
     back, no truncated field view, 129 x (1 + 8) field-query launches
     and (8 + 129) K1 and preprocess launches per attempt, 2 footprint
     launches (its request's two planned stages); reports extract_mesh's stage
     seconds and counts, the CLI's wall time and peak memory;
  6. integrate_timing: the field query at that run's first-forward
     Gaussians, seed points, frontal NVS camera and caps: kernel and
     plain times (the wrapper whole, its packing and sort each alone, the
     launch given them, the kernels' device time), the view's preprocess
     / binning / projection times each alone, the agreement under the
     anchor (one view's field, and the running minimum written in place
     into a seeded field), two launches equal, the bound (the pairs the
     kernel's rejection rules out charged less, none of them passing:
     field_pair_work), the items' lane efficiency and heaviest item
     (plan_shape), and a traced piece of the real sweep
     (sweep_profile: each stage's share of a view, the device's busy
     share);
  7. train_path: feedforward.train_step at PipelineConfig() width on
     TRAIN_BATCH numpy-made RGB-D images (the yaml's 7 does not fit in
     80 GB), one fixed novel camera, lr 1e-4, TRAIN_STEPS applied steps,
     at the reference yaml's w_perceptual 2 and w_clip 0.35 with the
     VGG16 and CLIP ViT-B/32 towers at full width (models/vgg.py,
     models/clip.py; weights from a seeded torch.Generator: no pretrained
     file is in the repository), each tower's term timed forward and
     backward;
     the caps double on RenderOverflow (the step runs again, unapplied);
     checks finite terms, moved parameters, a falling loss, and that K1
     and K2 each launch 3 times per image per applied step, the decision
     pass once for each of them, and the preprocess kernel never; per-step forward / backward / optimizer
     seconds and peak allocated memory; then a torch.profiler trace of one
     more step; train_grads_vs_plain: the predictor's gradients of the
     step's objective on GRAD_BATCH images from one forward, through K2
     twice and through the plain compositing backward once, each
     parameter tensor >= 99.9 % of elements within max(5e-3 x max|g|,
     2 x K2's own spread); abs_ties: at that step, for each |x| site of
     the loss (rgb, depth, alpha, tv, perceptual, distortion, warping,
     cycle) the elements exactly +-0, those where the argument depends on
     the parameters, and the gradient jnp.abs's +1 at 0 adds (what
     core/device.py:abs_tie passes) against the step's own, per parameter
     tensor (a census; only finiteness is required);
  8. kernel_timing_bwd: K2 at the training step's two shapes (canonical
     render, P = 65,536; cycle render, P = 131,072) of image 0, whole and
     each pass alone (decide_ms, backward_ms), beside the plain backward
     and the bound, and whether two launches agree bit for bit; K2 held
     against the plain backward there and, at another cotangent seed, on
     image 1's two renders: >= 99.7 % of rows within 5e-3 x max |g|, each
     row outside holding a pair that can flip, and param_holds on >= 99.7
     % with the tie census; the decision pass's mask on
     all four renders, each differing bit a pair that can flip; and
     compare_given_mask on all four;
  9. sharded_path: parallel/ on a world-size-1 NCCL group
     (parallel.mesh.distributed_init): render_tile_sharded with and
     without Gaussian sharding against render on the 65,536-Gaussian
     flagship (tests/test_sharded.py's tolerances, values and gradients),
     band_render(d, 4) for d = 0..3 assembled (what 4 ranks compute), and
     SHARDED_STEPS sharded_train_steps at PipelineConfig() against as many
     plain train_steps from the same seeded state;
 10. scene_path: full_eval.full_eval on a synthetic scene of
     NeRF-synthetic's shape (scene_write: 100 hemisphere views at 800^2 as
     Blender transforms_train.json, each parsed camera's world_view within
     1e-5 of the look-at frame it was written from; ~200,000 opaque
     Gaussians on textured surfaces at SH degree 3, rendered through the
     parsed cameras with K1 into RGBA PNGs), trained on 87 views and tested
     on 13 (llffhold 8) at PerSceneConfig() with --scene_iterations
     (default 2,000 of the reference's 30,000) and the caps planned by
     the package (per_scene.fit_scene(caps="plan"), full_eval's default:
     over the alive rows at every training camera at init and every 100
     steps, and over the test cameras for the test renders; each plan's
     need and caps and the planning's seconds reported); requires no
     overflowed step and no truncated test render,
     finite parameters, a falling loss (first against last 100 steps), an
     alive count that a densification changed, a test PSNR above the init
     scene's on the same views, and exactly one K1 and one K2 launch per
     step (two decision passes) and one K1 per test render; reports each
     stage's seconds, the step split by CUDA events, KNN at 100,000
     points, the alive count per densification and the caps the fitted
     scene needs; then K1, K2 and the decision pass at the fitted scene
     and the first training camera against their plain versions run in
     f64 (versus_f64: K1 the anchor; K2 on >= 99.7 % of rows with d_stats,
     and pulled back to (v2g_mb, rgb, opa) on >= 99.7 %, to the five
     inputs on >= 99.7 % or no farther from f64 than the plain f32
     version) and timed beside their bounds; LPIPS through a seeded
     torchvision-keyed vgg16 .pt (full_eval's lpips_weights; a finite
     test_lpips is required, its value means nothing); scene_step_trace:
     utils.profiling.trace around 10 steps at the fitted scene (kernels
     and launch calls per step, host ms per step, the device's busy share,
     the top device operations); abs_ties at one such step (the L1 term's
     ties, as at the training step); band_vs_plain at the fitted render and
     first training camera in SCENE_BANDS bands (each band by versus_f64).
Then the `kernels` line, the card's name and power limit, and last the
result line.  Any failure raises, so the script exits non-zero and prints
no result; it also refuses to run without a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Callable, NamedTuple

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
PREPROCESS_TURNS = 2       # (plain, kernel, kernel, plain) timing turns
L2_FLUSH_BYTES = 256 << 20   # written before each cold launch: 5x the L2
# csrc/footprint.cu's f32 operations: a (Gaussian, view) footprint (the
# projection 40, the EWA covariance 84, the extent 15, validity 2, the pixel
# mean 8, the tile rectangle and its count 29) and, once a Gaussian, its
# rotation (30) and 3D covariance (42)
OPS_PER_FOOTPRINT = 178
OPS_PER_PLANNED_GAUSSIAN = 72
PLAN_BYTES_PER_GAUSSIAN = 40   # xyz, scaling, rotation, read once
PLAIN_PLAN_CALLS = 3           # plain version's calls a timing (~0.3 s each)
# gradient tolerance, x max |g| per column: the JAX package's own
# (tests/test_pallas_raster.py:51-53); K2's atomics reorder the sums
GRAD_TOL = 5e-3
# shares of Gaussian rows K2 must hold within GRAD_TOL, where alpha = 1/255
# flips move a few (PERF.md): the flagship, and the training step's renders
FLAGSHIP_ROWS = 0.999
TRAIN_ROWS = 0.997
# ... and the NVS render of the EDM-init predictor's merged Gaussians: the
# canonical input's Gaussians sit on the pixel rays, where num =
# |b x Md|^2 is 0 up to rounding.  With the clamp's tie halved in both
# versions the frame had 98.72 % of its rows within GRAD_TOL on an H100
# (96.80 % before), its bands 99.54-99.72 %; of the 7,558 rows outside,
# 5,167 hold a contributor whose num the two versions put on different
# sides of 0 (PERF.md).  Where the gradient is consumed (param_holds) the
# frame holds FLAGSHIP_ROWS.
NVS_ROWS = 0.98
FLIP_KINDS = ("alpha", "t", "num")   # the decisions flip_margins witnesses
# and the pairs whose alpha or normal f32 evaluation is uncertain by at
# least GRAD_TOL of its value (pair_margins' fourth row)
MARGIN_KINDS = FLIP_KINDS + ("cond",)
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
# from csrc/integrate.cu (an FMA counts 2): 43 for a pair whose alpha
# reaches 1/255 (pair_factor); 26 for one the rejection rules out
# (surely_fails: a, |a|^2, a.b, Q, the compare); 37 for one that fails
# 1/255 but escapes the rejection, which needs its ray quadratic (36) and
# a compare of val against 2 ln(255 opa), no exp, to be known to fail;
# the mesh path's bisection steps (extract_mesh's binary_steps)
INTEGRATE_TOL = 2e-5
OPS_PER_PAIR_INTEGRATE = 43
OPS_PER_REJECTED_INTEGRATE = 26
OPS_PER_FAILING_INTEGRATE = 37
# the field query's kernels (csrc/integrate.cu): the field and its second
# pass, the plan and the prep
FIELD_KERNELS = ("integrate_kernel", "combine_kernel", "plan_kernel",
                 "prep_kernel")
MESH_STEPS = 8
# the bands of band_vs_plain: the NVS render's 16 tile rows in 4 bands of
# 4, the per-scene render's 50 in 5 of 10
NVS_BANDS = 4
SCENE_BANDS = 5
BAND_TOL_TEXT = (
    "each band against the plain band: mask bits each a pair that can "
    "flip; {held}; stacked bands against the full frame's kernel render "
    "channels 0-5,7,8 1e-4, depth 5e-3; summed band gradients against the "
    f"full frame's {GRAD_TOL} x max|g| per column on >= {FLAGSHIP_ROWS} of "
    "rows")
TRAIN_BATCH = 6            # images per step; 7 need ~86.5e9 bytes (PERF.md)
# the reference yaml's tower weights (config/imagenetgs_256x256_v1.yaml)
TRAIN_W_PERCEPTUAL = 2.0
TRAIN_W_CLIP = 0.35
SHARDED_BATCH = 2          # images per sharded_path training step
SHARDED_STEPS = 2
# the sharded step against the plain one from the same state: step 1's
# losses, step 2's (after one update whose K2 atomics differ), and the
# parameters' distance after both steps over the plain run's total change
SHARDED_LOSS_RTOL = (1e-5, 1e-3)
SHARDED_PARAM_RTOL = 5e-2
TRAIN_STEPS = 5            # applied steps (tests/test_feedforward.py:64-95)
# the training step's predictor gradients through K2 against those through
# the plain compositing backward: images, and the share of each parameter
# tensor's elements that must agree
GRAD_BATCH = 2
GRAD_BATCH_WHY = (
    "2 images: the renders and loss terms of two images share the batch "
    "means, and the plain backward takes ~0.4 s for each of the 3 renders "
    "per image; the gradient is a sum over images, so more hold no new "
    "path")
STEP_GRAD_SHARE = 0.999
# phase abs_ties: a census, not a hold; tensors_over_tol counts the
# parameter tensors where the repair's gradient exceeds GRAD_TOL x max|g|
ABS_TIES_TEXT = (
    "a census: per |x| site of the step's loss the elements exactly +-0, "
    "those the term weighs and those that depend on the parameters (a "
    "pixel with a contributor, a VGG tap positive on either side); the "
    "gradient the repair adds (the vector-Jacobian product of weight/N on "
    "those ties) against the step's own, per parameter tensor, and the "
    f"tensors where it exceeds {GRAD_TOL} x max|g|")
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
    from f3d_gaus_torch.ops import rasterize as R

    s, bng = inp.statics, inp.binning
    feat = inp.feat
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


def time_kernel(inp, iters, plain_iters, held=True):
    """Kernel and plain-version times on one prepared input, whole and
    each pass alone, the bounds, the kernel-vs-plain errors (held to the
    anchor by `compare` unless `held` is False, where versus_f64 holds
    them) and the decision pass's mask against the plain mask."""
    import torch
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.ops import rasterize as R

    bng, s = inp.binning, inp.statics
    feat = inp.feat.detach()
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
    ids = bng.point_list[bng.point_list < inp.radii.shape[0]]
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
    return dict(P=int(inp.radii.shape[0]), pairs=int(bng.num_pairs),
                max_per_tile=s.max_per_tile, **work_fields(work),
                bitwise_repeatable=bitwise, ms=ms,
                decide_ms=decide_ms, composite_ms=composite_ms,
                plain_ms=plain_ms, decide_plain_ms=decide_plain_ms,
                **{k + f: v for k, b in bounds.items() for f, v in b.items()},
                **(compare(inp, exact=False) if held else {}), mask=mask_check)


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
    from f3d_gaus_torch.ops import rasterize as R

    feat, extra = inp.feat.detach(), inp.extra.detach()
    b = inp.binning
    slab = (b.point_list, b.tile_start, b.tile_count, inp.bg)
    out, aux = cuda_raster.composite_fwd(feat, *slab, inp.statics)
    aux = R.RenderAux(*aux)
    g = np.random.default_rng(seed).normal(size=tuple(out.shape))
    g[..., 7] = 0.0
    return feat, extra, slab, aux, torch.from_numpy(g.astype(np.float32)).to(
        feat.device)


def pair_errors(wfeat_c, u, v):
    """Each (pixel, pair)'s t, alpha and num from the f64 evaluation of
    the same f32 inputs (standing for the exact values) with a first-order
    bound on any f32 evaluation's error in each: wfeat_c (T, C, NFEAT)
    window features, u and v (T, PIX, 1) f64 rays.  The bound takes 6
    roundings of the sum of |terms| for each quadratic form, 3 for BB, one
    for the division, 2 ulp for expf and one for the product with the
    opacity; the normal n = (M^T M) d takes 3 roundings of the sum of
    |terms| in each component, and its unit vector that error over |n|
    plus 4 ulp.  Returns {name: (T, PIX, C)} for t, d_t, alpha, d_alpha,
    N, d_N and d_nn."""
    import torch
    from f3d_gaus_torch.ops import rasterize as R

    au, av = u.abs(), v.abs()
    ur = 2.0 ** -24                                 # f32's unit roundoff
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
    # n = (M^T M) d from AA's coefficients, as _chunk_eval un-doubles them
    rows = [(qa[0], 0.5 * qa[1], 0.5 * qa[3]), (0.5 * qa[1], qa[2], 0.5 * qa[4]),
            (0.5 * qa[3], 0.5 * qa[4], qa[5])]
    n = [r[0] * u + r[1] * v + r[2] for r in rows]
    dn2 = sum((3 * ur * (r[0].abs() * au + r[1].abs() * av + r[2].abs())) ** 2
              for r in rows)
    length = torch.sqrt(n[0] ** 2 + n[1] ** 2 + n[2] ** 2 + 1e-7)
    d_nn = torch.sqrt(dn2) / length + 4 * ur
    return {"t": t, "d_t": d_t, "alpha": alpha, "d_alpha": d_alpha, "N": N,
            "d_N": dN, "d_nn": d_nn}


def pair_margins(wfeat_c, u, v):
    """Each (pixel, pair)'s distance from a decision that two f32
    evaluations can take differently, in units of pair_errors' bound (a
    flip is possible only at <= 1): wfeat_c (T, C, NFEAT) window
    features, u and v (T, PIX, 1) f64 rays.  Returns (4, T, PIX, C)
    margins of the alpha test (where t can pass), the t test (where alpha
    can pass), the sign of num (where both can) and, there too, GRAD_TOL
    over the relative error bound of alpha or of the normal (`cond`: the
    pair's value itself is that uncertain)."""
    import numpy as np
    import torch
    from f3d_gaus_torch.ops import rasterize as R

    # the thresholds as the f32 comparisons see them
    eps_a, near = float(np.float32(R.ALPHA_EPS)), float(np.float32(R.NEAR_PLANE))
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=u.device)
    tiny = 1e-300
    e = pair_errors(wfeat_c, u, v)
    t, d_t, alpha, d_alpha = e["t"], e["d_t"], e["alpha"], e["d_alpha"]
    t_ok, a_ok = t + d_t > near, alpha + d_alpha >= eps_a
    # a test can flip the pair only where the other one can pass, the
    # clamp of num only where the pair can contribute
    rel = torch.maximum(d_alpha / alpha.clamp_min(tiny), e["d_nn"])
    return torch.stack([
        torch.where(t_ok, (alpha - eps_a).abs() / d_alpha.clamp_min(tiny), inf),
        torch.where(a_ok, (t - near).abs() / d_t.clamp_min(tiny), inf),
        torch.where(a_ok & t_ok, e["N"].abs() / e["d_N"].clamp_min(tiny),
                    inf),
        torch.where(a_ok & t_ok, GRAD_TOL / rel.clamp_min(tiny), inf)])


def alpha_error_bound(inp, mask, aux):
    """A first-order bound, per pixel, on how far an f32 evaluation of the
    compositing forward's colour, normal and alpha can lie from the exact
    one through the rounding of its alphas and normals, given the decision
    `mask` and the forward's `aux` (its contributors: the mask's bits up
    to last_pos).  Out = sum_k T_k a_k c_k + T_N bg moves by at most
    T_k (|c_k| + max(|c_i>k|, |bg|)) <= 2 cmax T_k per unit of a_k, and a
    normal by T_k a_k per unit of its own error, so the bound is
    sum_k T_k (2 cmax d_alpha_k + a_k d_nn_k), with pair_errors' d_alpha
    and d_nn, T from the f64 alphas and cmax = max(1, |bg|, the
    contributors' |rgb|) (normals and alpha have |c| <= 1).  Returns
    (num_tiles, PIX) f64."""
    import torch
    from f3d_gaus_torch.ops import rasterize as R

    s, b = inp.statics, inp.binning
    feat = inp.feat.detach()
    _, valid, wfeat, n = R._windows(feat, b.point_list, b.tile_start,
                                    b.tile_count, s)
    rays = tuple(x.double()[..., None] for x in R._tile_rays(s, feat.device))
    C = s.chunk
    T = torch.ones(rays[0].shape[:2], dtype=torch.float64, device=feat.device)
    d_a = torch.zeros_like(T)
    d_n = torch.zeros_like(T)
    cmax = torch.maximum(torch.ones_like(T), inp.bg.abs().max().double())
    with torch.no_grad():
        for ci in range(n):
            sl = slice(ci * C, (ci + 1) * C)
            pos = torch.arange(ci * C, (ci + 1) * C, device=feat.device)
            contrib = (R._unpack_window_bits(mask, b.tile_start, ci * C, C)
                       & valid[:, None, sl]
                       & (pos <= aux.last_pos[..., None].long()))
            if not bool(contrib.any()):
                continue
            e = pair_errors(wfeat[:, sl], *rays)
            a = torch.where(contrib, e["alpha"], 0.0)
            T_before = T[..., None] * R._exclusive_cumprod(1.0 - a, -1)
            d_a += torch.where(contrib, T_before * e["d_alpha"], 0.0).sum(-1)
            d_n += torch.where(contrib, T_before * a * e["d_nn"], 0.0).sum(-1)
            rgb = wfeat[:, sl, R.ROW_RGB:R.ROW_RGB + 3].abs().amax(-1).double()
            cmax = torch.maximum(cmax, torch.where(
                contrib, rgb[:, None, :], 0.0).amax(-1))
            T = T * torch.prod(1.0 - a, -1)
    return 2.0 * cmax * d_a + d_n


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
    margin <= 1.  Returns the (4, P) least margin over each Gaussian's
    walked pairs by MARGIN_KINDS (alpha, t, num, cond; inf for none) and
    the (P,) mask of the Gaussians walked at all."""
    import torch
    from f3d_gaus_torch.ops import rasterize as R

    s, b = inp.statics, inp.binning
    feat = inp.feat.detach()
    P, dev = feat.shape[0], feat.device
    C = s.chunk
    gids, valid, wfeat, n = R._windows(feat, b.point_list, b.tile_start,
                                       b.tile_count, s)
    gids = torch.where(valid, gids, P)
    K = len(MARGIN_KINDS)
    margin = torch.full((K, P + 1), float("inf"), dtype=torch.float64,
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
            m = torch.where(walked, m, inf).amin(2).reshape(K, -1)
            margin.scatter_reduce_(1, ids.expand(K, -1), m, "amin")
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
    feat = inp.feat.detach()
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


class Render(NamedTuple):
    """One render's five Gaussian inputs (means3d, scales, quats,
    opacities, shs) and prep(*five, tile_rows=None), its
    rasterize.prepare: enough to remake its feature table differentiably."""
    params: list
    prep: Callable

    def inp(self, tile_rows=None):
        return self.prep(*self.params, tile_rows=tile_rows)


def pulled_back(render, tile_rows, feat, d_feats):
    """Feature-row gradients d_feats (each (P, NFEAT)) pulled back through
    rasterize._all_features and prepare's preprocess: for each, ([d
    v2g_mb, d rgb, d opa], [d of the five inputs]) as (P, k) tensors.  The
    feature table is remade from leaves of render.params (prepare's
    inp.feat, the arguments of its _all_features taken by wrapping it) and
    must equal `feat`, the one the gradients are of.  The pull-back is in
    f32 (prepare computes in f32): an f64 gradient is rounded to f32
    first."""
    import torch
    from f3d_gaus_torch.ops import rasterize as R

    leaves = [p.detach().clone().requires_grad_() for p in render.params]
    mids, all_features = [], R._all_features

    def taken(*args):
        mids[:] = args
        return all_features(*args)
    R._all_features = taken
    try:
        with torch.enable_grad():
            remade = render.prep(*leaves, tile_rows=tile_rows).feat
    finally:
        R._all_features = all_features
    require(torch.equal(remade.detach(), feat), "the remade feature table "
            "differs from the one K2 ran on")
    out = []
    for d in d_feats:
        gs = torch.autograd.grad(remade, [*mids, *leaves], d.float(),
                                 retain_graph=True, allow_unused=True)
        gs = [torch.zeros_like(x) if g is None else g.reshape(g.shape[0], -1)
              for g, x in zip(gs, [*mids, *leaves])]
        out.append((gs[:3], gs[3:]))
    return out


def param_holds(render, tile_rows, feat, kernel, plain, min_rows):
    """K2's feature-row gradient `kernel` and the compared one `plain`
    ((d_feat, d_stats) each) pulled back (pulled_back) to (v2g_mb, rgb,
    opa), `features_in`, and to the five Gaussian inputs, `params`; each
    level held by grad_agreement to >= min_rows of its rows within
    GRAD_TOL x max|g| per column.  No witness is asked of the rows
    outside: where num = |b x Md|^2 is 0 up to rounding, its gradient
    there is 0 to first order (num is a square), so the clamp's choice
    cancels at these levels."""
    (k_in, k_par), (p_in, p_par) = pulled_back(render, tile_rows, feat,
                                               (kernel[0], plain[0]))
    res = {}
    for level, k, p in (("features_in", k_in, p_in),
                        ("params", k_par, p_par)):
        r, bad = grad_agreement(k, p)
        res[level] = {**r, "rows_outside_tol": int(bad.sum())}
        require(r["rows_within_tol"] >= min_rows, {level: res[level]})
    return res


def f64_param_holds(render, inp, args, kernel, plain, exact):
    """At the fitted per-scene render: K2's gradient `kernel`, the plain
    f32 version's `plain` and the plain version's in f64 `exact` ((d_feat,
    d_stats) each), all pulled back through the same f32 preprocess
    (pulled_back), compared at (v2g_mb, rgb, opa) and at the five inputs:
    kernel_vs_f64, plain_vs_f64 and kernel_vs_plain (grad_agreement),
    with the columns and the smallest scales of the rows outside; and the
    render's tie census."""
    import torch

    pulled = pulled_back(render, None, args[0],
                         (kernel[0], plain[0], exact[0]))
    scale_min = render.params[1].detach().amin(1)
    res = {}
    for level in (0, 1):
        name = ("features_in", "params")[level]
        res[name] = {}
        for pair, a, b in (("kernel_vs_f64", 0, 2), ("plain_vs_f64", 1, 2),
                           ("kernel_vs_plain", 0, 1)):
            r, bad = grad_agreement(pulled[a][level], pulled[b][level])
            k, p = torch.cat(pulled[a][level], 1), torch.cat(pulled[b][level], 1)
            col_bad = ((k - p).abs() > GRAD_TOL * p.abs().amax(0, keepdim=True))
            res[name][pair] = {
                **r, "rows_outside_tol": int(bad.sum()),
                "columns_outside_tol": col_bad.sum(0).tolist(),
                "outside_scale_min_quantiles": (torch.quantile(
                    scale_min[bad].float(), torch.tensor(
                        [0.0, 0.5, 1.0], device=bad.device)).tolist()
                    if bool(bad.any()) else None)}
    res["scale_min_quantiles"] = torch.quantile(
        scale_min.float(), torch.tensor([0.0, 0.01, 0.5],
                                        device=scale_min.device)).tolist()
    res["tie_census"] = tie_census(inp, args[6])[0]
    return res


def fma32(a, b, c):
    """f32 fma(a, b, c) with one rounding, through f64: a * b is exact
    there, and rounding the sum to f64 and then to f32 differs from one
    rounding only where the f64 sum lands on an f32 midpoint (about 2^-29
    of the cases)."""
    return (a.double() * b.double() + c.double()).float()


def kernel_forms(f, U, V):
    """AA and num as gof_pair.cuh:quad_aa and quad_num evaluate them (their
    FMA pattern mirrored by fma32; each other operation one f32 rounding,
    as PyTorch's): f (T, 1, C, NFEAT) window rows, U and V (T, PIX, 1)."""
    from f3d_gaus_torch.ops import rasterize as R

    qa = [f[..., R.ROW_QA + i] for i in range(6)]
    qk = [f[..., R.ROW_QK + i] for i in range(6)]
    a = fma32(qa[1], V, qa[0] * U) + qa[3]
    b = (qa[2] * V + qa[4]) * V
    AA = fma32(a, U, b) + qa[5]
    a = fma32(qk[0], U, qk[1] * V) + qk[3]
    b = fma32(qk[2], V, qk[4]) * V
    return AA, fma32(a, U, b) + qk[5]


def tie_census(inp, aux):
    """The clamps' ties on the pairs K2 walks (window position <= the
    pixel's last contributor, from K1's `aux`) and on its contributors
    (those with the decision pass's bit set): how many have num =
    |b x Md|^2 exactly 0 and below 0, and AA = |Md|^2 exactly 1e-12 and
    below it, in the plain f32 evaluation (rasterize._chunk_eval's
    roundings), in the kernel's (kernel_forms) and in both; and the
    contributors whose num the two put on different sides of 0 (sign -, 0
    or + differs: the clamp's share differs there).  Returns the counts
    and the (P,) mask of the Gaussians holding such a contributor."""
    import collections
    import numpy as np
    import torch
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.ops import rasterize as R

    s, b = inp.statics, inp.binning
    feat = inp.feat.detach()
    P, dev, C = feat.shape[0], feat.device, s.chunk
    mask = cuda_raster.decide(feat, b.point_list, b.tile_start, b.tile_count,
                              s)
    gids, valid, wfeat, n = R._windows(feat, b.point_list, b.tile_start,
                                       b.tile_count, s)
    gids = torch.where(valid, gids, P)
    u, v = R._tile_rays(s, dev)
    U, V = u[..., None], v[..., None]
    aa_lo = float(np.float32(1e-12))
    last = aux.last_pos[..., None].long()
    counts = collections.Counter()
    split = torch.zeros(P + 1, dtype=torch.bool, device=dev)
    with torch.no_grad():
        for ci in range(n):
            sl = slice(ci * C, (ci + 1) * C)
            pos = torch.arange(ci * C, (ci + 1) * C, device=dev)
            walked = valid[:, None, sl] & (pos <= last)
            if not bool(walked.any()):
                continue
            contrib = walked & R._unpack_window_bits(mask, b.tile_start,
                                                     ci * C, C)
            f = wfeat[:, sl][:, None]
            plain = (quad([f[..., R.ROW_QA + i] for i in range(6)], U, V),
                     quad([f[..., R.ROW_QK + i] for i in range(6)], U, V))
            kern = kernel_forms(f, U, V)
            for where, m in (("walked", walked), ("contrib", contrib)):
                counts[f"{where}/pairs"] += int(m.sum())
                for form, p_, k_, lo in (("AA", plain[0], kern[0], aa_lo),
                                         ("num", plain[1], kern[1], 0.0)):
                    for rel, op in (("tie", torch.eq), ("below", torch.lt)):
                        pm, km = m & op(p_, lo), m & op(k_, lo)
                        key = f"{where}/{form}_{rel}"
                        counts[key + "/plain"] += int(pm.sum())
                        counts[key + "/kernel"] += int(km.sum())
                        counts[key + "/both"] += int((pm & km).sum())
            sign_split = contrib & (torch.sign(plain[1]) != torch.sign(kern[1]))
            counts["contrib/num_sign_split"] += int(sign_split.sum())
            split[gids[:, sl][sign_split.any(1)]] = True
    res = {}
    for key, x in sorted(counts.items()):
        node = res
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = x
    split = split[:P]
    res["rows_with_num_sign_split"] = int(split.sum())
    return res, split


def held_bwd_at_params(render, tile_rows, inp, args, kernel, plain,
                       min_rows, param_rows):
    """held_bwd at min_rows, with the rows outside that hold a pair split
    across 0 counted (tie_census), and, under "at_params", param_holds at
    param_rows and the census (args: K2's arguments, K1's aux at 6)."""
    census, split = tie_census(inp, args[6])
    res = held_bwd(inp, args, kernel, plain, min_rows, split=split)
    res["at_params"] = {**param_holds(render, tile_rows, args[0], kernel,
                                      plain, param_rows),
                        "tie_census": census}
    return res


def held_bwd(inp, args, kernel, plain, min_rows, kinds=FLIP_KINDS,
             split=None):
    """grad_agreement, required: at least `min_rows` of the rows within
    GRAD_TOL and, where that is below 1, each row outside holding a pair
    whose decision of one of `kinds` (of FLIP_KINDS) can flip
    (flip_margins; the counts of MARGIN_KINDS are reported).  With `split`
    (tie_census's mask), the rows outside that hold a contributor whose
    num the kernel and the plain version put on different sides of 0 are
    counted."""
    res, bad = grad_agreement(kernel, plain)
    if split is not None:
        res["rows_outside_tol_num_sign_split"] = int((bad & split).sum())
    if min_rows < 1.0:
        by_kind, walked = flip_margins(inp, args[6])
        can_flip = by_kind <= 1.0
        any_flip = can_flip[[MARGIN_KINDS.index(k) for k in kinds]].any(0)
        res.update(
            rows_outside_tol=int(bad.sum()), witnesses=list(kinds),
            unwitnessed_rows=int((bad & ~any_flip).sum()),
            outside_tol_can_flip={k: int((bad & can_flip[i]).sum())
                                  for i, k in enumerate(MARGIN_KINDS)},
            walked_rows=int(walked.sum()),
            walked_rows_can_flip={
                **{k: int((walked & can_flip[i]).sum())
                   for i, k in enumerate(MARGIN_KINDS)},
                "any": int((walked & any_flip).sum())})
        require(res["unwitnessed_rows"] == 0, res)
    require(res["rows_within_tol"] >= min_rows, res)
    return res


def compare_bwd(inp, seed, min_rows=1.0, render=None):
    """K2 against the plain backward on one prepared input (held_bwd) and,
    given its Render, where the gradient is consumed (held_bwd_at_params,
    at min_rows)."""
    import torch
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.ops import rasterize as R

    feat, extra, slab, aux, g = bwd_inputs(inp, seed)
    args = (feat, extra, *slab, aux, g, inp.statics)
    k = cuda_raster.composite_bwd(*args)
    p = R._composite_bwd_impl(*args)
    torch.cuda.synchronize()
    if render is None:
        return held_bwd(inp, args, k, p, min_rows)
    return held_bwd_at_params(render, None, inp, args, k, p, min_rows,
                              min_rows)


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
    ka = R.RenderAux(*ka)
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


def versus_f64(inp, seed, g=None, render=None):
    """K1 and K2 against their plain versions where thin Gaussians make the
    monomial form's f32 evaluation ill-conditioned (the fitted per-scene
    scene: both f32 evaluations differ from the f64 one by up to a few
    1e-2; PERF.md).  Given the decision pass's mask, the plain versions
    run in f64 on the same f32 inputs and stand for the exact value.  K1
    must hold bench.py's anchor against it, where each value beyond
    ANCHOR_MAX_ERR must lie within its pixel's alpha_error_bound (the f32
    rounding of ill-conditioned alphas and normals can move it that far);
    K2 must hold >= TRAIN_ROWS of its rows within GRAD_TOL x max|g| of it;
    no witness is required of the rows outside, as the backward's own
    divisions by T are ill-conditioned where pixels turn opaque: how many
    of them hold a pair of each MARGIN_KINDS is reported.  Where the
    gradient is consumed (f64_param_holds, given the input's Render): at
    (v2g_mb, rgb, opa) K2 must hold >= TRAIN_ROWS of rows against f64; at
    the five inputs it must too, or be no farther from f64 than the plain
    f32 version is: its rows outside at most the plain version's plus 3
    times their square root (their count's spread).  The pull-back to
    scales and rotations multiplies a thin Gaussian's (M, b) gradient by
    about 1 / its smallest scale, so both f32 versions miss the f64 one
    on the thinnest rows (PERF.md).
    The plain f32 version's figures against f64 and the direct
    kernel-vs-plain errors (the anchor, and held_bwd's rows and witnesses)
    are reported.  With `g`, an out9 cotangent for this input in place of
    bwd_inputs' seeded one, nothing is required and the kernel's and the
    f64 version's gradients are returned too (under "grads"):
    band_vs_plain holds a frame's bands together."""
    import numpy as np
    import torch
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.ops import rasterize as R
    import torch_cases

    held = g is None
    feat, extra, slab, aux, g_seeded = bwd_inputs(inp, seed)
    g = g_seeded if held else g
    s = inp.statics
    mask = cuda_raster.decide(feat, *slab[:3], s)
    ko, ka = cuda_raster.composite_fwd(feat, *slab, s, mask=mask)
    ka = R.RenderAux(*ka)
    po, _ = R._composite_fwd_impl(feat, *slab, s, mask=mask)
    qo, _ = R._composite_fwd_impl(feat.double(), *slab[:3], slab[3].double(),
                                  s, mask=mask)
    img = [R._tiles_to_image(o, s).cpu().numpy() for o in (ko, po, qo)]
    bound = R._tiles_to_image(alpha_error_bound(inp, mask, ka)[..., None],
                              s)[0].cpu().numpy()
    ch = list(range(6)) + [7, 8]
    fwd = {"bound_max": float(bound.max()), "bound_share_above_max": float(
        (bound > ANCHOR_MAX_ERR).mean())}
    for name, a, b in (("kernel_vs_plain", 0, 1), ("kernel_vs_f64", 0, 2),
                       ("plain_vs_f64", 1, 2)):
        err, frac = torch_cases.bench_parity(img[a], img[b])
        fwd[name] = {"anchor_err": err, "anchor_frac_above_1e3": frac}
        if b == 2:
            e = np.abs(img[a][ch] - img[b][ch])
            big = e > ANCHOR_MAX_ERR
            fwd[name].update(values_above_max=int(big.sum()),
                             unwitnessed=int((big & (e > bound)).sum()))
    k64 = fwd["kernel_vs_f64"]
    require(not held or (k64["anchor_frac_above_1e3"] <= ANCHOR_SHARE
                         and k64["unwitnessed"] == 0), fwd)

    args = (feat, extra, *slab, ka, g, s)
    kb = cuda_raster.composite_bwd(*args, mask=mask)
    pb = R._composite_bwd_impl(*args, mask=mask)
    aux64 = R.RenderAux(*[a.double() if a.is_floating_point() else a
                          for a in ka])
    qb = R._composite_bwd_impl(feat.double(), extra.double(), *slab[:3],
                               slab[3].double(), aux64, g.double(), s,
                               mask=mask)
    can_flip = flip_margins(inp, ka)[0] <= 1.0
    bwd = {"plain_vs_f64": grad_agreement(pb, qb)[0]}
    for name, (k, p) in (("kernel_vs_f64", (kb, qb)),
                         ("kernel_vs_plain", (kb, pb))):
        res, bad = grad_agreement(k, p)
        res.update(rows_outside_tol=int(bad.sum()), outside_tol_can_flip={
            kind: int((bad & can_flip[i]).sum())
            for i, kind in enumerate(MARGIN_KINDS)},
            unwitnessed_rows=int((bad & ~can_flip.any(0)).sum()))
        bwd[name] = res
    require(not held or bwd["kernel_vs_f64"]["rows_within_tol"] >= TRAIN_ROWS,
            bwd["kernel_vs_f64"])
    if render is not None:
        bwd["at_params"] = at = f64_param_holds(render, inp, args, kb, pb, qb)
        fin, par = at["features_in"], at["params"]
        require(fin["kernel_vs_f64"]["rows_within_tol"] >= TRAIN_ROWS, fin)
        k_out = par["kernel_vs_f64"]["rows_outside_tol"]
        p_out = par["plain_vs_f64"]["rows_outside_tol"]
        require(par["kernel_vs_f64"]["rows_within_tol"] >= TRAIN_ROWS
                or k_out <= p_out + 3 * p_out ** 0.5, par)
    return {"fwd": fwd, "bwd": bwd, **({} if held else {"grads": (kb, qb)})}


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


def time_kernel_bwd(inp, iters, seed, held=True, render=None):
    """K2's times on one prepared input, whole and each pass alone, the
    plain backward's, the bounds, the agreement (of the gradients, held
    by held_bwd and compare_given_mask unless `held` is False, where
    versus_f64 holds them, and of the decision mask) and whether two
    launches agree bit for bit.  Given the input's Render (and `held`),
    the gradients are also held where they are consumed
    (held_bwd_at_params)."""
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
    agree = {}
    if held:
        agree = (held_bwd(inp, args, k1, plain[0], TRAIN_ROWS)
                 if render is None else held_bwd_at_params(
                     render, None, inp, args, k1, plain[0], TRAIN_ROWS,
                     TRAIN_ROWS))
        agree["given_mask"] = compare_given_mask(inp, seed, TRAIN_ROWS)
    agree["mask"] = compare_mask(inp, exact=False)

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


def gauss_render(g, cam, cfg, b=0):
    """The Render of element b of a Gaussian dict at cfg's caps."""
    import torch
    from f3d_gaus_torch.ops import rasterize as R

    shs = torch.cat([g["features_dc"][b], g["features_rest"][b]], 1)
    bg = torch.zeros(3, device=shs.device)
    return Render(
        [g["xyz"][b], g["scaling"][b], g["rotation"][b], g["opacity"][b], shs],
        lambda *five, tile_rows=None: R.prepare(
            *five, cam, bg, sh_degree=cfg.max_sh_degree,
            kernel_size=cfg.kernel_size, pair_cap=cfg.pair_cap,
            max_per_tile=cfg.max_per_tile, chunk=cfg.chunk,
            tile_rows=tile_rows))


def prepared(g, cam, cfg, b=0, tile_rows=None):
    """rasterize.prepare of element b of a Gaussian dict at cfg's caps
    (of the band tile_rows, when given)."""
    return gauss_render(g, cam, cfg, b).inp(tile_rows)


def launch_counts():
    """(K1, K2, decision pass, field query, preprocess, footprint) launches
    counted since the program's profiling.record() began (its `launches.*`
    counters)."""
    from f3d_gaus_torch.utils import profiling
    c = profiling.snapshot()["counters"]
    return tuple(c.get(f"launches.{k}", 0)
                 for k in ("fwd", "bwd", "decide", "integrate", "preprocess",
                           "footprint"))


def camera_sizes(cams):
    """The camera groups per_scene.needed_caps plans one footprint launch
    each for: the distinct sizes and fields of view of a scene's cameras."""
    return len({(c.camera.width, c.camera.height, c.camera.tan_fovx,
                 c.camera.tan_fovy) for c in cams})


def graph_counts():
    """(CUDA graphs captured, graph replays) counted since the program's
    profiling.record() began: a render stage of two or more undifferentiated
    views captures one graph a batch element and replays it for each other
    view (pipeline/renderer.py)."""
    from f3d_gaus_torch.utils import profiling
    c = profiling.snapshot()["counters"]
    return c.get("graph.captures", 0), c.get("graph.replays", 0)


def counted(fn, k1=0, k2=0, decide=0):
    """fn() counted by the program's profiling.record(), required to
    launch K1's compositing pass k1 times, K2's backward pass k2 times and
    the decision pass `decide` times."""
    import torch
    from f3d_gaus_torch.utils import profiling

    with profiling.record():
        out = fn()
        torch.cuda.synchronize()
        got = launch_counts()[:3]
    require(got == (k1, k2, decide),
            f"launches K1 / K2 / decision {got}, expected {(k1, k2, decide)}")
    return out


def band_vs_plain(case, render, n_bands, seed, per_scene=False,
                  min_rows=NVS_ROWS):
    """The frame split into n_bands bands of its tile rows, each rendered
    through the kernels with its row_off (render.inp(tile_rows) prepares
    it).
    Each band is held against the plain band render by the full frame's
    rules: the decision mask by compare_mask (each differing bit a pair
    that can flip); K1 by the anchor and K2 by held_bwd (>= min_rows of
    rows, each outside witnessed; the full frame is held so too, on the
    same cotangent) or, at the fitted per-scene scene (per_scene), both by
    versus_f64's rules taken over the bands together, as over the frame:
    the anchor's share of values above ANCHOR_ABOVE, and K2's rows within
    GRAD_TOL of the f64 version's, summed over the bands on the frame's
    cotangent cut into bands (a band that holds the frame's thinnest
    Gaussians concentrates their share, and its own largest |g| is
    smaller than the frame's).  The stacked
    bands' K1 outputs are
    held against the full frame's kernel render (channels 0-5, 7, 8 at
    1e-4, the median depth at 5e-3: tests/test_sharded.py:45-49) and the
    bands' K2 gradients, summed, on the full frame's cotangent cut into
    bands, against the full frame's (GRAD_TOL x max|g| on >= FLAGSHIP_ROWS
    of rows).  Each band's counted forward launches the decision pass and
    K1 once, its counted backward the decision pass and K2 once.  Times
    each band's K1 and K2 and the full frame's with CUDA events.  Outside
    the per-scene scene, the frame's and each band's K2 gradient is also
    held where it is consumed (held_bwd_at_params, >= FLAGSHIP_ROWS of
    rows) with its tie census."""
    import torch
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.ops import rasterize as R

    full = render.inp()
    fs = full.statics
    require(fs.grid_y % n_bands == 0, f"{fs.grid_y} rows in {n_bands} bands")
    rows = fs.grid_y // n_bands
    feat, extra, slab, _, g_full = bwd_inputs(full, seed)
    out_f, aux_f = cuda_raster.composite_fwd(feat, *slab, fs)
    aux_f = R.RenderAux(*aux_f)
    grad_f = cuda_raster.composite_bwd(feat, extra, *slab, aux_f, g_full, fs)
    times = {"full": {"k1_ms": time_ms(lambda: cuda_raster.composite_fwd(
        feat, *slab, fs), TIMED_LAUNCHES), "k2_ms": time_ms(
        lambda: cuda_raster.composite_bwd(feat, extra, *slab, aux_f, g_full,
                                          fs), TIMED_LAUNCHES),
        "pairs": int(full.binning.num_pairs)}}
    full_bwd = None
    if not per_scene:
        args = (feat, extra, *slab, aux_f, g_full, fs)
        full_bwd = held_bwd_at_params(
            render, None, full, args, grad_f, R._composite_bwd_impl(*args),
            min_rows, FLAGSHIP_ROWS)
    del full
    outs, sums, sums64, bands = [], None, None, []
    for d in range(n_bands):
        inp = render.inp((d * rows, rows))
        s, b = inp.statics, inp.binning
        require(s.row_off == d * rows and s.grid_y == rows
                and s.height == fs.height and not bool(b.overflow),
                f"band {d}: {s}")
        bf, bx, bslab, _, _ = bwd_inputs(inp, seed)
        o, a = counted(lambda: cuda_raster.composite_fwd(bf, *bslab, s),
                       k1=1, decide=1)
        a = R.RenderAux(*a)
        t0, t1 = d * rows * fs.grid_x, (d + 1) * rows * fs.grid_x
        gb = g_full[t0:t1].contiguous()
        kb = counted(lambda: cuda_raster.composite_bwd(bf, bx, *bslab, a, gb,
                                                       s), k2=1, decide=1)
        res = {"band": d, "row_off": s.row_off, "rows": rows,
               "pairs": int(b.num_pairs),
               "mask": compare_mask(inp, exact=False)}
        if per_scene:
            vs = versus_f64(inp, seed + d, g=gb)
            k64, q64 = vs.pop("grads")
            sums64 = ([k64, q64] if sums64 is None else
                      [[x + y for x, y in zip(a, b)]
                       for a, b in zip(sums64, (k64, q64))])
            res.update(fwd_vs_f64=vs["fwd"]["kernel_vs_f64"],
                       bwd_vs_f64=vs["bwd"]["kernel_vs_f64"])
            require(res["fwd_vs_f64"]["unwitnessed"] == 0, res)
        else:
            res["fwd"] = compare(inp, exact=False)
            bargs = (bf, bx, *bslab, a, gb, s)
            res["bwd"] = held_bwd_at_params(
                render, (d * rows, rows), inp, bargs, kb,
                R._composite_bwd_impl(*bargs), min_rows, FLAGSHIP_ROWS)
        res["k1_ms"] = time_ms(lambda: cuda_raster.composite_fwd(
            bf, *bslab, s), TIMED_LAUNCHES)
        res["k2_ms"] = time_ms(lambda: cuda_raster.composite_bwd(
            bf, bx, *bslab, a, gb, s), TIMED_LAUNCHES)
        outs.append(o)
        sums = list(kb) if sums is None else [x + y for x, y in zip(sums, kb)]
        bands.append(res)
        del inp, bf, bx, bslab, a, kb
    stacked = torch.cat(outs, 0)
    err = (stacked - out_f).abs().amax((0, 1))
    ch = [c for c in range(9) if c != 6]
    summed, bad = grad_agreement(sums, grad_f)
    result = {"case": case, "n_bands": n_bands, "bands": bands,
              "full_frame_bwd": full_bwd,
              "stacked_vs_full": {"max_abs_err": float(err[ch].max()),
                                  "depth_max_abs_err": float(err[6])},
              "summed_grads_vs_full": {**summed,
                                       "rows_outside_tol": int(bad.sum())},
              "times": {**times, "bands_k1_ms": [x["k1_ms"] for x in bands],
                        "bands_k2_ms": [x["k2_ms"] for x in bands]}}
    require(result["stacked_vs_full"]["max_abs_err"] <= 1e-4
            and float(err[6]) <= 5e-3, result["stacked_vs_full"])
    require(summed["rows_within_tol"] >= FLAGSHIP_ROWS,
            result["summed_grads_vs_full"])
    if per_scene:
        # the bands have equal sizes: the frame's share is their mean
        share = sum(b["fwd_vs_f64"]["anchor_frac_above_1e3"]
                    for b in bands) / n_bands
        result["fwd_vs_f64_frac_above_1e3"] = share
        require(share <= ANCHOR_SHARE, f"bands' share above "
                f"{ANCHOR_ABOVE} against f64: {share}")
        result["summed_bwd_vs_f64"] = grad_agreement(*sums64)[0]
        require(result["summed_bwd_vs_f64"]["rows_within_tol"] >= TRAIN_ROWS,
                result["summed_bwd_vs_f64"])
    return result


def render_breakdown(g, cam, cfg, reps=3):
    """Milliseconds of one render through renderer.render_gaussians, split
    into preprocess (the route rasterize.prepare takes for these inputs:
    `preprocess_route`), binning (the rest of prepare), compositing and the
    image/normal assembly after it; the card is synchronised around each
    part."""
    import torch
    from f3d_gaus_torch.core import gaussians as G
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.ops import rasterize as R
    from f3d_gaus_torch.pipeline import renderer

    shs = torch.cat([g["features_dc"][0], g["features_rest"][0]], 1)
    args = (g["xyz"][0], g["scaling"][0], g["rotation"][0], g["opacity"][0],
            shs)
    bg = torch.zeros(3, device=shs.device)
    kernel = R._kernel_preprocess(shs.device, args, None)
    preprocess = cuda_raster.preprocess if kernel else G.preprocess

    def wall(fn):
        out = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3, out

    pre_ms, _ = wall(lambda: preprocess(*(a.contiguous() for a in args),
                                        cfg.max_sh_degree, cam,
                                        cfg.kernel_size))
    prep_ms, inp = wall(lambda: R.prepare(
        *args, cam, bg, sh_degree=cfg.max_sh_degree,
        kernel_size=cfg.kernel_size, pair_cap=cfg.pair_cap,
        max_per_tile=cfg.max_per_tile, chunk=cfg.chunk))
    comp_ms, _ = wall(lambda: R.composite(inp))
    total_ms, _ = wall(lambda: renderer.render_gaussians(
        g, 0, cam.world_view, cam.full_proj, cam.cam_center, bg, cfg))
    return {"preprocess_route": "kernel" if kernel else "composed",
            "preprocess_ms": pre_ms, "binning_ms": prep_ms - pre_ms,
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
    render = Render(tc, lambda *five, tile_rows=None: R.prepare(
        *five, cam, **caps))
    inp = render.inp()
    require(not bool(inp.binning.overflow), "flagship caps overflow")
    masks.append(compare_mask(inp, exact=False))
    emit("decide_vs_plain", case="flagship_256_65536", caps=caps,
         tol="each differing bit a pair that can flip", **masks[-1])
    emit("kernel_vs_plain", case="flagship_256_65536", caps=caps,
         tol="anchor: channels 0-5,7,8 max < 2e-2, <= 0.1% above 1e-3",
         **compare(inp, exact=False))
    flag = compare_bwd(inp, seed, FLAGSHIP_ROWS, render)
    emit("kernel_vs_plain_bwd", case="flagship_256_65536", caps=caps,
         tol=f"{GRAD_TOL} x max|g| per column on >= {FLAGSHIP_ROWS} of rows, "
             "each row outside with a pair that can flip; at_params: the "
             "same on the gradients pulled back to (v2g_mb, rgb, opa) and "
             f"to the five inputs, >= {FLAGSHIP_ROWS} of rows", **flag)
    given = [compare_given_mask(inp, seed, FLAGSHIP_ROWS)]
    emit("given_mask_vs_plain", case="flagship_256_65536",
         tol=GIVEN_MASK_TOL_TEXT, **given[-1])
    torch.cuda.synchronize()
    return flag, masks, given


def bit_gaps(got, want):
    """Elements of two equal-shaped tensors that differ bit for bit (NaN
    and the sign of 0 included) and their largest gap."""
    import torch
    if got.dtype.is_floating_point:
        same = (got.contiguous().view(torch.int32)
                == want.contiguous().view(torch.int32))
    else:
        same = got == want
    gap = (got.double() - want.double()).abs()[~same]
    return {"differ": int((~same).sum()),
            "max_gap": float(gap.max()) if gap.numel() else 0.0}


def kernel_device_ms(fn, iters, name, flush=None):
    """torch.profiler's device time a call of fn in the kernels whose name
    holds `name` (all device work where `name` is None), and the kernels a
    call, over `iters` calls; with `flush`, that tensor is overwritten
    before each call, so each launch finds the L2 cold."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush.fill_(1.0)
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and (name is None or name in e.name)]
    return (sum(e.device_time_total for e in dev) / 1e3 / iters,
            len(dev) / iters)


def host_ms(fn, iters):
    """The host's milliseconds a call of fn, the card not waited for."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def preprocess_vs_plain(dev):
    """Phase preprocess_vs_plain: the preprocess kernel (cuda_raster.
    preprocess, csrc/preprocess.cu) against its plain version (rasterize.
    _preprocess_impl: the composed route, which prepare took before the
    kernel) on card tensors, at the main path's three shapes and the two
    edge clouds of tests/torch_cases.preprocess_cases: every field and
    table the kernel writes equal bit for bit, and so the binning.  At the
    three shapes, in PREPROCESS_TURNS turns of (plain, kernel, kernel,
    plain), the kernel reading its camera from a row in device memory
    staged once (as a render stage's camera table row): its device time a
    launch with the L2 flushed before each (cold_ms, the one held to the
    bound) and back to back (warm_ms),
    its CUDA-event and host times a wrapper call; the plain version's
    device time and kernels a call, its host time a call and its
    CUDA-event time a call (plain_ms: its host issues about 600 kernels one
    at a time, so the events time the host).  The bound: the bytes the
    route must read and write once (the five inputs; the two tables, the
    depth and the radius) over PEAK_BYTES_PER_S.  Returns {shape: fields}."""
    import collections
    import torch
    from f3d_gaus_torch.core import gaussians as G
    from f3d_gaus_torch.core.device import upload
    from f3d_gaus_torch.ops import binning as B
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.ops import rasterize as R
    from f3d_gaus_torch.utils import profiling
    import torch_cases

    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    shapes = {}
    for i, (name, cam, cloud, deg, ks) in enumerate(
            torch_cases.preprocess_cases()):
        t = [torch.from_numpy(a).to(dev) for a in cloud]
        with profiling.record():
            got = cuda_raster.preprocess(*t, deg, cam, ks)
            torch.cuda.synchronize()
            n = launch_counts()[4]
        require(n == 1, f"{n} preprocess launches for one call")
        with torch.no_grad():
            want = R._preprocess_impl(*t, deg, cam, ks)
            valid = int(G.preprocess(*t, deg, cam, ks).valid.sum())
        # (feat, extra, depths, radii); extra = conic | means2d
        gaps = {f: bit_gaps(a, b) for f, a, b in zip(
            ("feat", "extra", "depths", "radii"), got, want)}
        w, h = cam.width, cam.height
        cap = B.suggest_pair_cap(int(B.count_pairs(want[1][:, 3:5], want[3],
                                                   w, h)))
        got, want = (B.bin_gaussians(p[1][:, 3:5], p[3], p[2], w, h, cap)
                     for p in (got, want))
        binning_equal = all(torch.equal(getattr(got, f), getattr(want, f))
                            for f in ("point_list", "tile_start",
                                      "tile_count", "num_pairs", "overflow"))
        res = {"P": int(t[0].shape[0]), "sh_degree": deg, "width": w,
               "kernel_size": ks, "valid": valid,
               "bits_differ": sum(g["differ"] for g in gaps.values()),
               "max_gap": max(g["max_gap"] for g in gaps.values()),
               "binning_equal": binning_equal}
        require(res["bits_differ"] == 0 and binning_equal,
                {name: {k: v for k, v in gaps.items() if v["differ"]}})
        del got, want
        if i < 3:
            # the camera row in device memory, staged once, as a stage's
            # table row is
            row = upload(cuda_raster.camera_scalars(cam, ks), dev)

            def kernel():
                return cuda_raster.preprocess(*t, deg, cam, ks,
                                              camera_row=row)

            def plain():
                with torch.no_grad():
                    return R._preprocess_impl(*t, deg, cam, ks)
            turns = collections.defaultdict(list)
            for _ in range(PREPROCESS_TURNS):
                for side in ("plain", "kernel", "kernel", "plain"):
                    if side == "kernel":
                        turns["cold_ms"].append(kernel_device_ms(
                            kernel, TIMED_LAUNCHES, "preprocess_kernel",
                            flush)[0])
                        turns["warm_ms"].append(kernel_device_ms(
                            kernel, TIMED_LAUNCHES, "preprocess_kernel")[0])
                        turns["event_ms"].append(time_ms(kernel,
                                                         TIMED_LAUNCHES))
                        turns["host_ms"].append(host_ms(kernel,
                                                        TIMED_LAUNCHES))
                    else:
                        ms, kernels = kernel_device_ms(plain, TIMED_LAUNCHES,
                                                       None)
                        turns["plain_device_ms"].append(ms)
                        turns["plain_kernels"].append(kernels)
                        turns["plain_ms"].append(time_ms(plain,
                                                         TIMED_LAUNCHES))
                        turns["plain_host_ms"].append(host_ms(
                            plain, TIMED_LAUNCHES))
            k = (deg + 1) ** 2
            # reads: means, scales, quats, opacity, the (deg + 1)^2 SH
            # coefficients used; writes: the two tables, depth and radius
            nbytes = res["P"] * 4 * ((3 + 3 + 4 + 1 + 3 * k)
                                     + (R.NFEAT + 5 + 1 + 1))
            res.update({key: v for key, v in turns.items()})
            res.update(ms=statistics.median(turns["cold_ms"]),
                       plain_ms_median=statistics.median(turns["plain_ms"]),
                       **bound(0, nbytes))
            require(res["ms"] > 0, f"{name}: the profiler saw no "
                    "preprocess_kernel on the device")
            res["bound_share"] = res["bound_ms"] / res["ms"]
        shapes[name] = res
        del t
        torch.cuda.empty_cache()
    return shapes


def footprint_vs_plain(dev):
    """Phase footprint_vs_plain: the stage cap planner's kernel (cuda_raster.
    footprint_need: csrc/footprint.cu and its reduction) against its plain
    version (binning._footprint_need_impl, the chunked composition it
    replaces) on card tensors at the serving stages' shapes: the orbit's
    129 views of a 589,824-Gaussian set and the aggregation's 8 views of
    65,536 (tests/torch_cases.bench_scene clouds), 256^2.  The two counts
    equal, one counted launch a call.  In PREPROCESS_TURNS turns of
    (plain, kernel, kernel, plain): the footprint kernel's device time a
    launch with the L2 flushed before each (cold_ms, the one held to the
    bound); the whole call's device time, back to back (call_device_ms:
    the table's upload, the zeroing, both kernels, the read) and its
    CUDA-event time a call (call_ms, which the host read ends); the plain
    version's CUDA-event time a call (plain_ms: its host sets it), its
    device time and kernels a call.  The bound: OPS_PER_FOOTPRINT a
    footprint and OPS_PER_PLANNED_GAUSSIAN a Gaussian at the FP32 peak, or
    PLAN_BYTES_PER_GAUSSIAN read once at the memory rate.  Returns {shape:
    fields}."""
    import collections
    import numpy as np
    import torch
    from f3d_gaus_torch.ops import binning as B
    from f3d_gaus_torch.pipeline import config as C
    from f3d_gaus_torch.pipeline import cycle
    from f3d_gaus_torch.pipeline import dataset as D
    from f3d_gaus_torch.utils import profiling
    import torch_cases

    cfg = C.PipelineConfig()
    inv = D.canonical_cameras(cfg).inverse_first_camera
    r = cfg.resolution
    rng = np.random.default_rng(0)
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    shapes = {}
    for name, cs, n in (("orbit_589824", cycle.nvs_cameras(cfg, inv),
                         9 * 65536),
                        ("aggregation_65536",
                         cycle.aggregation_cameras(cfg, inv), 65536)):
        _, cloud = torch_cases.bench_scene(rng, n=n)
        g = [torch.from_numpy(a).to(dev)[None] for a in cloud[:3]]
        cam = cs.camera(0, r, r, cfg.tan_fov, cfg.tan_fov)
        wv, fp = cs.world_view, cs.full_proj

        def kernel():
            return B.footprint_need(*g, wv, fp, cam, cfg.kernel_size)

        def plain():
            return B._footprint_need_impl(*g, wv, fp, cam, cfg.kernel_size)
        with profiling.record():
            got = kernel()
            launches = profiling.snapshot()["counters"].get(
                "launches.footprint", 0)
        want = plain()
        require(launches == 1, f"{launches} footprint launches for one call")
        require(got == want, {name: {"kernel": got, "plain": want}})
        turns = collections.defaultdict(list)
        for _ in range(PREPROCESS_TURNS):
            for side in ("plain", "kernel", "kernel", "plain"):
                if side == "kernel":
                    turns["cold_ms"].append(kernel_device_ms(
                        kernel, TIMED_LAUNCHES, "footprint_kernel", flush)[0])
                    turns["sum_ms"].append(kernel_device_ms(
                        kernel, TIMED_LAUNCHES, "occupancy_kernel")[0])
                    ms, kernels = kernel_device_ms(kernel, TIMED_LAUNCHES,
                                                   None)
                    turns["call_device_ms"].append(ms)
                    turns["call_kernels"].append(kernels)
                    turns["call_ms"].append(time_ms(kernel, TIMED_LAUNCHES))
                else:
                    ms, kernels = kernel_device_ms(plain, PLAIN_PLAN_CALLS,
                                                   None)
                    turns["plain_device_ms"].append(ms)
                    turns["plain_kernels"].append(kernels)
                    turns["plain_ms"].append(time_ms(plain, PLAIN_PLAN_CALLS,
                                                     warmup=1))
        views = len(wv)
        res = {"P": n, "views": views, "footprints": n * views, **got,
               **{k: v for k, v in turns.items()},
               "ms": statistics.median(turns["cold_ms"]),
               "call_ms_median": statistics.median(turns["call_ms"]),
               "plain_ms_median": statistics.median(turns["plain_ms"]),
               **bound(n * views * OPS_PER_FOOTPRINT
                       + n * OPS_PER_PLANNED_GAUSSIAN,
                       n * PLAN_BYTES_PER_GAUSSIAN)}
        require(res["ms"] > 0, f"{name}: the profiler saw no "
                "footprint_kernel on the device")
        res["bound_share"] = res["bound_ms"] / res["ms"]
        shapes[name] = res
        del g
        torch.cuda.empty_cache()
    return shapes


def serving_path(args, dev, card):
    """Phases 3 and 4: run_nvs_replanned at full width, its launches
    counted inside profiling.record(), then K1's timing at its shapes."""
    import numpy as np
    import torch
    from f3d_gaus_torch.core.cameras import Camera
    from f3d_gaus_torch.models import predictor as P
    from f3d_gaus_torch.pipeline import config as C
    from f3d_gaus_torch.pipeline import cycle
    from f3d_gaus_torch.pipeline import dataset as D
    from f3d_gaus_torch.utils import profiling

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
    t0 = time.perf_counter()
    with profiling.record():
        res = cycle.run_nvs_replanned(model, cfg, cams, images, depth,
                                      device=dev, log=replans.append,
                                      timings=timings)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches, launches_bwd, launches_decide, _, launches_pre, \
            footprints = launch_counts()
        captures, replays = graph_counts()
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
    require(launches == launches_decide == launches_pre
            == (n_agg + n_nvs) * res.attempts > 0 and launches_bwd == 0,
            f"{launches} K1 / {launches_decide} decision / {launches_bwd} K2 "
            f"/ {launches_pre} preprocess launches for {res.attempts} "
            "attempts")
    require(captures == 2 * res.attempts
            and replays == (n_agg + n_nvs - 2) * res.attempts,
            f"{captures} graphs captured, {replays} replays for "
            f"{res.attempts} attempts")
    # only the first attempt plans (its two stages); a doubling reruns at
    # static caps
    require(footprints == 2,
            f"{footprints} footprint launches for {res.attempts} attempts")
    emit("main_path", card=card, config="PipelineConfig()",
         num_nvs_views=cfg.num_nvs_views, params=n_params,
         attempts=res.attempts, replans=replans,
         caps={"pair_cap": res.cfg.pair_cap,
               "max_per_tile": res.cfg.max_per_tile},
         kernel_launches=launches, decide_launches=launches_decide,
         preprocess_launches=launches_pre, graph_captures=captures,
         graph_replays=replays, footprint_launches=footprints,
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
    # fcfg holds the orbit stage's planned caps: every render timed below
    # (the first forward's set at an aggregation camera included) must fit
    inps = {"aggregation": prepared(res.first, agg_cam, fcfg),
            "nvs": prepared(res.merged, nvs_cam, fcfg)}
    for k, inp in inps.items():
        b = inp.binning
        require(not bool(b.overflow | (b.tile_count > fcfg.max_per_tile).any()),
                f"the {k} render overflows the planned caps {fcfg.pair_cap}, "
                f"{fcfg.max_per_tile}")
    shapes = {"aggregation": time_kernel(inps["aggregation"], TIMED_LAUNCHES, 3),
              "nvs": time_kernel(inps["nvs"], TIMED_LAUNCHES, 2)}
    for k, v in shapes.items():
        emit("kernel_timing", card=card, shape=k, **v)
    emit("nvs_render_breakdown", card=card,
         caps={"pair_cap": fcfg.pair_cap, "max_per_tile": fcfg.max_per_tile},
         **render_breakdown(res.merged, nvs_cam, fcfg))
    emit("nvs_render_profile", card=card,
         **profile_render(res.merged, nvs_cam, fcfg))
    bands = band_vs_plain("nvs", gauss_render(res.merged, nvs_cam, fcfg),
                          NVS_BANDS, args.seed)
    emit("band_vs_plain", card=card, tol=BAND_TOL_TEXT.format(
        held=f"K1 the anchor, K2 held_bwd on >= {NVS_ROWS} of rows (the "
             "full frame too)"), **bands)
    return ((launches, launches_decide, launches_pre, footprints), shapes,
            (n_nvs, n_agg + n_nvs), bands)


def make_towers(seed, dev):
    """VGG16 and CLIP ViT-B/32 at full width, frozen, their weights from a
    seeded torch.Generator (no pretrained file is in the repository)."""
    import torch
    from f3d_gaus_torch.models import clip as CL
    from f3d_gaus_torch.models import vgg as VG

    gen = torch.Generator().manual_seed(seed + 5)
    return {"vgg": VG.VGG16(gen).to(dev).eval().requires_grad_(False),
            "clip": CL.CLIPVisual(7, gen).to(dev).eval().requires_grad_(
                False)}


def tower_ms(towers, weights, target, iters=5):
    """Milliseconds of each tower's weighted loss term, forward and
    backward to the image, as loss_fn takes it at the training step's
    shape (a random render against `target`, (B, 3, H, W))."""
    import torch
    from f3d_gaus_torch.models import clip as CL
    from f3d_gaus_torch.models import vgg as VG

    x = torch.rand(target.shape, generator=torch.Generator(
        device=target.device).manual_seed(0), device=target.device)
    x.requires_grad_()

    def run(term):
        def step():
            x.grad = None
            term().backward()
        return time_ms(step, iters)
    return {"perceptual_ms": run(lambda: weights.w_perceptual
                                 * VG.perceptual_loss(towers["vgg"], x,
                                                      target)),
            "clip_ms": run(lambda: weights.w_clip * CL.clip_loss(
                towers["clip"], x.clamp(0.0, 1.0), target))}


def step_grads_vs_plain(state, cfg, batch, pack, weights, towers):
    """The predictor's parameter gradients of feedforward.loss_fn (the
    training step's objective, towers included) on GRAD_BATCH images of
    `batch`, from one forward through K1: backward twice through K2 (its
    own spread: the atomics' order) and once through the plain compositing
    backward (rasterize._composite_bwd_impl in place of
    cuda_raster.composite_bwd; launches counted: 3 K2 and decision passes
    per image, then none).  Each parameter tensor must hold
    >= STEP_GRAD_SHARE of its elements within max(GRAD_TOL x its largest
    plain |g|, 2 x the two K2 runs' difference there)."""
    import torch
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.ops import rasterize as R
    from f3d_gaus_torch.train import feedforward as F

    B = GRAD_BATCH
    part = {k: v[:B] for k, v in batch.items()}
    names, params = zip(*[(n, p) for n, p in state.model.named_parameters()
                          if p.requires_grad])
    loss, aux = F.loss_fn(state.model, cfg, part, pack, weights, state.step,
                          F.Curriculum(), towers)
    require(not bool(aux["overflow"].any()), "overflow in the gradient step")

    def grads():
        return torch.autograd.grad(loss, params, retain_graph=True,
                                   allow_unused=True)
    k2 = [counted(grads, k2=3 * B, decide=3 * B) for _ in range(2)]
    kernel_bwd = cuda_raster.composite_bwd
    cuda_raster.composite_bwd = R._composite_bwd_impl
    try:
        t0 = time.perf_counter()
        plain = counted(grads)
        plain_s = time.perf_counter() - t0
    finally:
        cuda_raster.composite_bwd = kernel_bwd
    per = {}
    for name, a, b, p in zip(names, *k2, plain):
        if p is None:
            continue
        require(bool(torch.isfinite(a).all()), f"finite d/d{name}")
        spread = (a - b).abs()
        tol = torch.clamp_min(2.0 * spread, GRAD_TOL * float(p.abs().max()))
        per[name] = {"share": float(((a - p).abs() <= tol).float().mean()),
                     "max_abs_err": float((a - p).abs().max()),
                     "max_abs_grad": float(p.abs().max()),
                     "k2_spread": float(spread.max())}
    worst = min(per, key=lambda n: per[n]["share"])
    res = {"batch": B, "loss": loss.item(), "tensors": len(per),
           "worst_tensor": {"name": worst, **per[worst]},
           "elements_within_tol": sum(
               x["share"] * params[names.index(n)].numel()
               for n, x in per.items()) / sum(
               params[names.index(n)].numel() for n in per),
           "k2_spread_max_rel": max(x["k2_spread"] / max(x["max_abs_grad"],
                                                        1e-30)
                                    for x in per.values()),
           "plain_backward_s": plain_s}
    require(per[worst]["share"] >= STEP_GRAD_SHARE, res)
    return res


def contributed(out):
    """(H, W) bool: the pixels of a rasterize.render output with at least
    one contributor (K1's last_pos >= 0)."""
    gx, gy = out["binning"].grid
    H, W = out["render"].shape[-2:]
    lp = out["aux"].last_pos.reshape(gy, gx, 16, 16).permute(0, 2, 1, 3)
    return (lp.reshape(gy * 16, gx * 16) >= 0)[:H, :W]


def tie_site(pieces, names, params, g_step, weight):
    """The census of one |x| site: pieces are (arg, scale, depends) with arg
    the tensor whose |.| the loss takes, scale the term's d loss / d |arg|
    (its weight over N, a mask's share; a number or a tensor that
    broadcasts) and depends a bool tensor, True where arg depends on the
    parameters at all.  Counts the elements exactly +-0, those the term
    weighs, and those of them where arg depends on the parameters; then the
    vector-Jacobian product into `params` of the cotangent that is `scale`
    on those ties and 0 elsewhere, taken through arg: the gradient that
    jnp.abs's +1 at 0 adds over torch.abs's 0.  Against the step's own
    gradient g_step, per parameter tensor: max |dg| / max |g|.  A term of
    weight 0 (the yaml's w_distortion) is counted at weight 1."""
    import numpy as np
    import torch

    ties = weighed = dependent = 0
    cots = []
    for arg, scale, dep in pieces:
        tie = arg.detach() == 0
        s = torch.as_tensor(scale, dtype=arg.dtype, device=arg.device)
        s = s.expand_as(arg)
        live = tie & (s != 0)
        ties += int(tie.sum())
        weighed += int(live.sum())
        dependent += int((live & dep.expand_as(arg)).sum())
        cots.append(torch.where(live, s, torch.zeros_like(s)))
    res = {"elements": sum(a.numel() for a, _, _ in pieces), "ties": ties,
           "ties_in_term": weighed, "ties_dependent": dependent,
           "weight": weight}
    dg = [None] * len(params)
    if weighed:
        dg = torch.autograd.grad([a for a, _, _ in pieces], params, cots,
                                 retain_graph=True, allow_unused=True)
    rel = {}
    for name, d, g in zip(names, dg, g_step):
        if g is None:
            continue
        dmax = 0.0 if d is None else float(d.abs().max())
        require(np.isfinite(dmax), f"finite tie gradient of {name}")
        rel[name] = dmax / max(float(g.abs().max()), 1e-30)
    worst = max(rel, key=rel.get)
    res.update(max_rel=rel[worst], worst_tensor=worst if rel[worst] else None,
               tensors_nonzero=sum(r > 0 for r in rel.values()),
               tensors_over_tol=sum(r > GRAD_TOL for r in rel.values()),
               tensors=len(rel))
    return res


def abs_ties_train(state, cfg, batch, pack, weights, towers):
    """Phase abs_ties at the training step of step_grads_vs_plain (its
    GRAD_BATCH images, the yaml's weights with the towers): each |x| site
    of feedforward.loss_fn, its arguments taken by wrapping losses.l1 /
    masked_l1, renderer.render_views_batched and rasterize.render (for the
    contributors) and a forward hook on the VGG16 tower for the ten taps,
    while loss_fn runs unchanged; then tie_site against the step's own
    gradient of that forward."""
    import torch
    from f3d_gaus_torch.ops import rasterize as R
    from f3d_gaus_torch.pipeline import renderer
    from f3d_gaus_torch.train import feedforward as F
    from f3d_gaus_torch.train import losses as L

    B = GRAD_BATCH
    part = {k: v[:B] for k, v in batch.items()}
    names, params = zip(*[(n, p) for n, p in state.model.named_parameters()
                          if p.requires_grad])
    rec = {"l1": [], "masked_l1": [], "views": [], "contrib": []}
    orig = (L.l1, L.masked_l1, renderer.render_views_batched, R.render)

    def l1(a, b):
        rec["l1"].append((a, b))
        return orig[0](a, b)

    def masked_l1(a, b, mask, eps=1e-6):
        rec["masked_l1"].append((a, b, mask, eps))
        return orig[1](a, b, mask, eps)

    def views_batched(g, world_views, *a, **k):
        n0 = len(rec["contrib"])
        views = orig[2](g, world_views, *a, **k)
        c = torch.stack(rec["contrib"][n0:])          # (V * B, H, W)
        c = c.reshape(len(world_views), -1, *c.shape[1:]).transpose(0, 1)
        rec["views"].append((views, c[:, :, None]))   # (B, V, 1, H, W)
        return views

    def render(*a, **k):
        out = orig[3](*a, **k)
        rec["contrib"].append(contributed(out))
        return out

    taps = []
    hook = towers["vgg"].register_forward_hook(
        lambda mod, inp, out: taps.append(out))
    L.l1, L.masked_l1, renderer.render_views_batched, R.render = (
        l1, masked_l1, views_batched, render)
    try:
        loss, aux = F.loss_fn(state.model, cfg, part, pack, weights,
                              state.step, F.Curriculum(), towers)
    finally:
        L.l1, L.masked_l1, renderer.render_views_batched, R.render = orig
        hook.remove()
    require(not bool(aux["overflow"].any()), "overflow in the census step")
    require(len(rec["l1"]) == 2 and len(rec["masked_l1"]) == 2
            and len(rec["views"]) == 2 and len(taps) == 2,
            "the census saw every site once")
    g_step = torch.autograd.grad(loss, params, retain_graph=True,
                                 allow_unused=True)
    w = weights
    (views, contrib), (cyc, cyc_contrib) = rec["views"]
    cano, novel = contrib[:, 0], contrib[:, 1]

    def mean_of(arg, wt, dep):
        return [(arg, wt / arg.numel(), dep)]

    def masked(a, b, mask, eps, wt, dep):
        m = mask.to(a.dtype).expand(torch.broadcast_shapes(
            a.shape, b.shape, mask.shape))
        return [(a - b, wt * m / (m.sum() + eps), dep)]

    depth = views["rendered_depth"][:, 0]
    dh = depth[..., 1:, :] - depth[..., :-1, :]
    dw = depth[..., :, 1:] - depth[..., :, :-1]
    fx, fy = taps
    sites = {
        "rgb": (w.w_rgb, mean_of(rec["l1"][0][0] - rec["l1"][0][1], w.w_rgb,
                                 cano)),
        "depth": (w.w_depth, masked(*rec["masked_l1"][0], w.w_depth, cano)),
        "alpha": (w.w_alpha, mean_of(views["rendered_alpha"][:, 0] - 1.0,
                                     w.w_alpha, cano)),
        "tv": (w.w_tv, mean_of(dh, w.w_tv, cano[..., 1:, :]
                               | cano[..., :-1, :])
               + mean_of(dw, w.w_tv, cano[..., :, 1:] | cano[..., :, :-1])),
        "perceptual": (w.w_perceptual, [
            (a - b, w.w_perceptual / (len(fx) * a.numel()), (a > 0) | (b > 0))
            for a, b in zip(fx, fy)]),
        "distortion": (w.w_distortion, mean_of(
            views["distortion_map"][:, 0], w.w_distortion or 1.0, cano)),
        "warping": (w.w_warping, masked(*rec["masked_l1"][1], w.w_warping,
                                        novel)),
        "cycle": (w.w_cycle, mean_of(rec["l1"][1][0] - rec["l1"][1][1],
                                     w.w_cycle, cyc_contrib[:, 0])),
    }
    out = {name: tie_site(pieces, names, params, g_step, wt)
           for name, (wt, pieces) in sites.items()}
    return {"batch": B, "loss": loss.item(), "sites": out}


def abs_ties_scene(scene, cam, target, cfg, sh_degree):
    """Phase abs_ties at the per-scene step of scene_step_trace at the
    fitted scene: the one |x| site, the L1 of per_scene._loss_fn, its
    argument recomputed from the render that _loss_fn returns."""
    import torch
    from f3d_gaus_torch.train import per_scene as PS

    dev = scene.xyz.device
    names = tuple(PS.SceneParams._fields[:-1])
    diff = [t.detach().requires_grad_() for t in tuple(scene)[:-1]]
    stats_in = torch.zeros((scene.xyz.shape[0], 3), device=dev,
                           requires_grad=True)
    loss, _, out = PS._loss_fn(diff, scene.alive, stats_in, cam, target,
                               torch.zeros(3, device=dev), cfg, sh_degree)
    require(not bool(out["overflow"]), "overflow in the census step")
    g_step = torch.autograd.grad(loss, diff, retain_graph=True)
    arg = out["render"][None] - target[None]
    wt = 1.0 - cfg.lambda_dssim
    return {"loss": loss.item(), "sites": {"l1": tie_site(
        [(arg, wt / arg.numel(), contributed(out))], names, diff, g_step,
        wt)}}


def training_path(args, dev, card):
    """Phases 7 and 8: feedforward.train_step at full width, the steps'
    launches counted inside profiling.record(), then K2's timing at the
    canonical and cycle renders of the trained weights."""
    import numpy as np
    import torch
    from f3d_gaus_torch.core.cameras import Camera
    from f3d_gaus_torch.pipeline import config as C
    from f3d_gaus_torch.pipeline import dataset as D
    from f3d_gaus_torch.pipeline import cycle, renderer
    from f3d_gaus_torch.train import feedforward as F
    from f3d_gaus_torch.utils import profiling

    cfg, B = C.PipelineConfig(), TRAIN_BATCH
    state = F.init_state(torch.Generator().manual_seed(args.seed), cfg,
                         lr=1e-4)
    towers = make_towers(args.seed, dev)
    weights = F.LossWeights(w_perceptual=TRAIN_W_PERCEPTUAL,
                            w_clip=TRAIN_W_CLIP)
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
    with profiling.record():
        t_start = time.perf_counter()
        while len(steps) < TRAIN_STEPS:
            f0, b0, d0, *_ = launch_counts()
            timings = {}
            t0 = time.perf_counter()
            try:
                loss, aux = F.train_step(state, cfg, batch, pack, weights,
                                         timings=timings, towers=towers)
            except renderer.RenderOverflow as e:
                require(len(attempts) < cycle.MAX_DOUBLINGS,
                        "caps keep overflowing")
                cfg = dataclasses.replace(cfg, pair_cap=cfg.pair_cap * 2,
                                          max_per_tile=cfg.max_per_tile * 2)
                attempts.append(f"step {state.step}: {e}; caps now "
                                f"{cfg.pair_cap} / {cfg.max_per_tile}")
                continue
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            terms = {k: v.item() for k, v in aux.items() if k != "overflow"}
            require(all(np.isfinite(v) for v in terms.values())
                    and np.isfinite(loss.item())
                    and {"loss_perceptual", "loss_clip"} <= set(terms), terms)
            require(not bool(aux["overflow"].any()),
                    "overflow in an applied step")
            k1, k2, kd, *_ = launch_counts()
            k1, k2, kd = k1 - f0, k2 - b0, kd - d0
            require(k1 == k2 == 3 * B and kd == 6 * B,
                    f"step launches K1 {k1}, K2 {k2}, decision {kd}, B {B}")
            steps.append({"loss": loss.item(), **terms, "wall_s": wall,
                          **{f"{k}_s": v for k, v in timings.items()}})
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t_start
        n = launch_counts()
        launches, pre_launches, plan_launches = n[:3], n[4], n[5]
    peak = torch.cuda.max_memory_allocated()
    require(pre_launches == 0, f"{pre_launches} preprocess kernel launches "
            "in training, whose every render is differentiated")
    require(plan_launches == 0, f"{plan_launches} footprint kernel launches "
            "in training, which plans no caps")
    require(launches == (3 * B * (len(steps) + len(attempts)),
                         3 * B * len(steps),
                         3 * B * (2 * len(steps) + len(attempts))),
            f"launches {launches}")
    moved = max(float((v.detach() - p0[k]).abs().max())
                for k, v in state.model.named_parameters())
    require(moved > 0, "parameters did not move")
    require(steps[-1]["loss"] < steps[0]["loss"],
            f"loss {steps[0]['loss']} -> {steps[-1]['loss']}")
    mean_step_s = float(np.mean([x["wall_s"] for x in steps]))
    t_ms = tower_ms(towers, weights, batch["images"].permute(0, 3, 1, 2))
    emit("train_path", card=card, config="PipelineConfig()", batch=B,
         batch_why="7 images need ~86.5e9 bytes without the towers (PERF.md)",
         loss_weights={"w_perceptual": weights.w_perceptual,
                       "w_clip": weights.w_clip},
         towers={k: {"params": sum(p.numel() for p in t.parameters()),
                     "weights": f"seeded torch.Generator (seed {args.seed} "
                                "+ 5), no pretrained file"}
                 for k, t in towers.items()},
         towers_ms=t_ms, towers_share_of_step=sum(t_ms.values()) / (
             mean_step_s * 1e3), mean_step_s=mean_step_s,
         lr=1e-4, applied_steps=len(steps), replans=attempts,
         caps={"pair_cap": cfg.pair_cap, "max_per_tile": cfg.max_per_tile},
         launches_k1=launches[0], launches_k2=launches[1],
         launches_decide=launches[2], total_s=total_s,
         peak_allocated_bytes=peak, max_param_change=moved, steps=steps)
    # two more steps, after the counted ones: where a step's time goes
    emit("train_step_profile", card=card, batch=B, **device_profile(
        lambda: F.train_step(state, cfg, batch, pack, weights,
                             towers=towers), top=15))
    torch.cuda.empty_cache()
    emit("train_grads_vs_plain", card=card, config="PipelineConfig()",
         batch_why=GRAD_BATCH_WHY,
         tol=f">= {STEP_GRAD_SHARE} of each parameter tensor's elements "
             f"within max({GRAD_TOL} x max|g|, 2 x K2's own spread)",
         **step_grads_vs_plain(state, cfg, batch, pack, weights, towers))
    torch.cuda.empty_cache()
    emit("abs_ties", card=card, step="training", config="PipelineConfig()",
         tol=ABS_TIES_TEXT, **abs_ties_train(state, cfg, batch, pack,
                                             weights, towers))
    torch.cuda.empty_cache()
    del towers

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
    shapes = {}
    for k, g in timed.items():
        r = gauss_render(g, cam, cfg)
        shapes[k] = time_kernel_bwd(r.inp(), TIMED_LAUNCHES, args.seed,
                                    render=r)
    for k, v in shapes.items():
        emit("kernel_timing_bwd", card=card, shape=k, **v)
    masks = [v["mask"] for v in shapes.values()]
    given = [v["given_mask"] for v in shapes.values()]
    for k, g in other.items():
        r = gauss_render(g, cam, cfg)
        inp = r.inp()
        emit("kernel_vs_plain_bwd", case=f"train_{k}_image1",
             tol=f"{GRAD_TOL} x max|g| per column on >= {TRAIN_ROWS} of "
                 "rows, each row outside with a pair that can flip; "
                 "at_params: the same on the gradients pulled back to "
                 f"(v2g_mb, rgb, opa) and to the five inputs, >= {TRAIN_ROWS} "
                 "of rows", **compare_bwd(inp, args.seed + 1, TRAIN_ROWS, r))
        masks.append(compare_mask(inp, exact=False))
        emit("decide_vs_plain", case=f"train_{k}_image1",
             tol="each differing bit a pair that can flip", **masks[-1])
        given.append(compare_given_mask(inp, args.seed + 1, TRAIN_ROWS))
        emit("given_mask_vs_plain", case=f"train_{k}_image1",
             tol=GIVEN_MASK_TOL_TEXT, **given[-1])
    return (*launches, plan_launches), shapes, B, masks, given


def sharded_grads(fn, cloud, w9):
    """fn(*five tensors) -> out dict; (out9, overflow, the five gradients
    of sum(out9 * w9))."""
    ts = [x.clone().requires_grad_() for x in cloud]
    out = fn(*ts)
    (out["out9"] * w9).sum().backward()
    return out["out9"].detach(), bool(out["overflow"]), [t.grad for t in ts]


def held_frame(got, want, got_g, want_g, what):
    """tests/test_sharded.py's rules: out9 channels 0-5, 7, 8 within 1e-4,
    the median depth within 5e-3, each input's gradient within GRAD_TOL x
    its largest |g|."""
    ch = [c for c in range(9) if c != 6]
    res = {"max_abs_err": float((got[ch] - want[ch]).abs().max()),
           "depth_max_abs_err": float((got[6] - want[6]).abs().max()),
           "grad_rel_err": {n: float((a - b).abs().max()) / max(
               float(b.abs().max()), 1e-30)
               for n, a, b in zip(GRAD_NAMES, got_g, want_g)}}
    require(res["max_abs_err"] <= 1e-4 and res["depth_max_abs_err"] <= 5e-3
            and max(res["grad_rel_err"].values()) <= GRAD_TOL, (what, res))
    return res


def sharded_path(args, dev, card):
    """Phase 10: parallel/ on the card.  A world-size-1 NCCL group from
    parallel.mesh.distributed_init; render_tile_sharded with and without
    Gaussian sharding against render on the 65,536-Gaussian flagship,
    values and gradients, each launching K1, K2 and the decision pass as
    one render does; band_render(d, 4) for d = 0..3 assembled (what 4 ranks
    would compute) against the same render; and SHARDED_STEPS
    sharded_train_steps at PipelineConfig() against as many plain
    train_steps from the same seeded state."""
    import shutil
    import numpy as np
    import torch
    import torch.distributed as dist
    from f3d_gaus_torch.ops import rasterize as R
    from f3d_gaus_torch.parallel import mesh as PM
    from f3d_gaus_torch.parallel import sharded as SH
    from f3d_gaus_torch.pipeline import config as C
    from f3d_gaus_torch.pipeline import cycle
    from f3d_gaus_torch.pipeline import dataset as D
    from f3d_gaus_torch.pipeline import renderer
    from f3d_gaus_torch.train import feedforward as F
    import torch_cases

    store = os.path.join(ROOT, "build", "dist_store")
    shutil.rmtree(store, ignore_errors=True)
    os.makedirs(os.path.dirname(store), exist_ok=True)
    require(PM.distributed_init(init_method=f"file://{store}", world_size=1,
                                rank=0), "distributed_init")
    backend = dist.get_backend()
    require(backend == "nccl", backend)
    try:
        cam, cloud = torch_cases.bench_scene(np.random.default_rng(args.seed))
        tc = cloud_to(cloud, dev)
        caps = R.plan_caps(*tc[:4], cam)
        bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
        w9 = np.random.default_rng(args.seed).normal(
            size=(9, cam.height, cam.width)).astype(np.float32)
        w9[6] = w9[7] = 0.0
        w9 = torch.from_numpy(w9).to(dev)
        render = counted(lambda: sharded_grads(lambda *t: R.render(
            *t, cam, bg, **caps), tc, w9), k1=1, k2=1, decide=2)
        require(not render[1], "flagship caps overflow")
        res = {"caps": caps, "P": int(tc[0].shape[0])}
        for gs in (False, True):
            got = counted(lambda: sharded_grads(
                lambda *t: SH.render_tile_sharded(
                    None, *t, cam, bg, gaussian_shard=gs, **caps), tc, w9),
                k1=1, k2=1, decide=2)
            require(not got[1], "sharded render overflow")
            res[f"gaussian_shard_{gs}"] = held_frame(
                got[0], render[0], got[2], render[2], f"sharded {gs}")
        # what 4 ranks compute, on one card
        ts = [x.clone().requires_grad_() for x in tc]
        bands = counted(lambda: [SH.band_render(
            d, 4, *ts, cam, bg, **caps) for d in range(4)], k1=4, decide=4)
        require(not any(bool(o) for _, o in bands), "band overflow")
        frame = torch.cat([b for b, _ in bands], 1)
        counted(lambda: (frame * w9).sum().backward(), k2=4, decide=4)
        res["band_render_4"] = held_frame(frame.detach(), render[0],
                                          [t.grad for t in ts], render[2],
                                          "band_render")
        del render, bands, frame, ts

        cfg = C.PipelineConfig()
        pack = F.make_cameras_pack(cfg, D.canonical_cameras(cfg), n_banks=1,
                                   views_per_bank=1)
        rng = np.random.default_rng(args.seed + 4)
        images, depths = zip(*(smooth_rgbd(rng, cfg.resolution)
                               for _ in range(SHARDED_BATCH)))
        batch = {"images": torch.from_numpy(np.concatenate(images)).to(dev),
                 "depth": torch.from_numpy(np.concatenate(depths)).to(dev)}
        states = [F.init_state(torch.Generator().manual_seed(args.seed), cfg,
                               lr=1e-4) for _ in range(2)]
        p0 = {k: v.detach().clone()
              for k, v in states[0].model.named_parameters()}
        mesh = PM.make_mesh(data=1)
        losses, replans = [], []
        while len(losses) < SHARDED_STEPS:
            step = PM.sharded_train_step(mesh, cfg)
            try:
                la, _ = step(states[0], batch, pack)
            except renderer.RenderOverflow as e:
                require(len(replans) < cycle.MAX_DOUBLINGS, "caps overflow")
                cfg = dataclasses.replace(cfg, pair_cap=cfg.pair_cap * 2,
                                          max_per_tile=cfg.max_per_tile * 2)
                replans.append(str(e))
                continue
            lb, _ = F.train_step(states[1], cfg, batch, pack)
            losses.append((la.item(), lb.item()))
        rel = [abs(a - b) / abs(b) for a, b in losses]
        with torch.no_grad():
            diff = sum(float(((a - b) ** 2).sum()) for a, b in zip(
                states[0].model.parameters(), states[1].model.parameters()))
            change = sum(float(((b - p0[k]) ** 2).sum()) for k, b in
                         states[1].model.named_parameters())
        res["train"] = {
            "batch": SHARDED_BATCH, "steps": SHARDED_STEPS,
            "mesh": {"names": mesh.mesh_dim_names,
                     "shape": list(mesh.shape)},
            "replans": replans, "losses_sharded_plain": losses,
            "loss_rel_err": rel, "param_rel_dist": (diff / change) ** 0.5,
            "tol": {"loss_rtol": SHARDED_LOSS_RTOL,
                    "param_rtol": SHARDED_PARAM_RTOL}}
        require(all(r <= t for r, t in zip(rel, SHARDED_LOSS_RTOL))
                and res["train"]["param_rel_dist"] <= SHARDED_PARAM_RTOL,
                res["train"])
        del states, p0
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    emit("sharded_path", card=card, backend=backend, world_size=1,
         tol="tests/test_sharded.py's: out9 channels 0-5,7,8 1e-4, depth "
             f"5e-3, gradients {GRAD_TOL} x max|g| per input", **res)
    # a sharded render counts as one render: K1 and K2 twice each
    return {"raster_fwd": 2 + 4, "raster_bwd": 2 + 4,
            "gof_decide": 4 + 8}


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
    view and at the bench camera under bench.py's anchor.  On each 32^2
    case also the wrapper at two slice lengths, one splitting the long
    windows (field_slices: 2e-5 in both modes, two launches equal); on
    every view here, and on torch_cases.thin_integrate_case (whose fields
    are reported, not held: its f32 quadratic is ill-conditioned), the
    rejection rules out no pair whose alpha passes (field_pair_work).
    Returns the largest error on the 32^2 cases."""
    import numpy as np
    import torch
    from f3d_gaus_torch.mesh import points as MP
    from f3d_gaus_torch.ops import integrate as TI
    from f3d_gaus_torch.ops import rasterize as R
    from f3d_gaus_torch.pipeline import config as C
    from f3d_gaus_torch.pipeline import cycle
    from f3d_gaus_torch.pipeline import dataset as D
    from f3d_gaus_torch.utils import profiling
    import torch_cases

    orbit = torch_cases.orbit_views(3)
    views = (orbit.world_view, orbit.full_proj, orbit.cam_centers)
    size = dict(width=32, height=32, tan_fovx=torch_cases.TAN,
                tan_fovy=torch_cases.TAN)
    worst = 0.0
    for name, cam, cloud, pts, kw in torch_cases.integrate_cases(seed):
        tc, tp = cloud_to(cloud, dev), torch.from_numpy(pts).to(dev)
        with profiling.record():
            k = TI.integrate_points(*tc, cam, tp, **kw)["alpha_integrated"]
            km = TI.integrate_min_alpha(*tc, *views, tp, **size, **kw)
            torch.cuda.synchronize()
            n = launch_counts()[3]
        p = TI.integrate_points(*tc, cam, tp, backend="torch",
                                **kw)["alpha_integrated"]
        pm = TI.integrate_min_alpha(*tc, *views, tp, backend="torch", **size,
                                    **kw)
        res = {"view": field_agreement(k, p),
               "min_over_3_views": field_agreement(km, pm), "launches": n}
        err = max(res["view"]["max_abs_err"],
                  res["min_over_3_views"]["max_abs_err"])
        # the wrapper at the default and at a splitting slice length, one
        # view's field and the running minimum in place, twice each
        slab, q, s = field_view(tc, cam, tp, kw)
        res["slices"] = field_slices(slab, q, s, seed)
        err = max([err] + [v["max_abs_err"] for v in res["slices"].values()])
        worst = max(worst, err)
        work = field_pair_work(slab, q, s)
        res["pair_work"] = work
        require(n == 4 and err <= INTEGRATE_TOL, res)
        require(work["rejected_passing"] == 0,
                f"the rejection ruled out a passing pair: {work}")
        require(all(v["repeat_equal"] for v in res["slices"].values()), res)
        emit("integrate_vs_plain", case=name, tol=INTEGRATE_TOL, **res)
    name, cam, cloud, pts, kw = torch_cases.thin_integrate_case(seed)
    slab, q, s = field_view(cloud_to(cloud, dev), cam,
                            torch.from_numpy(pts).to(dev), kw)
    work = field_pair_work(slab, q, s)
    require(work["rejected_passing"] == 0,
            f"the rejection ruled out a passing pair: {work}")
    emit("integrate_vs_plain", case=name, tol="the rejection only; the "
         "fields reported", pair_work=work,
         slices=field_slices(slab, q, s, seed))
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
        work = field_pair_work(*field_view(tc, c, tp, caps))
        require(work["rejected_passing"] == 0,
                f"the rejection ruled out a passing pair: {work}")
        emit("integrate_vs_plain", case=f"flagship_256_65536_{view}",
             caps=caps, tol="anchor: max < 2e-2, <= 0.1% of points above 1e-3",
             field_mean=float(k.mean()), pair_work=work, **res)
    torch.cuda.synchronize()
    return worst


def field_view(gauss, cam, points, kw):
    """One view of the field query as integrate_points takes it with
    `kw` (its caps and chunks): (the slab (v2g_mb, opa, point_list,
    tile_start, tile_count), the query rays, the statics)."""
    from f3d_gaus_torch.ops import integrate as TI

    s = TI._statics(cam, kw.get("max_per_tile", 1024), kw.get("chunk", 128),
                    kw.get("point_chunk", 1 << 14))
    pre, bng, _ = TI._prepare_view(gauss, cam, 1, 0.0,
                                   kw.get("pair_cap", 1 << 18),
                                   s.max_per_tile)
    slab = (pre.v2g_mb, pre.opa_coef, bng.point_list, bng.tile_start,
            bng.tile_count)
    return slab, TI.query_rays(points, cam, s), s


def field_slices(slab, q, s, seed):
    """The field kernel's wrapper on one view against the plain version,
    at integrate.SLICE_LEN and at torch_cases.LONG_WINDOW_SLICE (which
    splits the long windows): one view's field, and the running minimum
    written in place into a seeded field; each launched twice, whose
    fields must be equal."""
    import torch
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.ops import integrate as TI
    import torch_cases

    args = (*slab, q.u, q.v, q.depth, q.tile, q.inside, s.max_per_tile)
    plain = TI._alpha_impl(*slab, q, s)
    seeded = torch.rand(q.u.shape[0], device=q.u.device,
                        generator=torch.Generator(
                            device=q.u.device).manual_seed(seed))
    res = {}
    for L in (TI.SLICE_LEN, torch_cases.LONG_WINDOW_SLICE):
        one = [cuda_raster.integrate(*args, slice_len=L) for _ in range(2)]
        mins = [seeded.clone() for _ in range(2)]
        for m in mins:
            require(cuda_raster.integrate(*args, out=m, slice_len=L) is m,
                    "the running minimum was not written in place")
        a = field_agreement(one[0], plain)
        b = field_agreement(mins[0], torch.minimum(seeded, plain))
        res[f"slice_{L}"] = {
            "view": a, "running_min": b,
            "max_abs_err": max(a["max_abs_err"], b["max_abs_err"]),
            "repeat_equal": bool(torch.equal(*one) and torch.equal(*mins))}
    return res


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
    weights, its launches counted inside profiling.record() and
    integrate's overflow count set to 0 just before it.  Requires a
    non-empty mesh that reads back, no truncated view, 129 x (1 + 8)
    field-query launches, one K1, decision pass and preprocess launch a
    render, two footprint launches (the request's two planned stages), and
    two CUDA graphs captured an attempt (the aggregation and orbit
    stages), replayed for every other view."""
    import contextlib
    import io
    import shutil
    import numpy as np
    import torch
    from f3d_gaus_torch import cli
    from f3d_gaus_torch.io import ply
    from f3d_gaus_torch.ops import integrate as TI
    from f3d_gaus_torch.pipeline import config as C
    from f3d_gaus_torch.utils import profiling
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
    TI.overflow_views = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    with profiling.record(), contextlib.redirect_stdout(log):
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        n = launch_counts()
        captures, replays = graph_counts()
    launches = {"integrate": n[3], "raster_fwd": n[0], "gof_decide": n[2],
                "raster_bwd": n[1], "preprocess": n[4], "footprint": n[5]}
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
            and launches["raster_fwd"] == launches["gof_decide"]
            == launches["preprocess"] == n_renders
            and launches["raster_bwd"] == 0
            and launches["footprint"] == 2, launches)
    require(captures == 2 * stats["attempts"]
            and replays == n_renders - captures,
            f"{captures} graphs captured, {replays} replays for "
            f"{n_renders} renders")
    emit("mesh_path", card=card, config="PipelineConfig()",
         weights="seeded EDM init, out.bias[3] = 1.0 (opacity logit)",
         num_nvs_views=args.num_nvs_views, method=stats["method"],
         attempts=stats["attempts"],
         caps={"pair_cap": stats["pair_cap"],
               "max_per_tile": stats["max_per_tile"]},
         counts=stats["counts"], mesh_stage_s=stats["stage_s"],
         cli_wall_s=wall_s, peak_allocated_bytes=peak, launches=launches,
         graph_captures=captures, graph_replays=replays,
         overflow_views=overflow_views,
         cli_log=[ln for ln in lines if "replanning" in ln or "mesh:" in ln])
    return {"out_dir": d, "stats": stats, "launches": launches,
            "n_views": n_views}


def field_pair_work(slab, q, s):
    """The (point, pair)s the field query needs at one view: `pairs`, each
    inside point against every slot of its tile's window
    min(tile_count, max_per_tile); `passing`, those whose alpha reaches
    1/255 (integrate._pair_alpha in f32: it counts work, and PyTorch's
    roundings may differ from the kernel's by an ulp); `rejected`, those
    the kernel's shortcut rules out (its f32 mirror integrate.
    _pair_rejected on the kernel's packed rows); and `rejected_passing`,
    pairs both rejected and passing, which must be none.  Walks the
    windows as integrate._alpha_impl does."""
    import torch
    from f3d_gaus_torch.ops import integrate as TI

    v2g_mb, opa, point_list, tile_start, tile_count = slab
    P, T = v2g_mb.shape[0], tile_start.shape[0]
    table = TI._pack_rows(v2g_mb, opa)
    rows = table[:, :13]
    order = torch.argsort(torch.where(q.inside, q.tile, T), stable=True)
    n_pts = torch.bincount(q.tile[q.inside].long(), minlength=T).tolist()
    count = torch.clamp_max(tile_count, s.max_per_tile).tolist()
    start = tile_start.tolist()
    pairs, pos = 0, 0
    sums = torch.zeros(3, dtype=torch.int64, device=v2g_mb.device)
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
                    ids = ids.long().clamp(0, P)
                    passing = TI._pair_alpha(rows[ids][None], q.u[sel],
                                             q.v[sel], q.depth[sel]) > 0
                    rej = TI._pair_rejected(table[ids][None], q.u[sel],
                                            q.v[sel])
                    sums += torch.stack([passing.sum(), rej.sum(),
                                         (rej & passing).sum()])
    passing, rejected, both = sums.tolist()
    return {"pairs": pairs, "passing": passing, "rejected": rejected,
            "rejected_passing": both}


def plan_shape(tile, inside, tile_count, max_per_tile, slice_len):
    """The work of the field kernel's items at one view, first design
    against this one: lane efficiency, the inside (point, window slot)
    pairs over the pairs the lanes walk (blocks of 128 points, one a lane,
    before; now warps of 32 points, skipped where empty); and the heaviest
    item's pairs against the mean (whole windows per 128-point block
    before; now windows cut into slices of integrate.slice_rows(window,
    slice_len) rows per block of integrate.POINTS_PER_ITEM points)."""
    import torch
    from f3d_gaus_torch.ops import integrate as TI

    T = tile_count.shape[0]
    n_pts = torch.bincount(tile[inside].long(), minlength=T).double()
    window = torch.clamp_max(tile_count, max_per_tile).double()
    pairs = float((n_pts * window).sum())

    def lanes(k):
        return pairs / max(float((torch.ceil(n_pts / k) * k * window).sum()),
                           1.0)

    def items(per, sliced):
        blocks = torch.ceil(n_pts / per)
        size = torch.clamp_max(n_pts, per)
        if not sliced:
            heavy, count = size * window, blocks
        else:
            rows = TI.slice_rows(window, slice_len)
            slices = torch.clamp_min(torch.ceil(window / rows), 1)
            heavy, count = size * torch.clamp_max(window, rows), \
                blocks * slices
        n = max(float(count.sum()), 1.0)
        return {"items": int(n), "heaviest_pairs": float(heavy.max()),
                "mean_pairs": pairs / n,
                "heaviest_over_mean": float(heavy.max()) / max(pairs / n, 1)}
    return {"lane_efficiency_first_design": lanes(128),
            "lane_efficiency": lanes(32),
            "first_design_items": items(128, False),
            "items": items(TI.POINTS_PER_ITEM, True), "slice_len": slice_len}


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


def frontal_field_view(out_dir, num_nvs_views, dev):
    """The mesh run's field view in `out_dir` (cli.py's output of one
    image): (cfg, its Gaussians on the card read back from gaussians.ply,
    the NVS cameras, the frontal NVS camera, the Delaunay seed points on
    the card)."""
    import numpy as np
    import torch
    from f3d_gaus_torch.io import ply
    from f3d_gaus_torch.mesh import points as MP
    from f3d_gaus_torch.pipeline import config as C
    from f3d_gaus_torch.pipeline import cycle
    from f3d_gaus_torch.pipeline import dataset as D

    cfg = dataclasses.replace(C.PipelineConfig(), num_nvs_views=num_nvs_views)
    g = ply.read_gaussian_ply(os.path.join(out_dir, "gaussians.ply"))
    nvs = cycle.nvs_cameras(cfg, D.canonical_cameras(cfg).inverse_first_camera)
    pts, _ = MP.tetra_points(g["xyz"], g["scaling"], g["rotation"],
                             nvs.world_view, cfg.fov_deg,
                             resolution=cfg.resolution)
    res = cfg.resolution
    cam = nvs.camera(0, res, res, cfg.tan_fov, cfg.tan_fov)
    shs = np.concatenate([g["f_dc"], g["f_rest"]], 1)
    gauss = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        g["xyz"], g["scaling"], g["rotation"], g["opacity"], shs))
    return cfg, gauss, nvs, cam, torch.from_numpy(pts).to(dev)


def integrate_timing(mesh, args, dev, card):
    """Phase 6: the field query at the mesh run's shape: its first-forward
    Gaussians (read back from its gaussians.ply), its seed points, the
    frontal NVS camera and its settled caps.  The kernel (with the
    wrapper's packing and sort, and without them) by CUDA events, its
    device time alone by the profiler, the plain version, the same view's
    preprocess,
    binning and projection each alone, the agreement under bench.py's
    anchor in both modes (one view's field, and the running minimum written
    in place into a seeded field), the bound from this view's data, and
    sweep_profile: where the time of a view goes inside a sweep."""
    import torch
    from f3d_gaus_torch.core import gaussians as G
    from f3d_gaus_torch.ops import binning as B
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.ops import integrate as TI
    from f3d_gaus_torch.ops import rasterize as R

    st = mesh["stats"]
    pair_cap, mpt = st["pair_cap"], st["max_per_tile"]
    cfg, gauss, nvs, cam, tp = frontal_field_view(mesh["out_dir"],
                                                  args.num_nvs_views, dev)
    require(len(tp) == st["counts"]["seed_points"],
            f"{len(tp)} seed points, the run had {st['counts']}")
    res = cfg.resolution
    s = TI._statics(cam, mpt, cfg.chunk, 1 << 14)
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
    # the wrapper's steps, each alone: the prep kernel (rows and keys), the
    # sort, and the launch given them (plan kernel, field, second pass);
    # the prep and the plan held against their plain versions
    T = bng.tile_start.shape[0]
    prep = (pre.v2g_mb, pre.opa_coef, q.u, q.v, q.tile, q.inside, T)
    prep_ms = time_ms(lambda: cuda_raster.integrate_prep(*prep),
                      TIMED_LAUNCHES)
    table, keys = cuda_raster.integrate_prep(*prep)
    sort_ms = time_ms(lambda: torch.sort(keys), TIMED_LAUNCHES)
    keys_s, perm = torch.sort(keys)
    plan = torch.empty(3 * (T + 2) + 1, dtype=torch.int32, device=dev)
    launch = (table, keys_s, perm, bng.point_list, bng.tile_start,
              bng.tile_count, q.u, q.v, q.depth, mpt, TI.SLICE_LEN)
    launch_ms = time_ms(lambda: cuda_raster._integrate_launch(*launch),
                        TIMED_LAUNCHES)
    require(torch.equal(cuda_raster._integrate_launch(*launch, plan=plan), k)
            and torch.equal(cuda_raster.integrate(*kargs), k),
            "two launches on the same inputs differ")
    twin = TI._integrate_items(q.tile, q.inside, q.u, q.v, bng.tile_count,
                               mpt, TI.SLICE_LEN)
    require(torch.equal(keys, TI._point_keys(q.tile, q.inside, q.u, q.v, T))
            and torch.equal(plan[:-1], torch.cat([
                twin.seg_start, twin.item_start, twin.part_start])),
            "the prep or plan kernel differs from its plain version")
    rows_err = float((table - TI._pack_rows(pre.v2g_mb, pre.opa_coef)
                      ).abs().nan_to_num().max())
    require(rows_err <= 1e-5 * float(table[:, 13].abs().nan_to_num(
        posinf=0, neginf=0).max()), f"row table off by {rows_err}")
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
    # of its tile's window, charged by what it takes to settle the pair:
    # the rejection, else the quadratic and a compare where alpha fails
    # 1/255, else the whole evaluation; the bytes: the points' u, v, depth and
    # sorted index read and their field written once, the window ids and
    # the 13-float row of each Gaussian in them (tiles that hold points),
    # and the tiles' offsets, counts and segment starts
    work = field_pair_work(slab, q, s)
    require(work["rejected_passing"] == 0,
            f"the rejection ruled out a passing pair: {work}")
    pairs = work["pairs"]
    escaped = pairs - work["passing"] - work["rejected"]
    ops = (work["rejected"] * OPS_PER_REJECTED_INTEGRATE
           + escaped * OPS_PER_FAILING_INTEGRATE
           + work["passing"] * OPS_PER_PAIR_INTEGRATE)
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
                    if any(n in r["op"] for n in FIELD_KERNELS))
    require(kernel_us > 0, f"no field kernel in the profile {prof['top']}")
    sweep = sweep_profile(gauss, nvs, tp, cfg, pair_cap, mpt)
    return dict(P=int(gauss[0].shape[0]), seed_points=Q,
                inside=int(q.inside.sum()),
                occupied_tiles=int(occupied.numel()),
                caps={"pair_cap": pair_cap, "max_per_tile": mpt},
                pairs=pairs, passing_pairs=work["passing"],
                rejected_pairs=work["rejected"],
                failing_share=1 - work["passing"] / max(pairs, 1),
                rejected_share=work["rejected"] / max(pairs, 1),
                escaped_share=escaped / max(pairs, 1),
                plan_shape=plan_shape(q.tile, q.inside, bng.tile_count, mpt,
                                      TI.SLICE_LEN),
                split_tiles=int(((twin.item_start[1:] - twin.item_start[:-1])
                                 > torch.ceil((twin.seg_start[1:]
                                               - twin.seg_start[:-1])
                                              / TI.POINTS_PER_ITEM)).sum()),
                ms=ms, ms_given_prep_and_sort=launch_ms, prep_ms=prep_ms,
                sort_ms=sort_ms, kernel_device_ms=kernel_us / 1e3,
                device_ms_by_kernel={
                    next((n for n in FIELD_KERNELS if n in r["op"]),
                         r["op"][:60]): r["device_us"] / 1e3
                    for r in prof["top"]},
                plain_ms=plain_ms, alone_ms={
                    "preprocess": preprocess_ms, "binning": binning_ms,
                    "query_rays": query_rays_ms},
                wrapper_profile=prof, sweep=sweep, **bound(ops, nbytes),
                **agree, running_min=running_min)


# the per-scene path: a synthetic scene of NeRF-synthetic's shape
# (transforms_train.json, 800x800 RGBA, camera_angle_x 0.6911, cameras on
# the upper hemisphere at radius ~4.03 looking at the origin), fitted by
# full_eval from the reader's 100,000-point random init at SH degree 3
SCENE_VIEWS = 100
SCENE_RES = 800
SCENE_ANGLE_X = 0.6911
SCENE_RADIUS = 4.03
SCENE_GT = 200_000          # ground-truth Gaussians on the surfaces
SCENE_INIT = 100_000        # read_blender_scene's random init cloud
SCENE_MIN_ITERS = 1_100     # past the first SH band and 6 densifications
# fit_scene's timed stages (with planned caps)
FIT_STAGES = ("init_s", "steps_s", "surgery_s", "plan_s")
SCENE_TIMED_STEPS = 10      # steps split by CUDA events after the fit


def surface_gaussians(rng, n):
    """About n opaque (0.9) Gaussians on textured surfaces inside
    [-1, 1]^3: a checkered ground square, a sphere coloured by its normal
    and a striped box, each Gaussian a disk tangent to its surface (normal
    sigma 1/8 of the tangent one), SH degree 3 with small random higher
    bands.  Returns (means, scales, quats, opacities, shs) numpy."""
    import numpy as np
    from f3d_gaus_torch.core import cameras as CM
    from f3d_gaus_torch.core.sh import SH_C0

    def plane(m):
        xy = rng.uniform(-1, 1, size=(m, 2))
        pts = np.concatenate([xy, np.full((m, 1), -0.6)], 1)
        nrm = np.tile([0.0, 0.0, 1.0], (m, 1))
        check = (np.floor(xy[:, 0] / 0.25) + np.floor(xy[:, 1] / 0.25)) % 2
        col = np.where(check[:, None] > 0, [0.85, 0.8, 0.7], [0.2, 0.3, 0.5])
        return pts, nrm, col + 0.08 * np.sin(9 * xy[:, :1])

    def sphere(m):
        nrm = rng.normal(size=(m, 3))
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        return [0.3, -0.25, -0.1] + 0.45 * nrm, nrm, 0.5 + 0.4 * nrm

    def box(m):
        face = rng.integers(0, 6, m)
        axis, sign = face // 2, np.where(face % 2, 1.0, -1.0)
        local = rng.uniform(-1, 1, size=(m, 3))
        local[np.arange(m), axis] = sign
        nrm = np.zeros((m, 3))
        nrm[np.arange(m), axis] = sign
        stripes = 0.5 + 0.4 * np.sin(12 * local[:, [1, 2, 0]])
        return [-0.45, 0.4, -0.3] + 0.3 * local, nrm, stripes

    areas = np.array([4.0, 4 * np.pi * 0.45 ** 2, 6 * 0.6 ** 2])
    counts = np.round(n * areas / areas.sum()).astype(int)
    parts = [f(m) for f, m in zip((plane, sphere, box), counts)]
    pts, nrm, col = (np.concatenate(x).astype(np.float32) for x in zip(*parts))
    total = int(counts.sum())
    # a tangent frame per Gaussian: columns (t1, t2, n) of its rotation
    helper = np.where(np.abs(nrm[:, :1]) < 0.9, [[1.0, 0, 0]], [[0, 1.0, 0]])
    t1 = np.cross(nrm, helper)
    t1 /= np.linalg.norm(t1, axis=1, keepdims=True)
    rot = np.stack([t1, np.cross(nrm, t1), nrm], -1)
    quats = CM.rotmat_to_quat(rot).astype(np.float32)
    sigma = 0.7 * float(np.sqrt(areas.sum() / total))
    scales = np.tile(np.float32([sigma, sigma, sigma / 8]), (total, 1))
    shs = (rng.normal(size=(total, 16, 3)) * 0.03).astype(np.float32)
    shs[:, 0] = (np.clip(col, 0.02, 0.98) - 0.5) / SH_C0
    return (pts, scales, quats, np.full((total, 1), 0.9, np.float32), shs)


def hemisphere_c2w(n, radius):
    """n Blender camera-to-world matrices on the upper hemisphere (z up) at
    `radius`, elevations 10-75 degrees on a golden-angle spiral, each
    looking at the origin (OpenGL axes: -z forward, y up)."""
    import numpy as np
    out = []
    for i in range(n):
        el = np.radians(10 + 65 * (i + 0.5) / n)
        az = i * np.pi * (3 - np.sqrt(5))
        p = radius * np.array([np.cos(el) * np.cos(az),
                               np.cos(el) * np.sin(az), np.sin(el)])
        f = -p / np.linalg.norm(p)
        r = np.cross(f, [0.0, 0.0, 1.0])
        r /= np.linalg.norm(r)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([r, np.cross(r, f), -f], 1)
        c2w[:3, 3] = p
        out.append(c2w)
    return out


def write_scene(root, rng, dev):
    """The synthetic scene on disk: transforms_train.json, then the
    ground truth rendered through the PARSED cameras (with K1) and written
    as RGBA PNGs, alpha = rendered_alpha and the colour un-premultiplied
    (NeRF-synthetic's layout; the reader composites it on black again).
    Requires each parsed camera's world_view within 1e-5 of the one built
    here from the look-at frame.  Returns a summary."""
    import numpy as np
    import torch
    from PIL import Image
    from f3d_gaus_torch.ops import rasterize as R
    from f3d_gaus_torch.pipeline import scene_io

    t0 = time.perf_counter()
    c2ws = hemisphere_c2w(SCENE_VIEWS, SCENE_RADIUS)
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    frames = [{"file_path": f"./train/r_{i}", "transform_matrix": c.tolist()}
              for i, c in enumerate(c2ws)]
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": SCENE_ANGLE_X, "frames": frames}, f)
    # before the images exist the reader takes NeRF-synthetic's 800x800
    parsed = scene_io.read_blender_scene(root, n_init_points=1)
    wv_err = 0.0
    for c2w, sc in zip(c2ws, parsed.cameras):
        # world -> camera in OpenCV axes (x right, y down, z forward)
        rows = np.stack([c2w[:3, 0], -c2w[:3, 1], -c2w[:3, 2]])
        w2c = np.eye(4)
        w2c[:3, :3], w2c[:3, 3] = rows, -rows @ c2w[:3, 3]
        wv_err = max(wv_err, float(np.abs(sc.camera.world_view - w2c.T).max()))
    require(wv_err <= 1e-5, f"parsed world_view off by {wv_err}")

    gt = cloud_to(surface_gaussians(rng, SCENE_GT), dev)
    bg = torch.zeros(3, device=dev)
    pairs, alpha_mean = [], []
    for i, sc in enumerate(parsed.cameras):
        cam = sc.camera._replace(width=SCENE_RES, height=SCENE_RES)
        caps = R.plan_caps(*gt[:4], cam)
        with torch.no_grad():
            out = R.render(*gt, cam, bg, sh_degree=3, **caps)
        require(not bool(out["overflow"]), f"ground-truth view {i} truncated")
        a = out["rendered_alpha"]
        rgb = torch.where(a > 0, out["render"] / a.clamp_min(1e-6), 0.0)
        rgba = torch.cat([rgb, a]).clamp(0, 1).permute(1, 2, 0)
        Image.fromarray((rgba * 255).round().byte().cpu().numpy(), "RGBA"
                        ).save(os.path.join(root, f"train/r_{i}.png"),
                               compress_level=1)
        pairs.append(int(out["binning"].num_pairs))
        alpha_mean.append(float(a.mean()))
    return {"views": SCENE_VIEWS, "resolution": SCENE_RES,
            "gt_gaussians": int(gt[0].shape[0]), "world_view_max_err": wv_err,
            "gt_pairs_max": max(pairs), "alpha_mean": float(np.mean(
                alpha_mean)), "write_s": time.perf_counter() - t0}


def scene_render(scene, cam, cfg):
    """The Render of the trained scene at one camera, as the test renders
    take it (SH degree cfg.sh_degree, dead rows culled)."""
    import torch
    from f3d_gaus_torch.ops import rasterize as R
    from f3d_gaus_torch.train import per_scene as PS

    g = PS.activated(scene)
    bg = torch.zeros(3, device=scene.xyz.device)
    return Render(
        [g["xyz"], g["scaling"], g["rotation"], g["opacity"], g["shs"]],
        lambda *five, tile_rows=None: R.prepare(
            *five, cam, bg, sh_degree=cfg.sh_degree, pair_cap=cfg.pair_cap,
            max_per_tile=cfg.max_per_tile, chunk=cfg.chunk, mask=scene.alive,
            tile_rows=tile_rows))


def step_trace(step, logdir, n_steps=SCENE_TIMED_STEPS):
    """utils.profiling.trace around n_steps calls of step(i) (warmed up by
    one before): per step the kernels the device ran and the kernel-launch
    calls the host made, the host's seconds, the device's busy share of
    the window, and the operations with the most device time."""
    import torch
    from f3d_gaus_torch.utils import profiling

    step(0)
    torch.cuda.synchronize()
    with profiling.trace(logdir) as prof:
        t0 = time.perf_counter()
        for i in range(n_steps):
            step(i)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    ka = prof.key_averages()
    rows = sorted(((e.key, e.self_device_time_total, e.count) for e in ka
                   if str(e.device_type).endswith("CUDA")
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    kernels = sum(c for k, _, c in rows
                  if not k.startswith(("Memcpy", "Memset")))
    calls = sum(e.count for e in ka if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
        "cuLaunchKernelEx"))
    busy_s = sum(r[1] for r in rows) / 1e6
    return {"steps": n_steps, "host_ms_per_step": wall_s / n_steps * 1e3,
            "kernels_per_step": kernels / n_steps,
            "launch_calls_per_step": calls / n_steps,
            "device_busy_ms_per_step": busy_s / n_steps * 1e3,
            "device_busy_share": busy_s / wall_s,
            "top": [{"op": k[:80], "device_us": t, "calls": c}
                    for k, t, c in rows[:15]],
            "trace": os.path.relpath(os.path.join(logdir, "trace.json"),
                                     ROOT)}


def scene_path(args, dev, card):
    """Phase 9: full_eval.full_eval on a synthetic NeRF-synthetic-shaped
    scene at PerSceneConfig() with args.scene_iterations and planned caps,
    its launches counted inside profiling.record(); then the fitted scene's
    step split, the init scene's PSNR on the test views, and K1 / K2 /
    the decision pass against their plain versions at the fitted scene
    and one training camera."""
    import shutil
    import numpy as np
    import torch
    from f3d_gaus_torch import eval as EV
    from f3d_gaus_torch import full_eval as FE
    from f3d_gaus_torch.models import vgg as VG
    from f3d_gaus_torch.ops import knn
    from f3d_gaus_torch.pipeline import scene_io
    from f3d_gaus_torch.train import per_scene as PS
    from f3d_gaus_torch.utils import profiling

    require(args.scene_iterations >= SCENE_MIN_ITERS,
            f"--scene_iterations below {SCENE_MIN_ITERS}")
    work = os.path.join(ROOT, "build", "scene_smoke")
    shutil.rmtree(work, ignore_errors=True)
    root = os.path.join(work, "synthetic")
    torch.cuda.empty_cache()
    written = write_scene(root, np.random.default_rng(args.seed + 3), dev)
    emit("scene_write", card=card, **written)

    t0 = time.perf_counter()
    data = scene_io.read_blender_scene(root, load_images=True,
                                       n_init_points=SCENE_INIT)
    load_s = time.perf_counter() - t0
    pts = torch.from_numpy(data.points).to(dev)
    knn.mean_dist3(pts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    knn.mean_dist3(pts)
    torch.cuda.synchronize()
    knn_s = time.perf_counter() - t0
    # the reference's defaults but for the iterations; full_eval plans the
    # caps (fit_scene(caps="plan"))
    cfg = PS.PerSceneConfig()._replace(iterations=args.scene_iterations)
    train_cams, test_cams = FE._split(data.cameras, True)

    # the fit's scene and history, taken from full_eval's own call
    fits, fit = [], PS.fit_scene

    def fit_and_keep(*a, **k):
        timings = {}
        fits.append((*fit(*a, **k, timings=timings), timings))
        return fits[-1][:2]

    out = os.path.join(work, "out")
    # LPIPS through a seeded torchvision-keyed vgg16 state_dict: the path
    # runs, the score means nothing (no pretrained file is in the repo)
    vgg_pt = os.path.join(work, "vgg16_seeded.pt")
    torch.save(VG.VGG16(torch.Generator().manual_seed(args.seed + 6))
               .state_dict(), vgg_pt)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    PS.fit_scene = fit_and_keep
    t0 = time.perf_counter()
    try:
        with profiling.record():
            agg = FE.full_eval([root], out, cfg=cfg,
                               n_init_points=SCENE_INIT,
                               lpips_weights=vgg_pt, device=dev)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            n = launch_counts()
            launches, plan_launches = n[:3], n[5]
    finally:
        PS.fit_scene = fit
    peak = torch.cuda.max_memory_allocated()
    scene, hist, timings = fits[0]
    summary = agg["scenes"][0]
    caps = {k: hist["caps"][-1][k] for k in ("pair_cap", "max_per_tile")}
    cfg = cfg._replace(**caps)

    n_it, n_test = cfg.iterations, len(test_cams)
    loss, w = hist["step_loss"], min(100, n_it // 2)
    first, last = float(np.mean(loss[:w])), float(np.mean(loss[-w:]))
    alive = [SCENE_INIT] + [d["alive"] for d in hist["densify"]]

    # the init scene on the same test views, through the same metric: at
    # caps planned for it at those views, which truncate none of its
    # renders, and at the config's fixed caps (the JAX package's)
    init = PS.init_scene(data.points, data.colors, cfg, device=dev)
    init_caps = PS.plan_caps(PS.needed_caps(
        init, [sc.camera for sc in test_cams], cfg), PS.PerSceneConfig())
    init_scores = {}
    for name, rcfg in (("planned", cfg._replace(**init_caps)),
                       ("fixed", PS.PerSceneConfig())):
        rdir = os.path.join(work, f"init_renders_{name}")
        os.makedirs(rdir)
        truncated = 0
        for sc in test_cams:
            with torch.no_grad():
                r = PS.render_scene(init, sc.camera, rcfg,
                                    torch.zeros(3, device=dev), cfg.sh_degree)
            truncated += int(r["overflow"])
            FE._save_png(os.path.join(rdir, os.path.splitext(sc.name)[0]
                                      + ".png"), r["render"].cpu().numpy())
        init_scores[name] = {
            **EV.evaluate_dirs(rdir, os.path.join(out, "synthetic", "test",
                                                  "gt"), device=dev)["mean"],
            "truncated_renders": truncated,
            "caps": {k: getattr(rcfg, k) for k in ("pair_cap",
                                                   "max_per_tile")}}
    init_m = init_scores["planned"]
    require(init_m["truncated_renders"] == 0, f"init renders {init_scores}")
    del init

    # the step split at the fitted scene (the counted run is over)
    opt, stats = PS.init_adam(scene), PS.init_stats(scene)
    targets = torch.from_numpy(np.stack([np.transpose(c.image, (2, 0, 1))
                                         for c in train_cams[:4]])).to(dev)
    split = []

    def step(i, t=None):
        nonlocal opt, stats
        cam = train_cams[i % 4].camera
        _, opt, stats, _ = PS.train_step(
            scene, opt, stats, (cam.world_view, cam.full_proj,
                                cam.cam_center),
            targets[i % 4], torch.zeros(3, device=dev), cfg,
            min(n_it // cfg.sh_degree_interval, cfg.sh_degree),
            (cam.width, cam.height, cam.tan_fovx, cam.tan_fovy), timings=t)
    for i in range(SCENE_TIMED_STEPS + 2):
        t = {}
        step(i, t)
        if i >= 2:
            split.append(t)
    emit("scene_step_trace", card=card, **step_trace(
        step, os.path.join(work, "trace")))
    emit("abs_ties", card=card, step="per_scene", config="PerSceneConfig()",
         tol=ABS_TIES_TEXT, **abs_ties_scene(
             scene, train_cams[0].camera, targets[0], cfg,
             min(n_it // cfg.sh_degree_interval, cfg.sh_degree)))
    del opt, stats, targets
    step_ms = {k: float(np.median([t[k] for t in split]))
               for k in ("forward", "backward", "adam")}
    step_ms["step"] = float(np.median([sum(t.values()) for t in split]))

    # the caps the fitted scene needs at the training cameras
    need = PS.needed_caps(scene, [sc.camera for sc in train_cams], cfg)
    emit("scene_path", card=card, config="PerSceneConfig()",
         reduced={"iterations": f"{n_it} of the reference's 30,000",
                  "opacity_reset": "the first (iteration 3,000) is not "
                                   "reached; reset_opacity is held on the "
                                   "CPU (tests/test_torch_per_scene.py)"},
         scene={"views": SCENE_VIEWS, "train": len(train_cams),
                "test": n_test, "resolution": SCENE_RES,
                "init_points": SCENE_INIT, "sh_degree": cfg.sh_degree,
                "extent": data.extent},
         caps_plans=hist["caps"], caps_last=caps,
         caps_needed_trained=need,
         plan_s=summary["plan_s"], plan_share_of_steps=(
             timings["plan_s"] / timings["steps_s"]),
         stage_s={"scene_load_alone": load_s, **{
             k: timings[k] for k in FIT_STAGES},
             "test_render_and_metrics": wall_s - sum(
                 timings[k] for k in FIT_STAGES)},
         full_eval_wall_s=wall_s, knn_s=knn_s, knn_points=SCENE_INIT,
         mean_step_ms=timings["steps_s"] / n_it * 1e3,
         median_step_ms_split=step_ms, timed_steps=SCENE_TIMED_STEPS,
         alive_per_densification=hist["densify"],
         loss_first_100=first, loss_last_100=last,
         test_psnr=summary["test_psnr"], test_ssim=summary["test_ssim"],
         test_lpips=summary.get("test_lpips"),
         test_lpips_note="seeded random VGG16 weights: the LPIPS path runs, "
                         "the score means nothing",
         init_psnr=init_m["psnr"], init_ssim=init_m["ssim"],
         init_scene_by_caps=init_scores,
         overflow_steps=hist["overflow_steps"],
         overflow_test_renders=summary["overflow_test_renders"],
         final_gaussians=summary["final_gaussians"],
         peak_allocated_bytes=peak,
         launches={"raster_fwd": launches[0], "raster_bwd": launches[1],
                   "gof_decide": launches[2], "footprint": plan_launches})
    require(launches == (n_it + n_test, n_it, 2 * n_it + n_test),
            f"per-scene launches K1 / K2 / decision {launches}")
    # needed_caps launches once a camera size: at each of the fit's plans
    # over the training cameras, and once for the test renders
    plans = (len(hist["caps"]) * camera_sizes(train_cams)
             + camera_sizes(test_cams))
    require(plan_launches == plans, f"{plan_launches} footprint launches "
            f"for {len(hist['caps'])} fit plans and the test renders' "
            f"({plans} camera groups)")
    require(hist["overflow_steps"] == 0 and summary["overflow_steps"] == 0,
            f"{hist['overflow_steps']} steps truncated by the caps "
            f"{hist['caps']}")
    require(summary["overflow_test_renders"] == 0,
            f"{summary['overflow_test_renders']} test renders truncated")
    require(len(hist["caps"]) == 1 + (n_it - 1) // cfg.densification_interval,
            f"{len(hist['caps'])} cap plans in {n_it} iterations")
    require(all(bool(torch.isfinite(t).all()) for t in scene[:-1]),
            "non-finite parameters")
    require(last < first, f"loss {first} -> {last}")
    require(len(set(alive)) > 1, f"alive counts {alive}")
    require(np.isfinite(summary.get("test_lpips", np.nan)),
            f"test LPIPS {summary.get('test_lpips')}")
    require(summary["test_psnr"] > init_m["psnr"],
            f"test PSNR {summary['test_psnr']} <= init {init_m['psnr']}")

    # K1, K2 and the decision pass at the fitted scene, first training view
    render = scene_render(scene, train_cams[0].camera, cfg)
    inp = render.inp()
    require(not bool(inp.binning.overflow), "fitted scene's caps overflow")
    torch.cuda.empty_cache()
    vs = versus_f64(inp, args.seed + 2, render=render)
    emit("kernel_vs_f64", case=f"per_scene_{SCENE_RES}", caps=caps,
         tol=f"given the decision mask, against the plain version in f64: "
             f"K1 <= {ANCHOR_SHARE} of values above {ANCHOR_ABOVE}, each "
             f"value above {ANCHOR_MAX_ERR} within its pixel's f32 error "
             f"bound (alpha_error_bound); K2 {GRAD_TOL} x max|g| per column "
             f"on >= {TRAIN_ROWS} of rows; at_params: pulled back to "
             f"(v2g_mb, rgb, opa) >= {TRAIN_ROWS} of rows against f64, to "
             f"the five inputs >= {TRAIN_ROWS} or no more rows outside than "
             "the plain f32 version's plus 3 sqrt of them", **vs)
    fwd = time_kernel(inp, TIMED_LAUNCHES, 1, held=False)
    fwd.update(vs["fwd"]["kernel_vs_plain"])
    emit("kernel_timing", card=card, shape="per_scene", **fwd)
    bwd = time_kernel_bwd(inp, TIMED_LAUNCHES, args.seed, held=False)
    bwd.update(vs["bwd"]["kernel_vs_plain"])
    emit("kernel_timing_bwd", card=card, shape="per_scene", **bwd)
    del inp
    torch.cuda.empty_cache()
    bands = band_vs_plain("per_scene", render, SCENE_BANDS, args.seed + 2,
                          per_scene=True)
    emit("band_vs_plain", card=card, tol=BAND_TOL_TEXT.format(
        held=f"K1 and K2 by versus_f64 over the bands together (K1 the "
             f"anchor against f64, its share of values above {ANCHOR_ABOVE} "
             f"over all bands; the bands' summed K2 >= {TRAIN_ROWS} of rows "
             "within tolerance of their summed f64 gradients)"), **bands)
    return (*launches, plan_launches), fwd, bwd, bands



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num_nvs_views", type=int, default=128)
    ap.add_argument("--scene_iterations", type=int, default=2000)
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
    pre_shapes = preprocess_vs_plain(dev)
    for name, res in pre_shapes.items():
        emit("preprocess_vs_plain", card=card, case=name,
             tol="equal bit for bit, and the binning", **res)
    plan_shapes = footprint_vs_plain(dev)
    for name, res in plan_shapes.items():
        emit("footprint_vs_plain", card=card, case=name,
             tol="the two counts equal", **res)
    (serve_k1, serve_decide, serve_pre, serve_plan), fwd_shapes, \
        (n_nvs, n_render), nvs_bands = serving_path(args, dev, card)
    masks += [v["mask"] for v in fwd_shapes.values()]
    mesh = mesh_path(args, dev, card)
    field = integrate_timing(mesh, args, dev, card)
    emit("integrate_timing", card=card, view="frontal NVS camera", **field)
    mesh_k1 = mesh["launches"]["raster_fwd"]
    (train_k1, train_k2, train_decide, train_plan), bwd_shapes, B, \
        train_masks, train_given = training_path(args, dev, card)
    masks += train_masks
    given += train_given
    sharded = sharded_path(args, dev, card)
    (scene_k1, scene_k2, scene_decide, scene_plan), scene_fwd, scene_bwd, \
        scene_bands = scene_path(args, dev, card)
    masks += [scene_fwd["mask"], scene_bwd["mask"]]
    bands = {"nvs": nvs_bands, "per_scene": scene_bands}
    masks += [b["mask"] for x in bands.values() for b in x["bands"]]
    n_bands = sum(x["n_bands"] for x in bands.values())
    band_times = {k: {f: x["times"][f] for f in (
        "full", "bands_k1_ms", "bands_k2_ms")} for k, x in bands.items()}
    fwd_shapes["per_scene"] = scene_fwd
    bwd_shapes["per_scene"] = scene_bwd

    nvs, cano = fwd_shapes["nvs"], bwd_shapes["canonical"]
    pre = pre_shapes["orbit_589824"]
    plan = plan_shapes["orbit_589824"]
    given_note = (f"; given the decision pass's mask, on {len(given)} inputs "
                  "(flagship, 4 training renders; the per-scene render is "
                  "held against the plain version in f64, phase "
                  "kernel_vs_f64)")
    csrc = "f3d_gaus_torch/csrc/"
    kernels = [{
        "name": "raster_fwd", "route": "cuda",
        "source": csrc + "raster_fwd.cu",
        "sources": [csrc + f for f in ("gof_decide.cu", "raster_fwd.cu",
                                       "gof_pair.cuh")],
        "replaces": "f3d_gaus_tpu/ops/pallas_raster.py:230",
        "launches": (serve_k1 + train_k1 + mesh_k1 + scene_k1 + n_bands
                     + sharded["raster_fwd"]),
        "launches_by_path": {"serving": serve_k1, "training": train_k1,
                             "mesh": mesh_k1, "per_scene": scene_k1,
                             "bands": n_bands,
                             "sharded": sharded["raster_fwd"]},
        "band_times": {k: {"full_ms": v["full"]["k1_ms"],
                           "bands_ms": v["bands_k1_ms"]}
                       for k, v in band_times.items()},
        "max_abs_err": nvs["anchor_err"],
        "ms": nvs["ms"], "plain_ms": nvs["plain_ms"],
        "bound_ms": nvs["bound_ms"], "bound_by": nvs["bound_by"],
        "library_ms": None,
        "at": f"NVS render, P={nvs['P']} ({n_nvs} of {n_render} serving "
              f"launches per attempt; {3 * B} per training step; 1 per "
              "per-scene step and test render); ms is "
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
        "launches": train_k2 + scene_k2 + n_bands + sharded["raster_bwd"],
        "launches_by_path": {"serving": 0, "training": train_k2, "mesh": 0,
                             "per_scene": scene_k2, "bands": n_bands,
                             "sharded": sharded["raster_bwd"]},
        "band_times": {k: {"full_ms": v["full"]["k2_ms"],
                           "bands_ms": v["bands_k2_ms"]}
                       for k, v in band_times.items()},
        "max_abs_err": cano["max_abs_err"],
        "ms": cano["ms"], "plain_ms": cano["plain_ms"],
        "bound_ms": cano["bound_ms"], "bound_by": cano["bound_by"],
        "library_ms": None,
        "at": f"canonical training render, P={cano['P']} ({B} of {3 * B} "
              "launches per training step; 1 per per-scene step); ms is "
              "the decision pass and "
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
        "launches": (serve_decide + train_decide + mesh_k1 + scene_decide
                     + 2 * n_bands + sharded["gof_decide"]),
        "launches_by_path": {"serving": serve_decide,
                             "training": train_decide, "mesh": mesh_k1,
                             "per_scene": scene_decide, "bands": 2 * n_bands,
                             "sharded": sharded["gof_decide"]},
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
                   for k, v in {**bwd_shapes, **fwd_shapes}.items()},
    }, {
        "name": "integrate", "route": "cuda",
        "source": csrc + "integrate.cu",
        "sources": [csrc + "integrate.cu", csrc + "gof_pair.cuh"],
        "replaces": "f3d_gaus_tpu/ops/integrate.py:82",
        "launches": mesh["launches"]["integrate"],
        "launches_by_path": {"serving": 0, "training": 0,
                             "mesh": mesh["launches"]["integrate"],
                             "per_scene": 0, "bands": 0, "sharded": 0},
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
              "ms includes the wrapper's row packing and its sort of the "
              "points into the item plan (ms_given_prep_and_sort: the "
              "launch of the plan, the field and its second pass given "
              "them; kernel_device_ms: the field query's kernels on the "
              "device's clock); max_abs_err at that "
              "view against the plain version, one view's field and the "
              "running minimum into a seeded field (on the 32^2 cases "
              f"{integrate_small_err:.3g} at two slice lengths, tolerance "
              f"{INTEGRATE_TOL}); bound_ms charges the pairs the kernel's "
              f"rejection rules out {OPS_PER_REJECTED_INTEGRATE} "
              f"operations, the other pairs whose alpha fails 1/255 "
              f"{OPS_PER_FAILING_INTEGRATE}, the rest "
              f"{OPS_PER_PAIR_INTEGRATE}",
        "kernel_device_ms": field["kernel_device_ms"],
        "ms_given_prep_and_sort": field["ms_given_prep_and_sort"],
        "pairs": field["pairs"], "failing_share": field["failing_share"],
        "rejected_share": field["rejected_share"],
        "escaped_share": field["escaped_share"],
        "lane_efficiency": field["plan_shape"]["lane_efficiency"],
    }, {
        "name": "preprocess", "route": "cuda",
        "source": csrc + "preprocess.cu",
        "replaces": "no TPU kernel: the XLA code of f3d_gaus_tpu/core/"
                    "gaussians.py:preprocess and the feature expansion of "
                    "f3d_gaus_tpu/ops/rasterize.py, which XLA fuses",
        "launches": serve_pre + mesh["launches"]["preprocess"],
        "launches_by_path": {"serving": serve_pre, "training": 0,
                             "mesh": mesh["launches"]["preprocess"]},
        "max_abs_err": max(v["max_gap"] for v in pre_shapes.values()),
        "ms": pre["ms"], "plain_ms": pre["plain_ms_median"],
        "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"],
        "library_ms": None,
        "at": f"orbit view of a request's merged set, P={pre['P']}, SH "
              f"degree {pre['sh_degree']} ({n_nvs} of {n_render} serving "
              "launches per attempt; none in training, whose renders are "
              "differentiated); ms is the kernel's device time a launch "
              "with the L2 flushed before it (warm_ms back to back); "
              "plain_ms the composed route's CUDA-event time a call, which "
              "its host sets (plain_device_ms its kernels' device time); "
              "bound_ms the bytes read and written once; max_abs_err over "
              f"every written field and table at {len(pre_shapes)} clouds, "
              "the binning equal too",
        "shapes": {k: {f: v[f] for f in (
            "P", "sh_degree", "ms", "plain_ms_median", "bound_ms",
            "bound_share")} | {
                "warm_ms": statistics.median(v["warm_ms"]),
                "plain_device_ms": statistics.median(v["plain_device_ms"]),
                "plain_kernels": statistics.median(v["plain_kernels"]),
                "host_ms": statistics.median(v["host_ms"]),
                "plain_host_ms": statistics.median(v["plain_host_ms"])}
            for k, v in pre_shapes.items() if "ms" in v},
    }, {
        "name": "footprint", "route": "cuda",
        "source": csrc + "footprint.cu",
        "sources": [csrc + f for f in ("footprint.cu", "screen.cuh")],
        "replaces": "no TPU kernel: the JAX package's caps are static; the "
                    "port's plain planner binning._footprint_need_impl",
        "launches": (serve_plan + train_plan + mesh["launches"]["footprint"]
                     + scene_plan),
        "launches_by_path": {"serving": serve_plan, "training": train_plan,
                             "mesh": mesh["launches"]["footprint"],
                             "per_scene": scene_plan},
        "max_abs_err": 0,
        "ms": plan["ms"], "plain_ms": plan["plain_ms_median"],
        "bound_ms": plan["bound_ms"], "bound_by": plan["bound_by"],
        "library_ms": None,
        "at": f"the orbit stage's plan, {plan['views']} views of "
              f"P={plan['P']} (2 launches a serving request, 1 a recon "
              "request); ms is the footprint kernel's device time a launch "
              "with the L2 flushed before it; call_ms the wrapper's "
              "CUDA-event time a call, its host read included; plain_ms the "
              "plain version's CUDA-event time a call, which its host sets; "
              "max_abs_err 0: the counts are integers and equal",
        "shapes": {k: {f: v[f] for f in (
            "P", "views", "ms", "call_ms_median", "plain_ms_median",
            "bound_ms", "bound_share")} | {
                "sum_ms": statistics.median(v["sum_ms"]),
                "call_device_ms": statistics.median(v["call_device_ms"]),
                "plain_device_ms": statistics.median(v["plain_device_ms"]),
                "plain_kernels": statistics.median(v["plain_kernels"])}
            for k, v in plan_shapes.items()},
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
