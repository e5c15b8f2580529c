#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (f3d_gaus_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--num_nvs_views 128]

Phases, one JSON line each:
  1. environment: torch, CUDA, nvcc, the card; builds csrc/raster_fwd.cu
     anew for sm_90a and prints ptxas's register/shared-memory line;
  2. kernel vs plain: the compositing kernel against its plain PyTorch
     version on the same inputs, on the 32^2 cases of tests/torch_cases.py
     (out9 and final_T at atol 1e-4, last_pos / max_pos equal) and on the
     256^2 65,536-Gaussian flagship (bench.py's anchor: channels 0-5, 7, 8,
     max error < 2e-2, <= 0.1 % of values above 1e-3);
  3. main path: cycle.run_nvs_replanned at PipelineConfig() width (256^2,
     base_dim 128, 8 aggregation views, 128+1 NVS views) with random EDM
     weights from a seeded torch.Generator on a numpy-made RGB-D input;
     checks shapes, finiteness, no overflow, and that every render went
     through the kernel (launch count == (8 + 129) per attempt);
  4. kernel timing with CUDA events at the main path's two shapes
     (aggregation render, P = 65,536; NVS render, P = 589,824) beside the
     plain version and the bound (operations and bytes this run's data
     needs), whether two launches agree bit for bit, and the split of one
     NVS render into preprocess, binning, compositing and the rest, with
     a torch.profiler trace of that render.
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
# FP32 operations the kernel spends per (pixel, pair), counted from
# csrc/raster_fwd.cu (an FMA counts 2): deciding t, alpha and the stop test
# for every walked pair; normal, colour, depth and distortion accumulation
# for every contributing pair on top
OPS_PER_WALKED = 41
OPS_PER_CONTRIB = 64
TIMED_LAUNCHES = 20        # kernel launches per CUDA-event timing


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
    require(err < 2e-2 and frac <= 1e-3, res)
    return res


def pair_work(inp):
    """(pairs walked, pairs contributing) summed over pixels for this
    input: each pixel walks its tile's window up to and including the
    Gaussian that stops it.  Follows rasterize._composite_fwd_impl."""
    import torch
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.ops import rasterize as R

    s, bng = inp.statics, inp.binning
    feat = cuda_raster._all_features(inp.pre.v2g_mb, inp.rgb,
                                     inp.pre.opa_coef)
    dev = feat.device
    u, v = R._tile_rays(s, dev)
    C = s.chunk
    n = max(-(-s.max_per_tile // C), 1)
    valid, wfeat = R._gather_windows(feat, bng.point_list, bng.tile_start,
                                     bng.tile_count, n * C)
    valid = valid & (torch.arange(n * C, device=dev) < s.max_per_tile)
    T = torch.ones(u.shape, device=dev)
    live = torch.ones(u.shape, dtype=torch.bool, device=dev)
    walked_n = contrib_n = 0
    for ci in range(n):
        sl = slice(ci * C, (ci + 1) * C)
        ct = R._chunk_eval(wfeat[:, sl], u, v)
        vc = ((ct["t"] > R.NEAR_PLANE) & (ct["alpha_raw"] >= R.ALPHA_EPS)
              & valid[:, None, sl])
        alpha = torch.where(vc, ct["alpha_raw"], 0.0)
        T_before = T[..., None] * R._exclusive_cumprod(1.0 - alpha, -1)
        stop = vc & (T_before * (1.0 - ct["alpha_raw"]) < R.STOP_T)
        stop_i = stop.int()
        reach = (torch.cumsum(stop_i, -1) - stop_i) == 0
        walked = reach & valid[:, None, sl] & live[..., None]
        contrib = vc & ~stop & walked
        walked_n += int(walked.sum())
        contrib_n += int(contrib.sum())
        T = T * torch.prod(torch.where(contrib, 1.0 - alpha, 1.0), -1)
        live = live & ~stop.any(-1)
    return walked_n, contrib_n


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


def time_kernel(inp, iters, plain_iters):
    """Kernel and plain-version times on one prepared input, its bound and
    the kernel-vs-plain errors."""
    import torch
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.ops import rasterize as R

    pre, bng, s = inp.pre, inp.binning, inp.statics
    feat = cuda_raster._all_features(pre.v2g_mb, inp.rgb, pre.opa_coef)
    args = (bng.point_list, bng.tile_start, bng.tile_count, inp.bg)
    ms = time_ms(lambda: cuda_raster.composite_fwd(feat, *args, s), iters)
    (o1, a1), (o2, a2) = (cuda_raster.composite_fwd(feat, *args, s)
                          for _ in range(2))
    bitwise = torch.equal(o1, o2) and all(map(torch.equal, a1, a2))
    plain_ms = time_ms(lambda: R._composite_fwd_impl(feat, *args, s),
                       plain_iters, warmup=1)
    walked, contrib = pair_work(inp)
    ops = walked * OPS_PER_WALKED + contrib * OPS_PER_CONTRIB
    # bytes this input needs: each kept pair's id and each referenced
    # Gaussian's NFEAT feature columns read once, the per-tile offsets and
    # counts, and the 9 + 6 per-pixel outputs written once
    ids = bng.point_list[bng.point_list < pre.radii.shape[0]]
    tiles = s.grid_x * s.grid_y
    nbytes = (ids.numel() * 4 + int(torch.unique(ids).numel()) * R.NFEAT * 4
              + 2 * tiles * 4 + 3 * 4 + tiles * R.PIX * (9 + 6) * 4)
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return dict(P=int(pre.radii.shape[0]), pairs=int(bng.num_pairs),
                max_per_tile=s.max_per_tile, walked_pairs_px=walked,
                contrib_pairs_px=contrib, ops=ops, bytes=nbytes,
                bitwise_repeatable=bitwise, ms=ms,
                plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                **compare(inp, exact=False))


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


def profile_render(g, cam, cfg):
    """torch.profiler over one render: the device's busy share of the
    window and the ten operators with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from f3d_gaus_torch.pipeline import renderer

    bg = torch.zeros(3, device=g["xyz"].device)

    def run():
        renderer.render_gaussians(g, 0, cam.world_view, cam.full_proj,
                                  cam.cam_center, bg, cfg)
        torch.cuda.synchronize()
    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
            "top": [{"op": k[:80], "device_us": t, "calls": c}
                    for k, t, c in rows[:10]]}


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num_nvs_views", type=int, default=128)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; it runs only on the card",
              file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from f3d_gaus_torch.core.cameras import Camera
    from f3d_gaus_torch.models import predictor as P
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.ops import rasterize as R
    from f3d_gaus_torch.pipeline import config as C
    from f3d_gaus_torch.pipeline import cycle
    from f3d_gaus_torch.pipeline import dataset as D
    import torch_cases

    dev = torch.device("cuda")
    card = card_line()

    # 1. environment and build
    nvcc = subprocess.run([cuda_raster._nvcc(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    t0 = time.perf_counter()
    cuda_raster.load(rebuild=True)
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in cuda_raster.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("environment", python=sys.version.split()[0], torch=torch.__version__,
         torch_cuda=torch.version.cuda, nvcc=nvcc.strip().splitlines()[-1],
         card=card, device=torch.cuda.get_device_name(0),
         build_s=build_s, ptxas=ptxas)

    # 2. kernel vs plain version on the card
    for name, cam, cloud, bg, kw in torch_cases.small_cases(args.seed):
        inp = R.prepare(*cloud_to(cloud, dev), cam,
                        torch.from_numpy(bg).to(dev), **kw)
        emit("kernel_vs_plain", case=name, tol=1e-4,
             **compare(inp, case=name))
    cam, cloud = torch_cases.bench_scene(np.random.default_rng(args.seed))
    tc = cloud_to(cloud, dev)
    caps = R.plan_caps(*tc[:4], cam)
    inp = R.prepare(*tc, cam, **caps)
    require(not bool(inp.binning.overflow), "flagship caps overflow")
    emit("kernel_vs_plain", case="flagship_256_65536", caps=caps,
         tol="anchor: channels 0-5,7,8 max < 2e-2, <= 0.1% above 1e-3",
         **compare(inp, exact=False))
    torch.cuda.synchronize()

    # 3. the main path at full width
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
    cuda_raster.launches = 0
    t0 = time.perf_counter()
    res = cycle.run_nvs_replanned(model, cfg, cams, images, depth,
                                  device=dev, log=replans.append,
                                  timings=timings)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = cuda_raster.launches
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
    require(launches == (n_agg + n_nvs) * res.attempts > 0,
            f"{launches} kernel launches for {res.attempts} attempts")
    emit("main_path", card=card, config="PipelineConfig()",
         num_nvs_views=cfg.num_nvs_views, params=n_params,
         attempts=res.attempts, replans=replans,
         caps={"pair_cap": res.cfg.pair_cap,
               "max_per_tile": res.cfg.max_per_tile},
         kernel_launches=launches, wall_s=wall_s,
         stage_s_last_attempt=timings, peak_allocated_bytes=peak,
         merged_points=int(res.merged["xyz"].shape[1]))

    # 4. kernel timing at the main path's shapes
    fcfg = res.cfg

    def camera(cams_set, i):
        return Camera(cams_set.world_view[i], cams_set.full_proj[i],
                      cams_set.cam_centers[i], fcfg.resolution,
                      fcfg.resolution, fcfg.tan_fov, fcfg.tan_fov)

    def prepared(g, cam):
        shs = torch.cat([g["features_dc"][0], g["features_rest"][0]], 1)
        return R.prepare(g["xyz"][0], g["scaling"][0], g["rotation"][0],
                         g["opacity"][0], shs, cam, torch.zeros(3, device=dev),
                         sh_degree=fcfg.max_sh_degree,
                         kernel_size=fcfg.kernel_size, pair_cap=fcfg.pair_cap,
                         max_per_tile=fcfg.max_per_tile, chunk=fcfg.chunk)

    agg_cam = camera(cycle.aggregation_cameras(fcfg, cams.inverse_first_camera), 0)
    nvs_cam = camera(cycle.nvs_cameras(fcfg, cams.inverse_first_camera), 0)
    shapes = {"aggregation": time_kernel(prepared(res.first, agg_cam),
                                         TIMED_LAUNCHES, 3),
              "nvs": time_kernel(prepared(res.merged, nvs_cam),
                                 TIMED_LAUNCHES, 2)}
    for k, v in shapes.items():
        emit("kernel_timing", card=card, shape=k, **v)
    emit("nvs_render_breakdown", card=card,
         caps={"pair_cap": fcfg.pair_cap, "max_per_tile": fcfg.max_per_tile},
         **render_breakdown(res.merged, nvs_cam, fcfg))
    emit("nvs_render_profile", card=card,
         **profile_render(res.merged, nvs_cam, fcfg))
    main = shapes["nvs"]
    kernels = [{
        "name": "raster_fwd", "route": "cuda",
        "source": "f3d_gaus_torch/csrc/raster_fwd.cu",
        "replaces": "f3d_gaus_tpu/ops/pallas_raster.py:230",
        "launches": launches, "max_abs_err": main["anchor_err"],
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "at": f"NVS render, P={main['P']} ({n_nvs} of {n_agg + n_nvs} "
              "launches per attempt); max_abs_err over out9 channels "
              "0-5,7,8",
        "shapes": {k: {f: v[f] for f in ("P", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "anchor_err")}
                   for k, v in shapes.items()},
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
