"""Cycle-aggregative multi-view Gaussian construction + NVS (counterpart
of f3d_gaus_tpu/pipeline/cycle.py).

The F3D-Gaus inference program (reference visualize.py:221-419):

  1. FIRST FORWARD: predictor on the input image (canonical camera) ->
     H·W pixel-aligned Gaussians.
  2. Render the set from `num_aggregation_views` (8) orbit cameras.
  3. CYCLE: feed each rendered view ([rgb | alpha], rendered depth) back
     through the SAME predictor with that view's camera (one call, the view
     axis folded into the batch, one view per feed); concatenate every
     per-view set with the original -> 9 x H·W Gaussians.
  4. NVS: render the merged set over a 128-view orbit (+1 frontal).

Everything runs without autograd: this is the serving path.  `run_nvs`
renders steps 2 and 4 at the config's static caps (`pair_cap`,
`max_per_tile`); `run_nvs_replanned` renders each at the caps
`stage_caps` plans from the stage's own footprints just before it
renders, and keeps the doubling on RenderOverflow as its guard.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core import cameras
from ..core.device import clip_tie, resolve_device
from ..ops import binning
from ..utils import profiling
from .config import PipelineConfig
from . import renderer


def aggregation_cameras(cfg: PipelineConfig, inverse_first_camera):
    """The aggregation orbit cameras (visualize.py:241-279)."""
    return cameras.orbit_camera_set(
        cfg.num_aggregation_views, cfg.fov_deg, cfg.radius, cfg.look_at_z,
        cfg.z_near, cfg.z_far, cfg.yaw_diff, cfg.pitch_diff,
        rebase=inverse_first_camera if cfg.update_pose else None)


def nvs_cameras(cfg: PipelineConfig, inverse_first_camera):
    """num_nvs_views orbit views + 1 frontal prepended (visualize.py:342-365)."""
    orbit = cameras.orbit_camera_set(
        cfg.num_nvs_views, cfg.fov_deg, cfg.radius, cfg.look_at_z,
        cfg.z_near, cfg.z_far, cfg.yaw_diff, cfg.pitch_diff,
        rebase=inverse_first_camera if cfg.update_pose else None)
    frontal = cameras.orbit_camera_set(
        1, cfg.fov_deg, cfg.radius, cfg.look_at_z, cfg.z_near, cfg.z_far,
        0.0, 0.0, rebase=inverse_first_camera if cfg.update_pose else None)
    return cameras.CameraSet(*[np.concatenate([a, b], 0) for a, b in
                               zip(frontal, orbit)])


def _t(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@torch.no_grad()
def first_forward(model, images, depth, cano_v2w, cano_quat):
    """images (B, H, W, 3) in [0,1]; depth (B, H, W) tensors.  Returns the
    per-image Gaussian dicts (B, P, ...) predicted from the canonical view
    (visualize.py:282-283: input_feat = [rgb | ones])."""
    B = images.shape[0]
    dev = images.device
    feat = torch.cat([images, torch.ones_like(images[..., :1])], -1)[:, None]
    v2w = _t(cano_v2w, dev).expand(B, 1, 4, 4)
    quat = _t(cano_quat, dev).expand(B, 1, 4)
    return model(feat, v2w, quat, depth[:, None])


@torch.no_grad()
def cycle_aggregate(model, cfg: PipelineConfig, gaussians, agg, bg):
    """Steps 2+3: render `gaussians` from the aggregation views `agg` (a
    CameraSet), re-predict per view, concatenate along the point axis.
    Returns (merged gaussians dict (B, (1+V)·P, ...), rendered views)."""
    views = renderer.render_views_batched(
        gaussians, agg.world_view, agg.full_proj, agg.cam_centers, bg, cfg)
    rgb = clip_tie(views["render"], 0.0, 1.0)         # (B, V, 3, H, W)
    alpha = views["rendered_alpha"]                    # (B, V, 1, H, W)
    depth = views["rendered_depth"][:, :, 0]           # (B, V, H, W)

    B, V = rgb.shape[:2]
    dev = rgb.device
    feat = torch.cat([rgb, alpha], 2).permute(0, 1, 3, 4, 2)   # NHWC
    feat = feat.reshape(B * V, 1, *feat.shape[2:])
    v2w = _t(agg.view_to_world, dev)[None].expand(B, V, 4, 4).reshape(B * V, 1, 4, 4)
    quat = _t(agg.cv2wT_quat, dev)[None].expand(B, V, 4).reshape(B * V, 1, 4)
    d = depth.reshape(B * V, 1, *depth.shape[2:])
    out = model(feat, v2w, quat, d)
    merged = {}
    for k, v in gaussians.items():
        nv = out[k].reshape(B, V * out[k].shape[1], *out[k].shape[2:])
        merged[k] = torch.cat([v, nv], dim=1)
    return merged, views


@profiling.spanned("plan_caps")
def stage_caps(gaussians, world_views, full_projs, cfg: PipelineConfig,
               tangents=None) -> PipelineConfig:
    """cfg with exactly the caps one render stage needs: what binning
    `gaussians` (B, P, ...) at the (V, 4, 4) world_views / full_projs at
    cfg's frame size (`resolution` by `frame_height`), both tangents (or
    each view's (tan_fovx, tan_fovy) of `tangents`) and kernel_size needs
    (binning.footprint_need), with no headroom and no
    floor; pair_cap rounded up to binning.suggest_pair_cap's bucket,
    max_per_tile to a multiple of 256, so rasterize.bin_band keeps 256
    lanes.  A render
    nothing truncates does not depend on its caps.  While tracing is on
    (utils.profiling) the call is span `plan_caps` and counts
    `caps.plans`."""
    wv = np.asarray(world_views, np.float32)
    fp = np.asarray(full_projs, np.float32)
    cam = cameras.Camera(wv[0], fp[0], np.zeros(3, np.float32),
                         cfg.resolution, cfg.frame_height, cfg.tan_fov,
                         cfg.tan_fovy)
    need = binning.footprint_need(gaussians["xyz"], gaussians["scaling"],
                                  gaussians["rotation"], wv, fp, cam,
                                  cfg.kernel_size, tangents)
    profiling.count("caps.plans")
    return dataclasses.replace(
        cfg, pair_cap=binning.suggest_pair_cap(need["pairs"]),
        max_per_tile=max(1, -(-need["tile"] // 256)) * 256)


def run_nvs(model, cfg: PipelineConfig, cams, images, depth, bg=None,
            return_first=False, check_overflow=True, device=None,
            timings=None):
    """End-to-end NVS: first forward -> cycle -> orbit renders.

    model: a GaussianPredictor (moved to the run's device); cams: anything
    with `camera_set` and `inverse_first_camera` (a DemoDataset, or
    dataset.canonical_cameras(cfg)); images (B, H, W, 3), depth (B, H, W)
    as arrays or tensors.  Runs on `device` (default: the tensors' device,
    else cuda).  Returns (merged_gaussians, nvs renders dict (B, V, ...),
    aggregation views dict[, first-forward gaussians when return_first]).

    check_overflow: raise renderer.RenderOverflow if ANY render exceeded
    cfg.pair_cap / cfg.max_per_tile (run_nvs_replanned doubles the caps);
    with False the truncated renders are returned, their `overflow` maps
    set.
    timings: a dict to receive each stage's wall seconds ('first_forward',
    'cycle_aggregate', 'nvs_orbit'); the device is synchronised after each
    stage only when it is given.  While tracing is on (utils.profiling)
    the call is a root span `request` with a span per stage.
    """
    out = _run_nvs(model, cfg, cams, images, depth, bg=bg,
                   check_overflow=check_overflow, device=device,
                   timings=timings, plan=False)
    return out[:4] if return_first else out[:3]


@torch.no_grad()
@profiling.spanned("request")
def _run_nvs(model, cfg, cams, images, depth, *, bg, check_overflow,
             device, timings, plan):
    """run_nvs's stages, each render stage at cfg's caps or, with `plan`,
    at the caps stage_caps plans for it inside its own lap (the
    aggregation renders from the first forward's set, the orbit from the
    merged set).  Returns (merged, renders, agg_views, first-forward set,
    the orbit stage's config)."""
    dev = resolve_device(device, images if torch.is_tensor(images) else None)
    model = model.to(dev).eval()
    images, depth = _t(images, dev), _t(depth, dev)
    bg = torch.zeros(3, device=dev) if bg is None else _t(bg, dev)
    cano = cams.camera_set
    agg = aggregation_cameras(cfg, cams.inverse_first_camera)
    nvs = nvs_cameras(cfg, cams.inverse_first_camera)
    clock = profiling.StageClock(dev, timings)

    g0 = first_forward(model, images, depth, cano.view_to_world[0],
                       cano.cv2wT_quat[0])
    clock.lap("first_forward")
    agg_cfg = stage_caps(g0, agg.world_view, agg.full_proj, cfg) if plan else cfg
    merged, agg_views = cycle_aggregate(model, agg_cfg, g0, agg, bg)
    clock.lap("cycle_aggregate")
    nvs_cfg = (stage_caps(merged, nvs.world_view, nvs.full_proj, cfg)
               if plan else cfg)
    renders = renderer.render_views_batched(
        merged, nvs.world_view, nvs.full_proj, nvs.cam_centers, bg, nvs_cfg)
    clock.lap("nvs_orbit")
    n_over = (int(agg_views["overflow"].sum() + renders["overflow"].sum())
              if check_overflow else 0)
    if n_over:
        raise renderer.RenderOverflow(
            f"{n_over} renders exceeded the {'planned' if plan else 'static'}"
            f" caps (aggregation pair_cap={agg_cfg.pair_cap}, max_per_tile="
            f"{agg_cfg.max_per_tile}; orbit pair_cap={nvs_cfg.pair_cap}, "
            f"max_per_tile={nvs_cfg.max_per_tile}) and would truncate; "
            f"double the caps or use rasterize.plan_caps")
    return merged, renders, agg_views, g0, nvs_cfg


MAX_DOUBLINGS = 7          # cap doublings run_nvs_replanned tries


class NVSResult(NamedTuple):
    merged: dict           # (B, (1+V_agg)·P, ...) Gaussians
    renders: dict          # NVS renders (B, V, ...)
    agg_views: dict        # aggregation renders (B, V_agg, ...)
    first: dict            # first-forward Gaussians (B, P, ...)
    cfg: PipelineConfig    # the config whose caps the orbit renders ran at
    attempts: int          # run_nvs calls made (1 = no replan)


def run_nvs_replanned(model, cfg: PipelineConfig, cams, images, depth,
                      device=None, log=print, timings=None) -> NVSResult:
    """run_nvs (black background) with each render stage at the caps
    stage_caps plans for it, and resize-and-relaunch as the guard: on
    RenderOverflow double cfg's caps and run again at them as static caps
    (run_nvs), at most MAX_DOUBLINGS times (the reference is exact at any
    load, rasterizer_impl.cu:247-405).
    cfg's caps are no floor for a planned run, so a config carried from
    request to request (the returned `cfg`: the orbit stage's caps, which
    cover a binning of the merged set or any subset of it at the NVS
    cameras) does not ratchet up.  `timings` receives the stage times of
    the last attempt (see run_nvs).  While tracing is on (utils.profiling)
    each doubling counts `caps.fallbacks`."""
    plan = True
    for attempt in range(MAX_DOUBLINGS + 1):
        try:
            merged, renders, agg_views, g0, run_cfg = _run_nvs(
                model, cfg, cams, images, depth, bg=None, check_overflow=True,
                device=device, timings=timings, plan=plan)
            return NVSResult(merged, renders, agg_views, g0, run_cfg,
                             attempt + 1)
        except renderer.RenderOverflow as e:
            plan = False
            profiling.count("caps.fallbacks")
            cfg = dataclasses.replace(cfg, pair_cap=cfg.pair_cap * 2,
                                      max_per_tile=cfg.max_per_tile * 2)
            log(f"{e}; replanning with pair_cap={cfg.pair_cap} "
                f"max_per_tile={cfg.max_per_tile}")
    raise RuntimeError(
        f"render caps still overflow after {MAX_DOUBLINGS} doublings")
