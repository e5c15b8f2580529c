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

Everything runs without autograd: this is the serving path.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core import cameras
from ..core.device import clip_tie, resolve_device
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


@torch.no_grad()
@profiling.spanned("request")
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
    merged, agg_views = cycle_aggregate(model, cfg, g0, agg, bg)
    clock.lap("cycle_aggregate")
    renders = renderer.render_views_batched(
        merged, nvs.world_view, nvs.full_proj, nvs.cam_centers, bg, cfg)
    clock.lap("nvs_orbit")
    n_over = (int(agg_views["overflow"].sum() + renders["overflow"].sum())
              if check_overflow else 0)
    if n_over:
        raise renderer.RenderOverflow(
            f"{n_over} renders exceeded the static caps (pair_cap="
            f"{cfg.pair_cap}, max_per_tile={cfg.max_per_tile}) and "
            f"would truncate; double the caps or use rasterize.plan_caps")
    if return_first:
        return merged, renders, agg_views, g0
    return merged, renders, agg_views


MAX_DOUBLINGS = 7          # cap doublings run_nvs_replanned tries


class NVSResult(NamedTuple):
    merged: dict           # (B, (1+V_agg)·P, ...) Gaussians
    renders: dict          # NVS renders (B, V, ...)
    agg_views: dict        # aggregation renders (B, V_agg, ...)
    first: dict            # first-forward Gaussians (B, P, ...)
    cfg: PipelineConfig    # the config whose caps the run settled on
    attempts: int          # run_nvs calls made (1 = no replan)


def run_nvs_replanned(model, cfg: PipelineConfig, cams, images, depth,
                      device=None, log=print, timings=None) -> NVSResult:
    """run_nvs (black background) with resize-and-relaunch: on
    RenderOverflow double both caps and run again, at most MAX_DOUBLINGS
    times (the reference is exact at any load, rasterizer_impl.cu:247-405).
    `timings` receives the stage times of the last attempt (see run_nvs)."""
    for attempt in range(MAX_DOUBLINGS + 1):
        try:
            merged, renders, agg_views, g0 = run_nvs(
                model, cfg, cams, images, depth, return_first=True,
                check_overflow=True, device=device, timings=timings)
            return NVSResult(merged, renders, agg_views, g0, cfg, attempt + 1)
        except renderer.RenderOverflow as e:
            cfg = dataclasses.replace(cfg, pair_cap=cfg.pair_cap * 2,
                                      max_per_tile=cfg.max_per_tile * 2)
            log(f"{e}; replanning with pair_cap={cfg.pair_cap} "
                f"max_per_tile={cfg.max_per_tile}")
    raise RuntimeError(
        f"render caps still overflow after {MAX_DOUBLINGS} doublings")
