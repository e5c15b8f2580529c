"""Multi-view reconstruction serving: posed input views -> a large
reconstruction model's pixel-aligned Gaussians -> an orbit of renders.
No JAX counterpart.

`run_gslrm` serves three models: GS-LRM (models/gslrm.py: one object from
a few square views) or Long-LRM (models/longlrm.py: a scene from many
views of any frame size, its Gaussians pruned by opacity), both given the
input cameras, or AnySplat (models/anysplat.py: a scene from unposed
views, which predicts the cameras itself).  It predicts the Gaussians
once, a posed model called with the frames' x and y tangents, then
renders the orbit (for a pose-free request without one, the predicted
cameras of PREDICTED_TARGETS inputs, each at its own tangents) at the caps
`cycle.stage_caps` plans from the set's own footprints at the orbit's
cameras, with run_nvs_replanned's
guard: should a planned render overflow, the caller's caps are doubled
and the orbit is rendered again at them as static caps, at most
cycle.MAX_DOUBLINGS times.  There is no cycle stage: the input views
already surround the object or scene.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..utils import profiling
from . import cycle, renderer
from .config import PipelineConfig


PREDICTED_TARGETS = 8     # a pose-free request's renders without an orbit


class ReconResult(NamedTuple):
    gaussians: dict        # (B, P, ...) pixel-aligned Gaussians (Long-LRM:
                           # the kept ones, and `kept`; AnySplat: the
                           # merged ones, and `voxels`)
    renders: dict          # the orbit's renders (B, F, ...)
    cfg: PipelineConfig    # the config whose caps the orbit rendered at
    attempts: int          # orbit renders tried (1 = the plan fitted)
    cameras: dict | None = None   # a pose-free model's predicted input
                                  # cameras (models/anysplat.py)


class TargetCams(NamedTuple):
    """An orbit of cameras each at its own tangents: world_view, full_proj
    (F, 4, 4) and cam_centers (F, 3) float32 arrays, tangents F (tan_fovx,
    tan_fovy) pairs."""
    world_view: np.ndarray
    full_proj: np.ndarray
    cam_centers: np.ndarray
    tangents: list


def predicted_targets(cams: dict, targets: int) -> TargetCams:
    """The predicted cameras of inputs k·V / targets, k = 0 .. targets - 1,
    of element 0 of a pose-free model's `cameras`, on the host."""
    V = cams["world_view"].shape[1]
    idx = [k * V // targets for k in range(targets)]

    def host(name):
        return cams[name][0, idx].float().cpu().numpy()
    tx, ty = host("tan_fovx"), host("tan_fovy")
    return TargetCams(host("world_view"), host("full_proj"),
                      host("cam_centers"),
                      [(float(a), float(b)) for a, b in zip(tx, ty)])


@torch.no_grad()
@profiling.spanned("recon")
def run_gslrm(model, cfg: PipelineConfig, images, input_cams=None,
              orbit_cams=None, timings=None, device=None,
              log=print) -> ReconResult:
    """One reconstruction request.

    model: a GSLRM, a LongLRM or an AnySplat on the run's device; cfg:
    the render settings (the frame's width `resolution` and `height`, its
    horizontal fov_deg, max_sh_degree 0, chunk, kernel_size) and the caps
    to double from should the plan fail; images (B, V, H, W, 3) RGB in
    [0, 1] seen by the input cameras `input_cams`, (B, V, 4, 4) row-vector
    world_view matrices at cfg's tangents (cfg.tan_fov, cfg.tan_fovy), or
    None for a pose-free model, whose predicted cameras come back in
    `cameras`; orbit_cams: anything with `world_view`, `full_proj` (F, 4,
    4) and `cam_centers` (F, 3) arrays (and, as TargetCams, each camera's
    `tangents`), or None for the predicted cameras of PREDICTED_TARGETS
    inputs (predicted_targets).  Runs on `device` (default: the images' device,
    else cuda).  The returned `cfg` carries the orbit's planned caps, which
    a caller may pass to the next request as cli.main carries run_nvs's.

    timings: a dict to receive the wall seconds of the stages `predict`
    and `orbit` (the card synchronised at each).  While tracing is on
    (utils.profiling) the call is a root span `recon` with a span per
    stage (`plan_caps` inside `orbit`), and each doubling counts
    `caps.fallbacks`."""
    dev = resolve_device(device, images if torch.is_tensor(images) else None)
    images = torch.as_tensor(images, dtype=torch.float32, device=dev)
    bg = torch.zeros(3, device=dev)
    clock = profiling.StageClock(dev, timings)

    if input_cams is None:
        gaussians = model(images)
        cams = gaussians.pop("cameras")
    else:
        views = torch.as_tensor(np.asarray(input_cams, np.float32),
                                device=dev)
        gaussians = model(images, views, cfg.tan_fov, cfg.tan_fovy)
        cams = None
    clock.lap("predict")
    if orbit_cams is None:
        orbit_cams = predicted_targets(cams, PREDICTED_TARGETS)
    tangents = getattr(orbit_cams, "tangents", None)
    run_cfg = cycle.stage_caps(gaussians, orbit_cams.world_view,
                               orbit_cams.full_proj, cfg, tangents)
    for attempt in range(cycle.MAX_DOUBLINGS + 1):
        renders = renderer.render_views_batched(
            gaussians, orbit_cams.world_view, orbit_cams.full_proj,
            orbit_cams.cam_centers, bg, run_cfg, tangents=tangents)
        n_over = int(renders["overflow"].sum())
        if not n_over:
            clock.lap("orbit")
            return ReconResult(gaussians, renders, run_cfg, attempt + 1,
                               cams)
        profiling.count("caps.fallbacks")
        cfg = dataclasses.replace(cfg, pair_cap=cfg.pair_cap * 2,
                                  max_per_tile=cfg.max_per_tile * 2)
        log(f"{n_over} orbit renders exceeded pair_cap={run_cfg.pair_cap} "
            f"max_per_tile={run_cfg.max_per_tile}; rendering again at "
            f"pair_cap={cfg.pair_cap} max_per_tile={cfg.max_per_tile}")
        run_cfg = cfg
    raise RuntimeError(
        f"render caps still overflow after {cycle.MAX_DOUBLINGS} doublings")
