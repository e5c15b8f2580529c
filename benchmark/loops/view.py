"""Viewer frames (loop `view`): one frame per request, closed loop, one
client.  Set-up serves one image (smooth_rgbd from the mix's data seed)
once through `cycle.run_nvs_replanned` and keeps its merged
cycle-aggregated Gaussians; then it plans the frames' caps once with
`cycle.stage_caps` over `plan_cameras` cameras drawn from the frame
stream's distribution, and renders `warmup_frames` frames of a stream of
its own.

A frame's camera is drawn from a stream seeded by the run: yaw and pitch
uniform within the orbit's own ranges (PipelineConfig.yaw_diff,
pitch_diff) at its radius and look-at, rebased to the canonical first
camera as the orbit is (the reference's numpy camera chain,
reference/cameras.py:build_camera_set, makes every camera).  Each frame
is one `renderer.render_views_batched` call with one view at the planned
caps (an eager render), its RGB copied to the host as a viewer displays
it.  A frame that overflows is rendered again at doubled caps, which are
then carried on, and each doubling counts `caps.fallbacks`.  The window
closes at the first frame that completes after `--seconds`;
`nvs_images_per_s` counts one frame as one image.

`correct`: nvs_b1's numbers and limits.  The reference (its predictor
from the same seeded weights, its plain renders at exact caps) recomputes
the set-up request from the same image, which loop nvs's comparison
compares; and `check_frames` frames of the window, drawn from the run's
seed as the window goes (reservoir sampling), rendered by the reference
from its own merged set at the same cameras, which join the orbit renders
in `nvs_share` and `nvs_mean`, and any that came back truncated in
`truncated`.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import harness as H
from .. import inputs, weights
from . import nvs

IMAGE_FIELDS = nvs.IMAGE_FIELDS


class State:
    pass


def _views(t, cfg):
    """The orbit views of the set-up request the check compares: the
    frontal one and views drawn from the mix's data seed."""
    rng = np.random.default_rng([t["data_seed"], 2])
    return sorted({0} | set(rng.choice(
        np.arange(1, cfg.num_nvs_views + 1), t["check_views"] - 1,
        replace=False).tolist()))


class Frames:
    """The frame stream: (world_view, full_proj, cam_centers) of n
    cameras at a time, drawn from `seed` within the orbit's ranges."""

    def __init__(self, cfg, inverse_first_camera, seed):
        self.cfg, self.rebase = cfg, inverse_first_camera
        self.rng = np.random.default_rng(seed)

    def draw(self, n):
        from ..reference.cameras import build_camera_set
        c = self.cfg
        yaw = self.rng.uniform(-c.yaw_diff, c.yaw_diff, n).astype(np.float32)
        pitch = self.rng.uniform(-c.pitch_diff, c.pitch_diff,
                                 n).astype(np.float32)
        cs = build_camera_set(yaw, pitch, c.radius, c.look_at_z, c.fov_deg,
                              c.z_near, c.z_far, rebase=self.rebase)
        return cs.world_view, cs.full_proj, cs.cam_centers


def setup(cell, seed, device, tracer, spans):
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.pipeline import config as C
    from f3d_gaus_torch.pipeline import cycle
    from f3d_gaus_torch.pipeline import dataset as D

    st = State()
    st.cell, st.seed, st.device = cell, seed, device
    st.tracer, st.spans = tracer, spans
    st.traffic = t = cell.traffic
    st.fields = pf = H.fields(cell.config["pipeline"])
    ref = weights.reference_predictor(pf, H.seed_int(seed, 1), device)
    st.model = weights.program_predictor(pf, ref.state_dict(), device)
    del ref
    if torch.device(device).type == "cuda":
        cuda_raster.load()
    cfg = C.PipelineConfig(**pf)
    cams = D.canonical_cameras(cfg)
    st.image, st.depth = inputs.smooth_rgbd(
        np.random.default_rng(t["data_seed"]), cfg.resolution)
    st.views = _views(t, cfg)
    st.replans = []
    res = cycle.run_nvs_replanned(st.model, cfg, cams, st.image, st.depth,
                                  device=device, log=st.replans.append)
    st.setup_kept = nvs._keep(res, st.views)
    st.merged = res.merged
    del res
    st.rebase = cams.inverse_first_camera
    st.frames = Frames(cfg, st.rebase, H.seed_int(seed, 5))
    plan = Frames(cfg, st.rebase, H.seed_int(seed, 6))
    wv, fp, _ = plan.draw(t["plan_cameras"])
    st.cfg = cycle.stage_caps(st.merged, wv, fp, cfg)
    st.bg = torch.zeros(3, device=device)
    st.fallbacks = 0
    warm = Frames(cfg, st.rebase, H.seed_int(seed, 7))
    for _ in range(t["warmup_frames"]):
        _frame(st, *warm.draw(1))
    H.card_sync(device)
    return st


def _frame(st, wv, fp, cc):
    """One viewer frame: the render at the carried caps, again at doubled
    caps while it overflows, and its RGB on the host."""
    from f3d_gaus_torch.pipeline import renderer
    from f3d_gaus_torch.utils import profiling
    while True:
        out = renderer.render_views_batched(st.merged, wv, fp, cc, st.bg,
                                            st.cfg)
        if not bool(out["overflow"].any()):
            break
        profiling.count("caps.fallbacks")
        st.fallbacks += 1
        st.cfg = dataclasses.replace(st.cfg, pair_cap=st.cfg.pair_cap * 2,
                                     max_per_tile=st.cfg.max_per_tile * 2)
    out["render"][0, 0].cpu()
    return out


def window(st, seconds, run):
    tracing = st.tracer.enabled
    t = st.traffic
    trace_from, trace_to = t["trace_from"], t["trace_from"] + t["trace_frames"]
    # the frames the check recomputes: a reservoir of check_frames, each
    # frame taking a place with probability check_frames / its count
    pick = np.random.default_rng(H.seed_int(st.seed, 4))
    k = t["check_frames"]
    st.kept = []
    fallbacks = st.fallbacks
    n = 0
    t0 = time.perf_counter()
    while True:
        if tracing and n == trace_from:
            st.tracer.start()
        cam = st.frames.draw(1)
        out = _frame(st, *cam)
        if tracing and n + 1 == trace_to:
            st.tracer.stop()
        keep = {"cam": cam, "nvs": {f: out[f] for f in IMAGE_FIELDS},
                "truncated": int(out["overflow"].sum())}
        if n < k:
            st.kept.append(keep)
        else:
            j = int(pick.integers(n + 1))
            if j < k:
                st.kept[j] = keep
        del out
        n += 1
        now = time.perf_counter()
        if now - t0 >= seconds and (not tracing or st.tracer.done):
            break
    elapsed = now - t0 - st.tracer.overhead_s
    run.counters["frames"] = n
    run.counters["fallbacks"] = st.fallbacks - fallbacks
    run.counters["window_s"] = elapsed
    return {"values": {"nvs_images_per_s": n / elapsed},
            "attempted": n, "failed": 0}


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

@torch.no_grad()
def reference_frames(merged, rcfg, cams, tf32=False):
    """The reference's renders of its merged set at each (world_view,
    full_proj, cam_centers) of `cams`, at exact caps."""
    from ..reference import renderer as RR
    out = []
    with H.precision(tf32), H.exact_render_caps():
        for wv, fp, cc in cams:
            r = RR.render_views_batched(
                merged, wv, fp, cc,
                torch.zeros(3, device=merged["xyz"].device), rcfg)
            if bool(r["overflow"].any()):
                raise RuntimeError(
                    "the reference's planned caps truncated a render")
            out.append({f: r[f] for f in IMAGE_FIELDS})
    return out


def _frames_compared(got, want, tol):
    """The frames' share, mean gap and truncated count, worst frame."""
    share = max(H.share_off(g["nvs"][f], w[f], tol)
                for g, w in zip(got, want) for f in IMAGE_FIELDS)
    mean = max(H.mean_rel_gap(g["nvs"][f], w[f])
               for g, w in zip(got, want) for f in IMAGE_FIELDS)
    gap = max(H.max_rel_gap(g["nvs"][f], w[f])
              for g, w in zip(got, want) for f in IMAGE_FIELDS)
    return share, mean, gap, sum(g["truncated"] for g in got)


def _combined(setup_got, setup_want, frames_got, frames_want, tol):
    """nvs's numbers of the set-up request, with the frames joining the
    orbit renders' share, mean and truncated count."""
    values = {**nvs.compare(setup_got, setup_want, tol),
              **nvs.diagnostics(setup_got, setup_want)}
    share, mean, gap, truncated = _frames_compared(frames_got, frames_want,
                                                   tol)
    values["nvs_share"] = max(values["nvs_share"], share)
    values["nvs_mean"] = max(values["nvs_mean"], mean)
    values["nvs_gap"] = max(values["nvs_gap"], gap)
    values["truncated"] += truncated
    values["frame_share"], values["frame_mean"] = share, mean
    return values


def check(st, run):
    """Free the program, then recompute the set-up request and the kept
    frames with the reference and compare."""
    del st.model, st.merged
    if torch.device(st.device).type == "cuda":
        torch.cuda.empty_cache()
    lim = st.cell.limits
    model, rcfg, rcams = nvs._reference_side(st)
    want = nvs.reference_request(model, rcfg, rcams, st.image, st.depth,
                                 st.views)
    frames = reference_frames(want["merged"], rcfg,
                              [g["cam"] for g in st.kept])
    values = _combined(st.setup_kept, want, st.kept, frames,
                       lim["share_tol"])
    checks = H.Checks(lim["limits"])
    for k in lim["limits"]:
        checks.add(k, values[k])
    run.counters["diagnostics"] = {k: v for k, v in values.items()
                                   if k not in lim["limits"]}
    return checks


def control(cell, seed, device):
    """The control: the reference in TF32 in the program's place, on the
    set-up image and `check_frames` frames of the seed's stream, compared
    as `check` compares the program."""
    from ..reference import dataset as RD
    st = State()
    st.cell, st.seed, st.device = cell, seed, device
    st.fields = H.fields(cell.config["pipeline"])
    model, rcfg, rcams = nvs._reference_side(st)
    t = cell.traffic
    image, depth = inputs.smooth_rgbd(np.random.default_rng(t["data_seed"]),
                                      rcfg.resolution)
    views = _views(t, rcfg)
    frames = Frames(rcfg, RD.canonical_cameras(rcfg).inverse_first_camera,
                    H.seed_int(seed, 5))
    cams = [frames.draw(1) for _ in range(t["check_frames"])]
    got = nvs.reference_request(model, rcfg, rcams, image, depth, views,
                                tf32=True)
    want = nvs.reference_request(model, rcfg, rcams, image, depth, views)
    got_frames = [{"nvs": f, "truncated": 0} for f in reference_frames(
        got["merged"], rcfg, cams, tf32=True)]
    return _combined(got, want, got_frames,
                     reference_frames(want["merged"], rcfg, cams),
                     cell.limits["share_tol"])
