"""Scene reconstruction serving (loop `scene`): one scene per request,
closed loop, one client, each request through `reconstruct.run_gslrm`
with Long-LRM (its forward over the scene's posed views and its pruning,
then `targets` renders at caps planned from the kept set).  A request's
views are ray-cast from the analytic scene (inputs.raycast) at the
configuration's frame size and horizontal field of view, on a closed loop
at azimuths phi0 + 360 i / V degrees and elevations elevation_deg +
elevation_swing_deg sin(2 (azimuth - phi0)), at the scene's radius,
looking at the origin; the targets lie midway between inputs k V /
targets and the next.  phi0 and the radius (a jitter of
+-`radius_jitter`) are drawn per scene from the mix's data seed.

The pool is small and served once in set-up; the window cycles through
it in orders drawn from the run's seed, and closes at the first request
that completes a cycle through the pool after `--seconds`.
`nvs_images_per_s` counts one served scene as one image.

`correct`: one request of the window, drawn from the run's seed as the
window goes (one kept at a time), is recomputed after the window, with
the program freed, by the reference (benchmark/reference/longlrm.py from
the same seeded weights at the published shape; its renders through the
reference's plain rasterizer, reference/rasterize.py:render, at the caps
its plan_caps finds, with the configuration's non-square camera: the
reference renderer's wrapper is square) and compared: `premerge_gap`,
the tokens entering the merge (max gap over max: the 7 scans over the
whole sequence); `token_gap`, the final LayerNorm's tokens; `kept_share`,
the share of the program's kept indices outside the reference's kept
set; `gauss_share` and `gauss_mean`, the program's kept Gaussians against
the reference's per-pixel fields at the same indices (as recon's);
`nvs_share` and `nvs_mean`, `check_views` target renders (the first and
views drawn from the seed) against the reference's renders of its own
kept set; `truncated`, renders the caps truncated.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import harness as H
from .. import inputs, weights
from ..counts_longlrm import forward_flops, scan_lengths, ssd_bound
from .recon import Cams, Object, _c2w

GAUSS_FIELDS = ("xyz", "opacity", "scaling", "rotation", "features_dc")
IMAGE_FIELDS = ("render", "rendered_alpha", "rendered_depth")
# the published shape runs on a card; a CPU run is for the tests' sizes
CPU_TOKENS = 4096


class State:
    pass


def tangents(render: dict):
    """The frame's x and y tangents as PipelineConfig states them: the
    horizontal field of view's, and that scaled by height / width."""
    tan_x = math.tan(render["fov_deg"] * math.pi / 360.0)
    return tan_x, tan_x * (render["height"] / render["resolution"])


def make_pool(cell, device):
    """The mix's scenes, drawn from its data seed."""
    from ..reference.cameras import Camera
    t, cams = cell.traffic, cell.config["cameras"]
    model = cell.config["model"]
    W, Hh, V = model["frame_width"], model["frame_height"], model["views"]
    rng = np.random.default_rng(t["data_seed"])
    pool = []
    for _ in range(t["pool"]):
        phi0 = rng.uniform(0.0, 2.0 * math.pi)
        radius = cams["radius"] * (1.0 + rng.uniform(-t["radius_jitter"],
                                                     t["radius_jitter"]))

        def at(azimuths):
            return inputs.blender_cameras(
                Camera, [_c2w(a, math.radians(
                    cams["elevation_deg"] + cams["elevation_swing_deg"]
                    * math.sin(2.0 * (a - phi0))), radius)
                    for a in azimuths], cams["camera_angle_x"], W, Hh)
        views = at(phi0 + 2.0 * math.pi * np.arange(V) / V)
        targets = at(phi0 + 2.0 * math.pi
                     * (np.arange(cams["targets"]) * V / cams["targets"]
                        + 0.5) / V)
        images = torch.stack([inputs.raycast(c, device).permute(1, 2, 0)
                              for c in views])[None].contiguous()
        pool.append(Object(images, np.stack([c.world_view
                                             for c in views])[None],
                           Cams(targets)))
    return pool


def _check_views(rng, cell):
    """The targets the check compares: the first and `check_views` - 1
    drawn from `rng`."""
    n = cell.config["cameras"]["targets"]
    return sorted({0} | set(rng.choice(
        np.arange(1, n), cell.traffic["check_views"] - 1,
        replace=False).tolist()))


def reference_longlrm(model: dict, seed: int, device):
    """The reference Long-LRM at the configuration's shape, its weights
    drawn from `seed` (one stream of normals) on `device`."""
    from ..reference import longlrm as RL
    cfg = RL.LongLRMConfig(**model)
    return weights._built(lambda g: RL.LongLRM(cfg, g), seed, device,
                          normal=True)


def program_longlrm(model: dict, state_dict: dict, device):
    """The program's LongLRM holding `state_dict`."""
    from f3d_gaus_torch.models import longlrm as LL
    with torch.device(device):
        m = LL.LongLRM(LL.LongLRMConfig(**model), None)
    m.load_state_dict(state_dict)
    return m.to(device).eval()


def setup(cell, seed, device, tracer, spans):
    # a program without Long-LRM stops here, at once
    from f3d_gaus_torch.models import longlrm as LL
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.pipeline import config as C
    from f3d_gaus_torch.pipeline import reconstruct as R

    st = State()
    st.cell, st.seed, st.device = cell, seed, device
    st.tracer, st.spans = tracer, spans
    st.traffic = t = cell.traffic
    model = cell.config["model"]
    on_card = torch.device(device).type == "cuda"
    if not on_card and LL.LongLRMConfig(**model).tokens > CPU_TOKENS:
        raise RuntimeError("this configuration's shape needs a CUDA card")
    ref = reference_longlrm(model, H.seed_int(seed, 1), device)
    st.model = program_longlrm(model, ref.state_dict(), device)
    del ref
    if on_card:
        cuda_raster.load()
    st.cfg = C.PipelineConfig(**H.fields(cell.config["render"]))
    st.pool = make_pool(cell, device)
    rng = np.random.default_rng(H.seed_int(seed, 2))
    st.order = np.concatenate([rng.permutation(len(st.pool))
                               for _ in range(t["max_cycles"])])
    st.views = _check_views(rng, cell)
    # the tokens entering the merge and the final LayerNorm's, of the
    # last forward, for the check
    st.model.merge.register_forward_pre_hook(
        lambda mod, args: setattr(st, "premerge", args[0]))
    st.model.norm.register_forward_hook(
        lambda mod, args, out: setattr(st, "tokens", out))
    st.replans = []
    for obj in st.pool:
        st.cfg = R.run_gslrm(st.model, st.cfg, obj.images, obj.input_views,
                             obj.orbit, device=device,
                             log=st.replans.append).cfg
    st.premerge = st.tokens = None
    H.card_sync(device)
    return st


def _keep(st, res):
    """What the check reads of one request's outputs."""
    return {"premerge": st.premerge, "tokens": st.tokens,
            "kept": res.gaussians["kept"],
            "gauss": {k: res.gaussians[k] for k in GAUSS_FIELDS},
            "nvs": {k: res.renders[k][:, st.views] for k in IMAGE_FIELDS},
            "truncated": int(res.renders["overflow"].sum())}


def window(st, seconds, run):
    from f3d_gaus_torch.pipeline import reconstruct as R

    tracing = st.tracer.enabled
    trace_at = st.traffic["trace_request"]
    # the request the check recomputes: one kept at a time, each request
    # taking the place with probability 1 / (its count), from the seed
    pick = np.random.default_rng(H.seed_int(st.seed, 4))
    st.kept, st.kept_at = None, None
    attempts, stages = [], []
    n = 0
    t0 = time.perf_counter()
    while True:
        obj = st.pool[st.order[n % len(st.order)]]
        timings = {} if tracing else None
        if tracing and n == trace_at:
            st.tracer.start()
        res = R.run_gslrm(st.model, st.cfg, obj.images, obj.input_views,
                          obj.orbit, timings=timings, device=st.device,
                          log=st.replans.append)
        H.card_sync(st.device)
        if tracing and n == trace_at:
            st.tracer.stop()
        st.cfg = res.cfg
        if pick.integers(n + 1) == 0:
            st.kept, st.kept_at = None, n
            st.kept = _keep(st, res)
        st.premerge = st.tokens = None
        attempts.append(res.attempts)
        stages.append(timings)
        del res
        n += 1
        now = time.perf_counter()
        if (now - t0 >= seconds and n % len(st.pool) == 0
                and (not tracing or st.tracer.done)):
            break
    elapsed = now - t0 - st.tracer.overhead_s
    run.counters["attempts"] = attempts
    run.counters["scenes"] = n
    run.counters["window_s"] = elapsed
    model = st.cell.config["model"]
    run.counts["flops_per_scene"] = forward_flops(model)["total"]
    run.counts["ssd_bound_ms"] = [ssd_bound(L, model)["bound_ms"]
                                  for L in scan_lengths(model)]
    if tracing:
        run.spans["stage_s"] = stages
    return {"values": {"nvs_images_per_s": n / elapsed},
            "attempted": n, "failed": 0}


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

def reference_renders(g, render: dict, cams, tf32=False):
    """The reference's plain renders of element 0 of `g` at `cams` (a
    Cams), each at the caps the reference's plan_caps finds for it, with
    the configuration's frame size and tangents."""
    from ..reference import rasterize as RZ
    from ..reference.cameras import Camera
    tan_x, tan_y = tangents(render)
    g0 = [g[k][0] for k in ("xyz", "scaling", "rotation", "opacity")]
    shs = g["features_dc"][0]
    bg = torch.zeros(3, device=shs.device)
    out = {k: [] for k in IMAGE_FIELDS}
    with H.precision(tf32):
        for c in cams.cams:
            cam = Camera(c.world_view, c.full_proj, c.cam_center,
                         render["resolution"], render["height"], tan_x, tan_y)
            r = RZ.render(*g0, shs, cam, bg, sh_degree=0,
                          kernel_size=render["kernel_size"],
                          chunk=render["chunk"], **RZ.plan_caps(*g0, cam))
            if bool(r["overflow"]):
                raise RuntimeError(
                    "the reference's planned caps truncated a render")
            for k in IMAGE_FIELDS:
                out[k].append(r[k])
    return {k: torch.stack(v)[None] for k, v in out.items()}


@torch.no_grad()
def reference_request(model, render: dict, obj, views, tf32=False):
    """One request recomputed by the reference: the tokens entering the
    merge, the final LayerNorm's, the kept set and its Gaussians, every
    pixel's fields, and the renders at `views` of its kept set."""
    dev = next(model.parameters()).device
    with H.precision(tf32):
        wv = torch.as_tensor(obj.input_views, dtype=torch.float32,
                             device=dev)
        g, aux = model(obj.images, wv, *tangents(render))
    nvs = reference_renders(g, render, obj.orbit.subset(views), tf32)
    return {"premerge": aux["premerge"], "tokens": aux["tokens"],
            "kept": g["kept"], "fields": aux["fields"],
            "gauss": {k: g[k] for k in GAUSS_FIELDS}, "nvs": nvs,
            "truncated": 0}


def compare(got, want, tol):
    """The numbers compared for one request (see the module docstring)."""
    kept = got["kept"][0]
    ref_kept = torch.zeros(want["fields"]["xyz"].shape[1], dtype=torch.bool,
                           device=kept.device)
    ref_kept[want["kept"][0]] = True
    at = {k: want["fields"][k][:, kept] for k in GAUSS_FIELDS}
    return {
        "premerge_gap": H.max_rel_gap(got["premerge"], want["premerge"]),
        "token_gap": H.max_rel_gap(got["tokens"], want["tokens"]),
        "kept_share": 1.0 - float(ref_kept[kept].double().mean()),
        "gauss_share": max(H.share_off(got["gauss"][k], at[k], tol)
                           for k in GAUSS_FIELDS),
        "gauss_mean": max(H.mean_rel_gap(got["gauss"][k], at[k])
                          for k in GAUSS_FIELDS),
        "nvs_share": max(H.share_off(got["nvs"][k], want["nvs"][k], tol)
                         for k in IMAGE_FIELDS),
        "nvs_mean": max(H.mean_rel_gap(got["nvs"][k], want["nvs"][k])
                        for k in IMAGE_FIELDS),
        "truncated": got["truncated"],
    }


def diagnostics(got, want):
    """Widest gaps, printed beside the numbers compared (not compared)."""
    kept = got["kept"][0]
    return {"gauss_gap": max(H.max_rel_gap(got["gauss"][k],
                                           want["fields"][k][:, kept])
                             for k in GAUSS_FIELDS),
            "nvs_gap": max(H.max_rel_gap(got["nvs"][k], want["nvs"][k])
                           for k in IMAGE_FIELDS)}


def check(st, run):
    """Free the program, then recompute the kept request with the
    reference and compare."""
    del st.model
    st.premerge = st.tokens = None
    if torch.device(st.device).type == "cuda":
        torch.cuda.empty_cache()
    lim = st.cell.limits
    model = reference_longlrm(st.cell.config["model"],
                              H.seed_int(st.seed, 1), st.device).eval()
    obj = st.pool[st.order[st.kept_at % len(st.order)]]
    want = reference_request(model, st.cell.config["render"], obj, st.views)
    values = {**compare(st.kept, want, lim["share_tol"]),
              **diagnostics(st.kept, want)}
    checks = H.Checks(lim["limits"])
    for k in lim["limits"]:
        checks.add(k, values[k])
    run.counters["diagnostics"] = {k: v for k, v in values.items()
                                   if k not in lim["limits"]}
    run.counters["diagnostics"]["checked_request"] = st.kept_at
    return checks


def control(cell, seed, device):
    """The control: the reference in TF32 in the program's place, compared
    as `check` compares the program, on one scene of the pool drawn from
    the seed."""
    model = reference_longlrm(cell.config["model"], H.seed_int(seed, 1),
                              device).eval()
    pool = make_pool(cell, device)
    rng = np.random.default_rng(H.seed_int(seed, 2))
    views = _check_views(rng, cell)
    obj = pool[int(rng.integers(len(pool)))]
    render = cell.config["render"]
    got = reference_request(model, render, obj, views, tf32=True)
    got.pop("fields")
    want = reference_request(model, render, obj, views)
    return {**compare(got, want, cell.limits["share_tol"]),
            **diagnostics(got, want)}
