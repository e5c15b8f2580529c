"""Serving (loop `nvs`): one input image per request, closed loop, one
client, each request through `cycle.run_nvs_replanned` (the first
forward, the 8 aggregation renders, the cycle's re-prediction and the
orbit of num_nvs_views + 1 renders).  The warm-up request starts at the
configuration's caps; every later request starts from the caps the
previous one settled on, as `cli.main` carries them.

The window runs requests back to back and closes at the first request
that completes a cycle through the pool after `--seconds`, so every run
serves each pool image equally often; `nvs_images_per_s` is the images
completed over the time to that completion.

`correct`: after the window, a sample of the finished requests drawn from
the seed is recomputed by the reference (its predictor from the same
seeded weights, its plain renders at exact caps) from the same input
image, and compared: the first forward's Gaussians, the cycle's
re-predicted Gaussians, the aggregation renders, the orbit renders at
views drawn from the seed (the frontal one always), and the count of
truncated renders.  Each of the three outputs is compared twice: by the
share of its values off by more than `share_tol` of the field's max
(`*_share`: K1's f32 decisions flip a few pixels against the plain
version's, which a max would read as failures), and by the mean gap over
the field's max (`*_mean`: one region far off, such as a wrong tile,
raises it where it lies under a share).

The pool is small and served once in set-up, so the window sees no new
image: every request starts from caps its image has settled on, and the
replanning a new upload pays (the first request's doublings) lies in
set-up, outside the window.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import harness as H
from .. import inputs, weights

GAUSS_FIELDS = ("xyz", "opacity", "scaling", "rotation", "features_dc",
                "features_rest")
IMAGE_FIELDS = ("render", "rendered_alpha", "rendered_depth")


class State:
    pass


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
    st.cfg = C.PipelineConfig(**pf)
    st.cams = D.canonical_cameras(st.cfg)
    st.pool, st.views = _pool(cell, st.cfg)
    # requests cycle through the pool, each cycle in an order drawn from
    # the seed: every seed serves the same images
    rng = np.random.default_rng(H.seed_int(seed, 2))
    st.order = np.concatenate([rng.permutation(len(st.pool))
                               for _ in range(t["max_cycles"])])
    # warm-up: every pool image once, the first from the configuration's
    # caps, so the window starts at the caps the pool settles on
    st.replans = []
    for image, depth in st.pool:
        st.cfg = cycle.run_nvs_replanned(
            st.model, st.cfg, st.cams, image, depth, device=device,
            log=st.replans.append).cfg
    H.card_sync(device)
    return st


def _pool(cell, cfg):
    """The traffic's images (smooth_rgbd from the mix's data seed) and
    the orbit views the check compares (the frontal one and views drawn
    from the same seed)."""
    t = cell.traffic
    rng = np.random.default_rng(t["data_seed"])
    pool = [inputs.smooth_rgbd(rng, cfg.resolution) for _ in range(t["pool"])]
    views = sorted({0} | set(rng.choice(
        np.arange(1, cfg.num_nvs_views + 1), t["check_views"] - 1,
        replace=False).tolist()))
    return pool, views


def _keep(res, views):
    """What the check reads of one request's outputs."""
    return {"first": {k: res.first[k] for k in GAUSS_FIELDS},
            "merged": {k: res.merged[k] for k in GAUSS_FIELDS},
            "agg": {k: res.agg_views[k] for k in IMAGE_FIELDS},
            "nvs": {k: res.renders[k][:, views] for k in IMAGE_FIELDS},
            "truncated": int(res.agg_views["overflow"].sum()
                             + res.renders["overflow"].sum())}


def window(st, seconds, run):
    from f3d_gaus_torch.models import predictor as P
    from f3d_gaus_torch.ops import rasterize
    from f3d_gaus_torch.pipeline import cycle

    tracing = st.tracer.enabled
    if tracing:
        st.spans.wrap(rasterize, "prepare", "bench.prepare")
        st.spans.wrap(rasterize, "composite", "bench.composite")
        st.spans.wrap(P.GaussianPredictor, "forward", "bench.predictor")
    trace_at = st.traffic["trace_request"]
    st.kept, attempts, stages = [], [], []
    n = 0
    t0 = time.perf_counter()
    while True:
        image, depth = st.pool[st.order[n % len(st.order)]]
        timings = {} if tracing else None
        if tracing and n == trace_at:
            st.tracer.start()
        res = cycle.run_nvs_replanned(st.model, st.cfg, st.cams, image,
                                      depth, device=st.device,
                                      log=st.replans.append, timings=timings)
        H.card_sync(st.device)
        if tracing and n == trace_at:
            st.tracer.stop()
            st.traced = n
        st.cfg = res.cfg
        st.kept.append(_keep(res, st.views))
        attempts.append(res.attempts)
        stages.append(timings)
        del res
        n += 1
        now = time.perf_counter()
        if (now - t0 >= seconds and n % len(st.pool) == 0
                and (not tracing or st.tracer.done)):
            break
    # the profiler's own stop is no part of the traced window's work
    elapsed = now - t0 - st.tracer.overhead_s
    st.spans.close()
    batch = st.pool[0][0].shape[0]
    run.counters["attempts"] = attempts
    run.counters["images"] = n * batch
    run.counters["window_s"] = elapsed
    if tracing:
        run.spans["stage_s"] = stages
    return {"values": {"nvs_images_per_s": n * batch / elapsed},
            "attempted": n, "failed": 0}


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

def _subset(camset, idx):
    return type(camset)(*[np.asarray(a)[idx] for a in camset])


def _camera(rcfg, camset, i):
    from ..reference.cameras import Camera
    return Camera(camset.world_view[i], camset.full_proj[i],
                  camset.cam_centers[i], rcfg.resolution, rcfg.resolution,
                  rcfg.tan_fov, rcfg.tan_fov)


@torch.no_grad()
def reference_request(model, rcfg, rcams, image, depth, views,
                      tf32=False):
    """One request recomputed by the reference: the same outputs as
    `_keep` reads, every render at the caps the reference plans for it."""
    from ..reference import cycle as RC
    from ..reference import renderer as RR
    dev = next(model.parameters()).device
    with H.precision(tf32), H.exact_render_caps():
        images = torch.as_tensor(image, device=dev)
        depth_t = torch.as_tensor(depth, device=dev)
        cano = rcams.camera_set
        g0 = RC.first_forward(model, images, depth_t, cano.view_to_world[0],
                              cano.cv2wT_quat[0])
        agg = RC.aggregation_cameras(rcfg, rcams.inverse_first_camera)
        bg = torch.zeros(3, device=dev)
        merged, agg_views = RC.cycle_aggregate(model, rcfg, g0, agg, bg)
        nvs = _subset(RC.nvs_cameras(rcfg, rcams.inverse_first_camera), views)
        renders = RR.render_views_batched(
            merged, nvs.world_view, nvs.full_proj, nvs.cam_centers, bg, rcfg)
    if bool(agg_views["overflow"].any()) or bool(renders["overflow"].any()):
        raise RuntimeError("the reference's planned caps truncated a render")
    return {"first": {k: g0[k] for k in GAUSS_FIELDS},
            "merged": {k: merged[k] for k in GAUSS_FIELDS},
            "agg": {k: agg_views[k] for k in IMAGE_FIELDS},
            "nvs": {k: renders[k] for k in IMAGE_FIELDS}, "truncated": 0}


def compare(got, want, tol):
    """The numbers compared for one request (see the module docstring)."""
    P = want["first"]["xyz"].shape[1]
    return {
        "first_gap": max(H.max_rel_gap(got["first"][k], want["first"][k])
                         for k in GAUSS_FIELDS),
        "cycle_share": max(H.share_off(got["merged"][k][:, P:],
                                       want["merged"][k][:, P:], tol)
                           for k in GAUSS_FIELDS),
        "agg_share": max(H.share_off(got["agg"][k], want["agg"][k], tol)
                         for k in IMAGE_FIELDS),
        "nvs_share": max(H.share_off(got["nvs"][k], want["nvs"][k], tol)
                         for k in IMAGE_FIELDS),
        "cycle_mean": max(H.mean_rel_gap(got["merged"][k][:, P:],
                                         want["merged"][k][:, P:])
                          for k in GAUSS_FIELDS),
        "agg_mean": max(H.mean_rel_gap(got["agg"][k], want["agg"][k])
                        for k in IMAGE_FIELDS),
        "nvs_mean": max(H.mean_rel_gap(got["nvs"][k], want["nvs"][k])
                        for k in IMAGE_FIELDS),
        "truncated": got["truncated"],
    }


def diagnostics(got, want):
    """Widest gaps, printed beside the numbers compared (not compared)."""
    P = want["first"]["xyz"].shape[1]
    return {
        "cycle_gap": max(H.max_rel_gap(got["merged"][k][:, P:],
                                       want["merged"][k][:, P:])
                         for k in GAUSS_FIELDS),
        "agg_gap": max(H.max_rel_gap(got["agg"][k], want["agg"][k])
                       for k in IMAGE_FIELDS),
        "nvs_gap": max(H.max_rel_gap(got["nvs"][k], want["nvs"][k])
                       for k in IMAGE_FIELDS)}


def _reference_side(st):
    from ..reference import config as RCF
    from ..reference import dataset as RD
    rcfg = RCF.PipelineConfig(**st.fields)
    model = weights.reference_predictor(st.fields, H.seed_int(st.seed, 1),
                                        st.device)
    return model, rcfg, RD.canonical_cameras(rcfg)


def check(st, run):
    """Free the program, then recompute a sample of the finished requests
    with the reference and compare."""
    del st.model
    if torch.device(st.device).type == "cuda":
        torch.cuda.empty_cache()
    lim = st.cell.limits
    rng = np.random.default_rng(H.seed_int(st.seed, 3))
    pick = rng.permutation(len(st.kept))[:lim["check_requests"]]
    model, rcfg, rcams = _reference_side(st)
    checks = H.Checks(lim["limits"])
    worst: dict = {}
    for i in pick:
        image, depth = st.pool[st.order[i % len(st.order)]]
        want = reference_request(model, rcfg, rcams, image, depth, st.views)
        got = st.kept[i]
        for k, v in {**compare(got, want, lim["share_tol"]),
                     **diagnostics(got, want)}.items():
            worst[k] = max(worst.get(k, 0.0), v)
        del want
    for k in lim["limits"]:
        checks.add(k, worst[k])
    run.counters["diagnostics"] = {k: v for k, v in worst.items()
                                   if k not in lim["limits"]}
    if st.tracer.enabled:
        _k1_counts(st, run, rcfg, rcams)
    return checks


def _k1_counts(st, run, rcfg, rcams):
    """The frozen count of K1's least time at the traced request's merged
    set for the sampled orbit views (windows from the reference's prepare),
    and the FLOPs of a request's predictor calls."""
    from ..counts import k1_bound, predictor_flops
    from ..reference import cycle as RC
    from ..reference import rasterize as RZ
    merged = st.kept[st.traced]["merged"]
    nvs = _subset(RC.nvs_cameras(rcfg, rcams.inverse_first_camera), st.views)
    g = [merged[k][0] for k in ("xyz", "scaling", "rotation", "opacity")]
    shs = torch.cat([merged["features_dc"][0], merged["features_rest"][0]], 1)
    bounds = []
    for j in range(len(st.views)):
        cam = _camera(rcfg, nvs, j)
        inp = RZ.prepare(*g, shs, cam, torch.zeros(3, device=shs.device),
                         sh_degree=rcfg.max_sh_degree, chunk=rcfg.chunk,
                         **RZ.plan_caps(*g, cam))
        bounds.append(k1_bound(inp)["bound_ms"])
    run.counts["k1_bound_ms"] = bounds
    run.counts["nvs_views"] = st.views
    run.counts["n_nvs"] = rcfg.num_nvs_views + 1
    run.counts["flops_per_image"] = predictor_flops(
        st.fields, 1, 1) * (1 + rcfg.num_aggregation_views)


def control(cell, seed, device):
    """The control: the reference in TF32 in the program's place, compared
    as `check` compares the program, on one request of the seed's pool."""
    st = State()
    st.cell, st.seed, st.device = cell, seed, device
    st.fields = H.fields(cell.config["pipeline"])
    model, rcfg, rcams = _reference_side(st)
    pool, views = _pool(cell, rcfg)
    rng = np.random.default_rng(H.seed_int(seed, 3))
    image, depth = pool[rng.integers(len(pool))]
    got = reference_request(model, rcfg, rcams, image, depth, views,
                            tf32=True)
    want = reference_request(model, rcfg, rcams, image, depth, views)
    return {**compare(got, want, cell.limits["share_tol"]),
            **diagnostics(got, want)}
