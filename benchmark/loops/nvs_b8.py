"""Batched serving (loop `nvs_b8`): `batch` input images per request, as
`cli.py` serves by default (--batch_size 8), closed loop, one client, each
request through `cycle.run_nvs_replanned` (loop `nvs`'s stages over the
whole batch).  The warm-up request starts at the configuration's caps;
every later request starts from the caps the previous one settled on, as
`cli.main` carries them.  The pool holds `pool` batches of smooth_rgbd
images (inputs.smooth_rgbd from the mix's data seed), each served once in
set-up; the window cycles through it in orders drawn from the run's seed
and closes as loop `nvs`'s does.  `nvs_images_per_s` counts every image
of a batch.

`correct`: `check_elements` images of one request of the window, the
request drawn from the run's seed as the window goes (one kept at a
time) and its batch elements from the same stream, are recomputed after
the window, with the program freed, by the reference from each image
alone (loop `nvs`'s reference_request) and compared with the program's
outputs for those batch elements, by loop `nvs`'s numbers (the worst
element's) and limits.

A traced run reads what loop `nvs`'s does: the harness's profiler ranges
around rasterize.prepare, rasterize.composite and the predictor's
forward, and K1's frozen count at the traced request's orbit renders of
every batch element (a stage renders view by view, each view's elements
in turn, so element b of view v is the stage's launch v·batch + b).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import harness as H
from .. import inputs, weights
from ..counts import predictor_flops
from .nvs import (GAUSS_FIELDS, IMAGE_FIELDS, State, _camera,
                  _reference_side, _subset, compare, diagnostics,
                  reference_request)


def _pool(cell, cfg):
    """The traffic's batches of smooth_rgbd images and the orbit views the
    check compares (the frontal one and views drawn from the same
    seed)."""
    t = cell.traffic
    rng = np.random.default_rng(t["data_seed"])
    pool = []
    for _ in range(t["pool"]):
        pairs = [inputs.smooth_rgbd(rng, cfg.resolution)
                 for _ in range(t["batch"])]
        pool.append((np.concatenate([p[0] for p in pairs]),
                     np.concatenate([p[1] for p in pairs])))
    views = sorted({0} | set(rng.choice(
        np.arange(1, cfg.num_nvs_views + 1), t["check_views"] - 1,
        replace=False).tolist()))
    return pool, views


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
    rng = np.random.default_rng(H.seed_int(seed, 2))
    st.order = np.concatenate([rng.permutation(len(st.pool))
                               for _ in range(t["max_cycles"])])
    st.replans = []
    for image, depth in st.pool:
        st.cfg = cycle.run_nvs_replanned(
            st.model, st.cfg, st.cams, image, depth, device=device,
            log=st.replans.append).cfg
    H.card_sync(device)
    return st


def _keep(res, b, views):
    """What the check reads of batch element b of one request."""
    one = slice(b, b + 1)
    return {"first": {k: res.first[k][one] for k in GAUSS_FIELDS},
            "merged": {k: res.merged[k][one] for k in GAUSS_FIELDS},
            "agg": {k: res.agg_views[k][one] for k in IMAGE_FIELDS},
            "nvs": {k: res.renders[k][one][:, views] for k in IMAGE_FIELDS},
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
    batch = st.traffic["batch"]
    n_check = st.cell.limits["check_elements"]
    # the images the check recomputes: one request kept at a time, each
    # taking the place with probability 1 / (its count), and n_check of
    # its elements, from the seed
    pick = np.random.default_rng(H.seed_int(st.seed, 4))
    st.kept, st.kept_at, st.traced_merged = None, None, None
    attempts, stages = [], []
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
            st.traced_merged = {k: res.merged[k] for k in GAUSS_FIELDS}
        st.cfg = res.cfg
        if pick.integers(n + 1) == 0:
            els = sorted(pick.choice(batch, n_check, replace=False).tolist())
            st.kept = None
            st.kept = [_keep(res, b, st.views) for b in els]
            st.kept_at = (n, els)
        attempts.append(res.attempts)
        stages.append(timings)
        del res
        n += 1
        now = time.perf_counter()
        if (now - t0 >= seconds and n % len(st.pool) == 0
                and (not tracing or st.tracer.done)):
            break
    elapsed = now - t0 - st.tracer.overhead_s
    st.spans.close()
    run.counters["attempts"] = attempts
    run.counters["images"] = n * batch
    run.counters["window_s"] = elapsed
    if tracing:
        run.spans["stage_s"] = stages
        run.counts["flops_per_image"] = predictor_flops(
            st.fields, 1, 1) * (1 + st.cfg.num_aggregation_views)
    return {"values": {"nvs_images_per_s": n * batch / elapsed},
            "attempted": n, "failed": 0}


def check(st, run):
    """Free the program, then recompute the kept images with the reference
    and compare."""
    del st.model
    if torch.device(st.device).type == "cuda":
        torch.cuda.empty_cache()
    lim = st.cell.limits
    model, rcfg, rcams = _reference_side(st)
    n, els = st.kept_at
    image, depth = st.pool[st.order[n % len(st.order)]]
    worst: dict = {}
    for b, got in zip(els, st.kept):
        want = reference_request(model, rcfg, rcams, image[b:b + 1],
                                 depth[b:b + 1], st.views)
        for k, v in {**compare(got, want, lim["share_tol"]),
                     **diagnostics(got, want)}.items():
            worst[k] = max(worst.get(k, 0.0), v)
        del want
    checks = H.Checks(lim["limits"])
    for k in lim["limits"]:
        checks.add(k, worst[k])
    run.counters["diagnostics"] = {k: v for k, v in worst.items()
                                   if k not in lim["limits"]}
    run.counters["diagnostics"]["checked_images"] = [n, els]
    if st.tracer.enabled:
        _k1_counts(st, run, rcfg, rcams)
    return checks


def _k1_counts(st, run, rcfg, rcams):
    """The frozen count of K1's least time at the traced request's merged
    sets, every batch element's, for the sampled orbit views (windows from
    the reference's prepare), and where each render falls among the
    orbit stage's launches, as metrics/k1_roofline.nvs.py reads them."""
    from ..counts import k1_bound
    from ..reference import cycle as RC
    from ..reference import rasterize as RZ
    merged = st.traced_merged
    batch = merged["xyz"].shape[0]
    nvs = _subset(RC.nvs_cameras(rcfg, rcams.inverse_first_camera), st.views)
    bounds, launches = [], []
    for b in range(batch):
        g = [merged[k][b] for k in ("xyz", "scaling", "rotation", "opacity")]
        shs = torch.cat([merged["features_dc"][b],
                         merged["features_rest"][b]], 1)
        for j, v in enumerate(st.views):
            cam = _camera(rcfg, nvs, j)
            inp = RZ.prepare(*g, shs, cam, torch.zeros(3, device=shs.device),
                             sh_degree=rcfg.max_sh_degree, chunk=rcfg.chunk,
                             **RZ.plan_caps(*g, cam))
            bounds.append(k1_bound(inp)["bound_ms"])
            launches.append(v * batch + b)
    run.counts["k1_bound_ms"] = bounds
    run.counts["nvs_views"] = launches
    run.counts["n_nvs"] = (rcfg.num_nvs_views + 1) * batch


def control(cell, seed, device):
    """The control: the reference in TF32 in the program's place, compared
    as `check` compares the program, on one image of the seed's pool."""
    st = State()
    st.cell, st.seed, st.device = cell, seed, device
    st.fields = H.fields(cell.config["pipeline"])
    model, rcfg, rcams = _reference_side(st)
    pool, views = _pool(cell, rcfg)
    rng = np.random.default_rng(H.seed_int(seed, 3))
    image, depth = pool[rng.integers(len(pool))]
    b = int(rng.integers(image.shape[0]))
    one = slice(b, b + 1)
    got = reference_request(model, rcfg, rcams, image[one], depth[one],
                            views, tf32=True)
    want = reference_request(model, rcfg, rcams, image[one], depth[one],
                             views)
    return {**compare(got, want, cell.limits["share_tol"]),
            **diagnostics(got, want)}
