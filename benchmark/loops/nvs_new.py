"""Serving new uploads (loop `nvs_new`): one input image per request,
closed loop, one client, each request through `cycle.run_nvs_replanned`
as in loop `nvs`, but no image is served twice: request i serves image i
of a smooth_rgbd stream drawn from the mix's data seed, so every run
serves the same sequence, and the warm-up serves `warmup` images of a
stream of its own.  Every request starts from the caps the previous one
returned, as `cli.main` carries them, so a request pays whatever a new
image's footprints cost: its plans, and any guard doubling.

The window closes at the first request that completes after `--seconds`;
`nvs_images_per_s` is the images completed over the time to that
completion.  `correct` is loop `nvs`'s comparison (its reference and its
numbers) on one finished request drawn from the seed.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import harness as H
from .. import inputs, weights
from . import nvs


class State:
    pass


def _stream(rng, n, r):
    return [inputs.smooth_rgbd(rng, r) for _ in range(n)]


def _views(t, cfg):
    """The orbit views the check compares: the frontal one and views
    drawn from the mix's data seed."""
    rng = np.random.default_rng([t["data_seed"], 2])
    return sorted({0} | set(rng.choice(
        np.arange(1, cfg.num_nvs_views + 1), t["check_views"] - 1,
        replace=False).tolist()))


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
    r = st.cfg.resolution
    st.images = _stream(np.random.default_rng(t["data_seed"]),
                        t["max_requests"], r)
    st.views = _views(t, st.cfg)
    # warm-up: images of their own, the first from the configuration's caps
    st.replans = []
    for image, depth in _stream(np.random.default_rng([t["data_seed"], 1]),
                                t["warmup"], r):
        st.cfg = cycle.run_nvs_replanned(
            st.model, st.cfg, st.cams, image, depth, device=device,
            log=st.replans.append).cfg
    H.card_sync(device)
    return st


def window(st, seconds, run):
    from f3d_gaus_torch.pipeline import cycle

    tracing = st.tracer.enabled
    trace_at = st.traffic["trace_request"]
    st.kept, attempts = [], []
    n = 0
    t0 = time.perf_counter()
    while True:
        if n == len(st.images):
            raise RuntimeError("the window outran the mix's max_requests")
        image, depth = st.images[n]
        if tracing and n == trace_at:
            st.tracer.start()
        res = cycle.run_nvs_replanned(st.model, st.cfg, st.cams, image,
                                      depth, device=st.device,
                                      log=st.replans.append)
        H.card_sync(st.device)
        if tracing and n == trace_at:
            st.tracer.stop()
        st.cfg = res.cfg
        st.kept.append(nvs._keep(res, st.views))
        attempts.append(res.attempts)
        del res
        n += 1
        now = time.perf_counter()
        if now - t0 >= seconds and (not tracing or st.tracer.done):
            break
    elapsed = now - t0 - st.tracer.overhead_s
    batch = st.images[0][0].shape[0]
    run.counters["attempts"] = attempts
    run.counters["images"] = n * batch
    run.counters["window_s"] = elapsed
    return {"values": {"nvs_images_per_s": n * batch / elapsed},
            "attempted": n, "failed": 0}


def check(st, run):
    """Free the program, then recompute a finished request drawn from the
    seed with loop nvs's reference and compare as it does."""
    del st.model
    if torch.device(st.device).type == "cuda":
        torch.cuda.empty_cache()
    lim = st.cell.limits
    rng = np.random.default_rng(H.seed_int(st.seed, 3))
    pick = rng.permutation(len(st.kept))[:lim["check_requests"]]
    model, rcfg, rcams = nvs._reference_side(st)
    checks = H.Checks(lim["limits"])
    worst: dict = {}
    for i in pick:
        image, depth = st.images[i]
        want = nvs.reference_request(model, rcfg, rcams, image, depth,
                                     st.views)
        got = st.kept[i]
        for k, v in {**nvs.compare(got, want, lim["share_tol"]),
                     **nvs.diagnostics(got, want)}.items():
            worst[k] = max(worst.get(k, 0.0), v)
        del want
    for k in lim["limits"]:
        checks.add(k, worst[k])
    run.counters["diagnostics"] = {k: v for k, v in worst.items()
                                   if k not in lim["limits"]}
    return checks


def control(cell, seed, device):
    """The control: the reference in TF32 in the program's place, compared
    as `check` compares the program, on one image of the stream drawn from
    the seed."""
    st = State()
    st.cell, st.seed, st.device = cell, seed, device
    st.fields = H.fields(cell.config["pipeline"])
    model, rcfg, rcams = nvs._reference_side(st)
    t = cell.traffic
    i = int(np.random.default_rng(H.seed_int(seed, 3)).integers(8))
    image, depth = _stream(np.random.default_rng(t["data_seed"]), i + 1,
                           rcfg.resolution)[i]
    views = _views(t, rcfg)
    got = nvs.reference_request(model, rcfg, rcams, image, depth, views,
                                tf32=True)
    want = nvs.reference_request(model, rcfg, rcams, image, depth, views)
    return {**nvs.compare(got, want, cell.limits["share_tol"]),
            **nvs.diagnostics(got, want)}
