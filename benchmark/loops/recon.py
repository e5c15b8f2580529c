"""Multi-view reconstruction serving (loop `recon`): one object per request,
closed loop, one client, each request through
`reconstruct.run_gslrm` (GS-LRM's forward over the object's posed views,
then a turntable of `frames` renders at caps planned from the predicted
set).  A request's views are ray-cast from the analytic scene
(inputs.raycast) by NeRF-synthetic cameras at the configuration's
elevation and azimuths phi0 + the configuration's input azimuths, at the
object's radius; phi0 and the radius (a jitter of +-`radius_jitter`) are
drawn per object from the mix's data seed.  The turntable keeps the
elevation and radius and steps the azimuth evenly from phi0.

The pool is small and served once in set-up; the window cycles through
it in orders drawn from the run's seed, and closes at the first request
that completes a cycle through the pool after `--seconds`.
`nvs_images_per_s` counts one served object as one image.

`correct`: after the window, with the program freed, the reference
(benchmark/reference/gslrm.py from the same seeded weights, its plain
renders at exact caps) recomputes one finished request drawn from the
seed and compares: `token_gap`, the final LayerNorm's tokens (max gap
over max: the head's small per-group scales would hide the transformer's
errors in the Gaussians); `gauss_share` and `gauss_mean`, the Gaussian
fields (the share of values off by more than `share_tol` of the field's
max, and the mean gap over the max, worst field); `nvs_share` and
`nvs_mean`, the same for `check_views` turntable renders (the first and
views drawn from the seed); `truncated`, renders the caps truncated.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import harness as H
from .. import inputs, weights
from ..counts_gslrm import attention_bound, forward_flops

GAUSS_FIELDS = ("xyz", "opacity", "scaling", "rotation", "features_dc")
IMAGE_FIELDS = ("render", "rendered_alpha", "rendered_depth")
# the published widths run on a card; a CPU run is for the tests' sizes
CPU_TOKENS = 4096


class State:
    pass


class Cams:
    """Cameras as arrays: world_view, full_proj (n, 4, 4), cam_centers
    (n, 3), and the reference's Camera of each."""

    def __init__(self, cams):
        self.cams = cams
        self.world_view = np.stack([c.world_view for c in cams])
        self.full_proj = np.stack([c.full_proj for c in cams])
        self.cam_centers = np.stack([c.cam_center for c in cams])

    def subset(self, idx):
        return Cams([self.cams[i] for i in idx])


class Object:
    """One request: views (1, V, H, W, 3) on the card, the input cameras'
    world_view (1, V, 4, 4) and the turntable's Cams."""

    def __init__(self, images, input_views, orbit):
        self.images, self.input_views, self.orbit = images, input_views, orbit


def _c2w(azimuth, elevation, radius):
    """A Blender camera-to-world matrix at (azimuth, elevation) on a sphere
    of `radius` around the origin (z up), looking at it (OpenGL axes), as
    inputs.hemisphere_c2w builds them."""
    p = radius * np.array([math.cos(elevation) * math.cos(azimuth),
                           math.cos(elevation) * math.sin(azimuth),
                           math.sin(elevation)])
    f = -p / np.linalg.norm(p)
    r = np.cross(f, [0.0, 0.0, 1.0])
    r /= np.linalg.norm(r)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([r, np.cross(r, f), -f], 1)
    c2w[:3, 3] = p
    return c2w


def make_pool(cell, device):
    """The mix's objects, drawn from its data seed."""
    from ..reference.cameras import Camera
    t, cams = cell.traffic, cell.config["cameras"]
    res = cell.config["model"]["resolution"]
    el = math.radians(cams["elevation_deg"])
    rng = np.random.default_rng(t["data_seed"])
    pool = []
    for _ in range(t["pool"]):
        phi0 = rng.uniform(0.0, 2.0 * math.pi)
        radius = cams["radius"] * (1.0 + rng.uniform(-t["radius_jitter"],
                                                     t["radius_jitter"]))

        def at(azimuths):
            return inputs.blender_cameras(
                Camera, [_c2w(a, el, radius) for a in azimuths],
                cams["camera_angle_x"], res, res)
        views = at([phi0 + math.radians(a)
                    for a in cams["input_azimuths_deg"]])
        orbit = at(phi0 + 2.0 * math.pi * np.arange(t["frames"])
                   / t["frames"])
        images = torch.stack([inputs.raycast(c, device).permute(1, 2, 0)
                              for c in views])[None].contiguous()
        pool.append(Object(images, np.stack([c.world_view
                                             for c in views])[None],
                           Cams(orbit)))
    return pool


def _check_views(rng, traffic):
    """The turntable views the check compares: the first and
    `check_views` - 1 drawn from `rng`."""
    return sorted({0} | set(rng.choice(
        np.arange(1, traffic["frames"]), traffic["check_views"] - 1,
        replace=False).tolist()))


def reference_gslrm(model: dict, seed: int, device):
    """The reference GS-LRM at the configuration's widths, its weights
    drawn from `seed` (one stream of normals) on `device`."""
    from ..reference import gslrm as RG
    cfg = RG.GSLRMConfig(**model)
    return weights._built(lambda g: RG.GSLRM(cfg, g), seed, device,
                          normal=True)


def program_gslrm(model: dict, state_dict: dict, device):
    """The program's GSLRM holding `state_dict`."""
    from f3d_gaus_torch.models import gslrm as G
    with torch.device(device):
        m = G.GSLRM(G.GSLRMConfig(**model), None)
    m.load_state_dict(state_dict)
    return m.to(device).eval()


def setup(cell, seed, device, tracer, spans):
    # a program without GS-LRM stops here, at once
    from f3d_gaus_torch.models import gslrm as G
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.pipeline import config as C
    from f3d_gaus_torch.pipeline import reconstruct as R

    st = State()
    st.cell, st.seed, st.device = cell, seed, device
    st.tracer, st.spans = tracer, spans
    st.traffic = t = cell.traffic
    model = cell.config["model"]
    on_card = torch.device(device).type == "cuda"
    if not on_card and G.GSLRMConfig(**model).tokens > CPU_TOKENS:
        raise RuntimeError("this configuration's widths need a CUDA card")
    ref = reference_gslrm(model, H.seed_int(seed, 1), device)
    st.model = program_gslrm(model, ref.state_dict(), device)
    del ref
    if on_card:
        cuda_raster.load()
    st.cfg = C.PipelineConfig(**H.fields(cell.config["render"]))
    st.pool = make_pool(cell, device)
    rng = np.random.default_rng(H.seed_int(seed, 2))
    st.order = np.concatenate([rng.permutation(len(st.pool))
                               for _ in range(t["max_cycles"])])
    st.views = _check_views(rng, t)
    # the final LayerNorm's tokens of the last forward, for the check
    st.model.norm.register_forward_hook(
        lambda mod, args, out: setattr(st, "tokens", out))
    st.replans = []
    for obj in st.pool:
        st.cfg = R.run_gslrm(st.model, st.cfg, obj.images, obj.input_views,
                             obj.orbit, device=device,
                             log=st.replans.append).cfg
    H.card_sync(device)
    return st


def _keep(res, tokens, views):
    """What the check reads of one request's outputs."""
    return {"tokens": tokens,
            "gauss": {k: res.gaussians[k] for k in GAUSS_FIELDS},
            "nvs": {k: res.renders[k][:, views] for k in IMAGE_FIELDS},
            "truncated": int(res.renders["overflow"].sum())}


def window(st, seconds, run):
    from f3d_gaus_torch.pipeline import reconstruct as R

    tracing = st.tracer.enabled
    trace_at = st.traffic["trace_request"]
    st.kept, attempts, stages = [], [], []
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
        st.kept.append(_keep(res, st.tokens, st.views))
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
    run.counters["objects"] = n
    run.counters["window_s"] = elapsed
    model = st.cell.config["model"]
    n_tok = model["views"] * (model["resolution"] // model["patch"]) ** 2
    run.counts["flops_per_object"] = forward_flops(model)["total"]
    run.counts["attn_bound_ms"] = attention_bound(
        n_tok, model["width"])["bound_ms"]
    if tracing:
        run.spans["stage_s"] = stages
    return {"values": {"nvs_images_per_s": n / elapsed},
            "attempted": n, "failed": 0}


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

@torch.no_grad()
def reference_request(model, rcfg, obj, views, tf32=False):
    """One request recomputed by the reference: the final LayerNorm's
    tokens, the Gaussians and the renders at `views`, every render at the
    caps the reference plans for it."""
    from ..reference import renderer as RR
    dev = next(model.parameters()).device
    with H.precision(tf32), H.exact_render_caps():
        wv = torch.as_tensor(obj.input_views, dtype=torch.float32,
                             device=dev)
        g, tokens = model(obj.images, wv, rcfg.tan_fov)
        cams = obj.orbit.subset(views)
        renders = RR.render_views_batched(
            g, cams.world_view, cams.full_proj, cams.cam_centers,
            torch.zeros(3, device=dev), rcfg)
    if bool(renders["overflow"].any()):
        raise RuntimeError("the reference's planned caps truncated a render")
    return {"tokens": tokens,
            "gauss": {k: g[k] for k in GAUSS_FIELDS},
            "nvs": {k: renders[k] for k in IMAGE_FIELDS}, "truncated": 0}


def compare(got, want, tol):
    """The numbers compared for one request (see the module docstring)."""
    return {
        "token_gap": H.max_rel_gap(got["tokens"], want["tokens"]),
        "gauss_share": max(H.share_off(got["gauss"][k], want["gauss"][k],
                                       tol) for k in GAUSS_FIELDS),
        "gauss_mean": max(H.mean_rel_gap(got["gauss"][k], want["gauss"][k])
                          for k in GAUSS_FIELDS),
        "nvs_share": max(H.share_off(got["nvs"][k], want["nvs"][k], tol)
                         for k in IMAGE_FIELDS),
        "nvs_mean": max(H.mean_rel_gap(got["nvs"][k], want["nvs"][k])
                        for k in IMAGE_FIELDS),
        "truncated": got["truncated"],
    }


def diagnostics(got, want):
    """Widest gaps, printed beside the numbers compared (not compared)."""
    return {"gauss_gap": max(H.max_rel_gap(got["gauss"][k],
                                           want["gauss"][k])
                             for k in GAUSS_FIELDS),
            "nvs_gap": max(H.max_rel_gap(got["nvs"][k], want["nvs"][k])
                           for k in IMAGE_FIELDS)}


def _reference_side(cell, seed, device):
    from ..reference import config as RCF
    model = reference_gslrm(cell.config["model"], H.seed_int(seed, 1), device)
    return model.eval(), RCF.PipelineConfig(**H.fields(cell.config["render"]))


def check(st, run):
    """Free the program, then recompute a finished request drawn from the
    seed with the reference and compare."""
    del st.model
    st.tokens = None
    if torch.device(st.device).type == "cuda":
        torch.cuda.empty_cache()
    lim = st.cell.limits
    rng = np.random.default_rng(H.seed_int(st.seed, 3))
    pick = rng.permutation(len(st.kept))[:lim["check_requests"]]
    model, rcfg = _reference_side(st.cell, st.seed, st.device)
    checks = H.Checks(lim["limits"])
    worst: dict = {}
    for i in pick:
        obj = st.pool[st.order[i % len(st.order)]]
        want = reference_request(model, rcfg, obj, st.views)
        for k, v in {**compare(st.kept[i], want, lim["share_tol"]),
                     **diagnostics(st.kept[i], want)}.items():
            worst[k] = max(worst.get(k, 0.0), v)
        del want
    for k in lim["limits"]:
        checks.add(k, worst[k])
    run.counters["diagnostics"] = {k: v for k, v in worst.items()
                                   if k not in lim["limits"]}
    return checks


def control(cell, seed, device):
    """The control: the reference in TF32 in the program's place, compared
    as `check` compares the program, on one object of the pool drawn from
    the seed."""
    model, rcfg = _reference_side(cell, seed, device)
    pool = make_pool(cell, device)
    rng = np.random.default_rng(H.seed_int(seed, 2))
    views = _check_views(rng, cell.traffic)
    obj = pool[int(rng.integers(len(pool)))]
    got = reference_request(model, rcfg, obj, views, tf32=True)
    want = reference_request(model, rcfg, obj, views)
    return {**compare(got, want, cell.limits["share_tol"]),
            **diagnostics(got, want)}
