"""Pose-free scene reconstruction serving (loop `unposed`): one scene per
request, closed loop, one client, each request through
`reconstruct.run_gslrm` with AnySplat and no input cameras (its forward
over the scene's views, its predicted cameras, depth, pixel Gaussians and
voxel merge, then `targets` renders at the predicted cameras of inputs
k V / targets, each at its own tangents, at caps planned from the merged
set).  A request's views are loop `scene`'s (scene.make_pool: ray-cast
from the analytic scene on a closed loop at a per-scene azimuth offset
and radius jitter), at the configuration's square frame; the model is
given the images alone.

The pool is small and served once in set-up; the window cycles through
it in orders drawn from the run's seed and closes as loop `scene`'s does.
`nvs_images_per_s` counts one served scene as one image.

`correct`: one request of the window, drawn from the run's seed as the
window goes (one kept at a time), is recomputed after the window, with
the program freed, by the reference (benchmark/reference/anysplat.py from
the same seeded weights at the published widths; its renders through the
reference's plain rasterizer, reference/rasterize.py:render, at the caps
its plan_caps finds, at its own predicted cameras and tangents) and
compared (each `_gap` the max gap over the max): `patch_gap`, DINOv2's
patch tokens; `token_gap`, the last aggregator pair's 2048-wide tokens;
`pose_gap`, the 24 pose encodings; `depth_gap`, the depth maps;
`voxel_share`, the share of pixel Gaussians whose voxel key differs from
the reference's; `gauss_share` and `gauss_mean`, the merged Gaussians at
the voxels both sets hold (as loop `scene`'s); `nvs_share` and
`nvs_mean`, `check_views` target renders (the first and views drawn from
the seed) against the reference's renders of its own merged set;
`truncated`, renders the caps truncated.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import harness as H
from .. import weights
from ..counts_anysplat import attention_bound, forward_flops
from . import scene

GAUSS_FIELDS = ("xyz", "opacity", "scaling", "rotation", "features_dc")
IMAGE_FIELDS = ("render", "rendered_alpha", "rendered_depth")
# the published widths run on a card; a CPU run is for the tests' sizes
CPU_TOKENS = 4096


class State:
    pass


def make_pool(cell, device):
    """The mix's scenes (scene.make_pool's views at the square frame)."""
    model = cell.config["model"]
    r = model["resolution"]
    shim = cell._replace(config={**cell.config, "model": {
        "frame_width": r, "frame_height": r, "views": model["views"]}})
    return scene.make_pool(shim, device)


def reference_anysplat(model: dict, seed: int, device):
    """The reference AnySplat at the configuration's widths, its weights
    drawn from `seed` (one stream of normals) on `device`."""
    from ..reference import anysplat as RA
    cfg = RA.AnySplatConfig(**H.fields(model))
    return weights._built(lambda g: RA.AnySplat(cfg, g), seed, device,
                          normal=True)


def program_anysplat(model: dict, state_dict: dict, device):
    """The program's AnySplat holding `state_dict`."""
    from f3d_gaus_torch.models import anysplat as A
    with torch.device(device):
        m = A.AnySplat(A.AnySplatConfig(**H.fields(model)), None)
    m.load_state_dict(state_dict)
    return m.to(device).eval()


def setup(cell, seed, device, tracer, spans):
    # a program without AnySplat stops here, at once
    from f3d_gaus_torch.models import anysplat as A
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.pipeline import config as C
    from f3d_gaus_torch.pipeline import reconstruct as R

    st = State()
    st.cell, st.seed, st.device = cell, seed, device
    st.tracer, st.spans = tracer, spans
    st.traffic = t = cell.traffic
    model = cell.config["model"]
    on_card = torch.device(device).type == "cuda"
    if not on_card and A.AnySplatConfig(
            **H.fields(model)).tokens > CPU_TOKENS:
        raise RuntimeError("this configuration's shape needs a CUDA card")
    ref = reference_anysplat(model, H.seed_int(seed, 1), device)
    st.model = program_anysplat(model, ref.state_dict(), device)
    del ref
    if on_card:
        cuda_raster.load()
    st.cfg = C.PipelineConfig(**H.fields(cell.config["render"]))
    st.targets = cell.config["cameras"]["targets"]
    st.pool = make_pool(cell, device)
    rng = np.random.default_rng(H.seed_int(seed, 2))
    st.order = np.concatenate([rng.permutation(len(st.pool))
                               for _ in range(t["max_cycles"])])
    st.views = scene._check_views(rng, cell)
    # DINOv2's patch tokens, the aggregator's kept pairs and the depth
    # maps of the last forward, for the check
    st.seen = {}
    st.model.aggregator.patch_embed.register_forward_hook(
        lambda mod, args, out: st.seen.__setitem__("patch", out))
    st.model.aggregator.register_forward_hook(
        lambda mod, args, out: st.seen.__setitem__(
            "tokens", out[st.model.cfg.depth - 1]))
    st.model.depth_head.register_forward_hook(
        lambda mod, args, out: st.seen.__setitem__(
            "depth", torch.exp(out[:, :, 0])))
    st.replans = []
    for obj in st.pool:
        st.cfg = R.run_gslrm(st.model, st.cfg, obj.images, device=device,
                             log=st.replans.append).cfg
    st.seen.clear()
    H.card_sync(device)
    return st


def _keep(st, res):
    """What the check reads of one request's outputs: the program's
    pixel Gaussians' voxel keys come from its own unprojection of its
    depth maps through its predicted cameras."""
    from f3d_gaus_torch.models import anysplat as A
    voxel = st.model.cfg.voxel
    xyz = A.unproject(st.seen["depth"], res.cameras)
    return {"patch": st.seen["patch"], "tokens": st.seen["tokens"],
            "pose": res.cameras["pose_enc"], "depth": st.seen["depth"],
            "keys": torch.floor(xyz.reshape(-1, 3) / voxel).long(),
            "voxels": res.gaussians["voxels"][0],
            "gauss": {k: res.gaussians[k][0] for k in GAUSS_FIELDS},
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
        res = R.run_gslrm(st.model, st.cfg, obj.images, timings=timings,
                          device=st.device, log=st.replans.append)
        H.card_sync(st.device)
        if tracing and n == trace_at:
            st.tracer.stop()
        st.cfg = res.cfg
        if pick.integers(n + 1) == 0:
            st.kept, st.kept_at = None, n
            st.kept = _keep(st, res)
        st.seen.clear()
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
    bound = attention_bound(model)
    run.counts["attn_bound_ms"] = bound["bound_ms"]
    run.counts["attn_calls"] = bound["calls"]
    if tracing:
        run.spans["stage_s"] = stages
    return {"values": {"nvs_images_per_s": n / elapsed},
            "attempted": n, "failed": 0}


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

def reference_renders(g, cams: dict, render: dict, targets: int, views,
                      tf32=False):
    """The reference's plain renders of element 0 of `g` at its predicted
    cameras of inputs k V / targets, k in `views`, each at its own
    tangents and at the caps the reference's plan_caps finds for it."""
    from ..reference import rasterize as RZ
    from ..reference.cameras import Camera
    V = cams["world_view"].shape[1]
    g0 = [g[k][0] for k in ("xyz", "scaling", "rotation", "opacity")]
    shs = g["features_dc"][0]
    bg = torch.zeros(3, device=shs.device)
    out = {k: [] for k in IMAGE_FIELDS}
    res = render["resolution"]

    def host(name, i):
        return cams[name][0, i].float().cpu().numpy()
    with H.precision(tf32):
        for k in views:
            i = k * V // targets
            cam = Camera(host("world_view", i), host("full_proj", i),
                         host("cam_centers", i), res, res,
                         float(cams["tan_fovx"][0, i]),
                         float(cams["tan_fovy"][0, i]))
            r = RZ.render(*g0, shs, cam, bg, sh_degree=0,
                          kernel_size=render["kernel_size"],
                          chunk=render["chunk"], **RZ.plan_caps(*g0, cam))
            if bool(r["overflow"]):
                raise RuntimeError(
                    "the reference's planned caps truncated a render")
            for f in IMAGE_FIELDS:
                out[f].append(r[f])
    return {k: torch.stack(v)[None] for k, v in out.items()}


@torch.no_grad()
def reference_request(model, render: dict, targets: int, obj, views,
                      tf32=False):
    """One request recomputed by the reference: what `_keep` reads, the
    renders at `views` of its own merged set at its own cameras."""
    with H.precision(tf32):
        g, aux = model(obj.images)
    nvs = reference_renders(g, g["cameras"], render, targets, views, tf32)
    return {"patch": aux["patch_tokens"], "tokens": aux["tokens"],
            "pose": g["cameras"]["pose_enc"], "depth": aux["depth"],
            "keys": aux["pixels"]["keys"], "voxels": g["voxels"][0],
            "gauss": {k: g[k][0] for k in GAUSS_FIELDS}, "nvs": nvs,
            "truncated": 0}


def common_voxels(a, b):
    """Indices (ia, ib) of the rows of key tables a (Ka, 3) and b (Kb, 3)
    that hold the same key."""
    uniq, inv = torch.unique(torch.cat([a, b]), dim=0, return_inverse=True)
    at_b = torch.full((uniq.shape[0],), -1, dtype=torch.int64,
                      device=a.device)
    at_b[inv[a.shape[0]:]] = torch.arange(b.shape[0], device=a.device)
    match = at_b[inv[:a.shape[0]]]
    ia = torch.nonzero(match >= 0)[:, 0]
    return ia, match[ia]


def compare(got, want, tol):
    """The numbers compared for one request (see the module docstring)."""
    ia, ib = common_voxels(got["voxels"], want["voxels"])
    g = {k: got["gauss"][k][ia] for k in GAUSS_FIELDS}
    w = {k: want["gauss"][k][ib] for k in GAUSS_FIELDS}
    return {
        "patch_gap": H.max_rel_gap(got["patch"], want["patch"]),
        "token_gap": H.max_rel_gap(got["tokens"], want["tokens"]),
        "pose_gap": H.max_rel_gap(got["pose"], want["pose"]),
        "depth_gap": H.max_rel_gap(got["depth"], want["depth"]),
        "voxel_share": float((got["keys"] != want["keys"]).any(-1)
                             .double().mean()),
        "gauss_share": max(H.share_off(g[k], w[k], tol)
                           for k in GAUSS_FIELDS),
        "gauss_mean": max(H.mean_rel_gap(g[k], w[k]) for k in GAUSS_FIELDS),
        "nvs_share": max(H.share_off(got["nvs"][k], want["nvs"][k], tol)
                         for k in IMAGE_FIELDS),
        "nvs_mean": max(H.mean_rel_gap(got["nvs"][k], want["nvs"][k])
                        for k in IMAGE_FIELDS),
        "truncated": got["truncated"],
    }


def diagnostics(got, want):
    """Widest gaps and the merge's sizes, printed beside the numbers
    compared (not compared)."""
    ia, ib = common_voxels(got["voxels"], want["voxels"])
    return {"gauss_gap": max(H.max_rel_gap(got["gauss"][k][ia],
                                           want["gauss"][k][ib])
                             for k in GAUSS_FIELDS),
            "nvs_gap": max(H.max_rel_gap(got["nvs"][k], want["nvs"][k])
                           for k in IMAGE_FIELDS),
            "voxels": int(got["voxels"].shape[0]),
            "voxels_common": int(ia.shape[0]),
            "voxels_reference": int(want["voxels"].shape[0])}


def check(st, run):
    """Free the program, then recompute the kept request with the
    reference and compare."""
    del st.model
    st.seen.clear()
    if torch.device(st.device).type == "cuda":
        torch.cuda.empty_cache()
    lim = st.cell.limits
    model = reference_anysplat(st.cell.config["model"],
                               H.seed_int(st.seed, 1), st.device).eval()
    obj = st.pool[st.order[st.kept_at % len(st.order)]]
    want = reference_request(model, st.cell.config["render"], st.targets,
                             obj, st.views)
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
    model = reference_anysplat(cell.config["model"], H.seed_int(seed, 1),
                               device).eval()
    pool = make_pool(cell, device)
    rng = np.random.default_rng(H.seed_int(seed, 2))
    views = scene._check_views(rng, cell)
    obj = pool[int(rng.integers(len(pool)))]
    render, targets = cell.config["render"], cell.config["cameras"]["targets"]
    got = reference_request(model, render, targets, obj, views, tf32=True)
    want = reference_request(model, render, targets, obj, views)
    return {**compare(got, want, cell.limits["share_tol"]),
            **diagnostics(got, want)}
