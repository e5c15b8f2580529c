"""Per-scene Gaussian optimisation with densification (counterpart of
f3d_gaus_tpu/train/per_scene.py): the vendored 3DGS/GOF trainer
(reference train.py + scene/gaussian_model.py) driven by the GOF
rasterizer, with the JAX package's design kept:

  * the parameter store has a FIXED capacity with an `alive` mask; dead
    slots render with radii = 0 (culled before binning) and cost no pair
    capacity.  Capacity grows by `cap_bucket` rows when a densification
    needs more;
  * Adam is a small functional implementation (per-group learning rates,
    eps 1e-15, gradients masked to alive rows), so the surgery's optimiser
    edits are plain row writes: new rows get zeroed moments;
  * clone / split / prune run on the host in numpy every
    `densification_interval` steps, with the same rows, order and random
    draws as the JAX package;
  * the viewspace-gradient statistic arrives as the gradient of the
    renderer's `means2d_stats` dummy (on the card: K2's d_stats columns).

A training step renders through the compositing kernels (K1 forward, K2
backward) on CUDA tensors and through their plain versions on CPU
tensors.  It makes no host sync: the loss, the visible count and the
render's overflow flag stay on the device.  `fit_scene` reads them only
where the JAX package reads its values, at `log_every` and at surgery, and
at the end.  The JAX trainer drops the render's overflow flag, so a step
whose binning was truncated trains silently; the port trains the same way
but counts such steps (`hist["overflow_steps"]`).

The config's caps (`pair_cap`, `max_per_tile`) are the JAX package's and
suit 32^2 tests; at 800^2 they truncate every step.  `fit_scene(caps=
"plan")` sizes them from the scene instead (`needed_caps`, `plan_caps`):
at init and every `densification_interval` steps (so after each surgery),
over the alive rows at every training camera, times a headroom, never
below the config's.  A render that nothing truncates does not depend on
its caps, so where the config's caps suffice the arithmetic is unchanged.
"""
from __future__ import annotations

import math
import time
from typing import NamedTuple

import numpy as np
import torch

from ..core.cameras import Camera
from ..core.device import resolve_device
from ..core.quaternions import quat_to_rotmat
from ..ops import binning
from ..ops import knn as knn_ops
from ..ops import rasterize
from ..utils import profiling
from . import losses

SH_C0 = 0.28209479177387814
CAP_HEADROOM = 2.0       # planned caps: this times the scene's need


def inverse_sigmoid(x):
    return np.log(x / (1.0 - x))


class SceneParams(NamedTuple):
    """Raw (pre-activation) parameters, fixed capacity CAP rows."""
    xyz: torch.Tensor         # (CAP, 3)
    f_dc: torch.Tensor        # (CAP, 1, 3)
    f_rest: torch.Tensor      # (CAP, K-1, 3)
    opacity: torch.Tensor     # (CAP, 1)   raw; sigmoid activation
    scaling: torch.Tensor     # (CAP, 3)   raw; exp activation
    rotation: torch.Tensor    # (CAP, 4)   raw; normalize activation
    alive: torch.Tensor       # (CAP,) bool, not optimised


class SceneStats(NamedTuple):
    grad_accum: torch.Tensor  # (CAP,) sum of |viewspace grad xy|
    denom: torch.Tensor       # (CAP,) visibility counts
    max_radii2d: torch.Tensor  # (CAP,) float


class AdamState(NamedTuple):
    mu: SceneParams           # first moments (alive field unused)
    nu: SceneParams           # second moments
    step: torch.Tensor        # () int32


class PerSceneConfig(NamedTuple):
    """OptimizationParams defaults (arguments/__init__.py:71-90)."""
    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    min_opacity: float = 0.005
    max_screen_size: int = 20
    sh_degree: int = 3
    sh_degree_interval: int = 1000       # +1 active degree per 1000 its
    kernel_size: float = 0.0
    # renderer caps
    pair_cap: int = 1 << 18
    max_per_tile: int = 512
    chunk: int = 128
    cap_bucket: int = 4096               # capacity growth granularity


def _round_cap(n: int, bucket: int) -> int:
    return max(((n + bucket - 1) // bucket) * bucket, bucket)


def _np(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if torch.is_tensor(x)
            else np.asarray(x, np.float32))


def _to_np(tree):
    return type(tree)(*[_np(t) for t in tree])


def _to_dev(tree, dev):
    return type(tree)(*[torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                        for a in tree])


def init_scene(points, colors, cfg: PerSceneConfig, cap: int | None = None,
               device=None) -> SceneParams:
    """create_from_pcd semantics (scene/gaussian_model.py:124-147):
    f_dc = RGB2SH(color), scales from the 3-NN mean distance (ops/knn.py,
    on the device), identity rotation, opacity 0.1.  Runs on `device`
    (default: that of `points` if a tensor, else `cuda`)."""
    dev = resolve_device(device, points if torch.is_tensor(points) else None)
    points = _np(points).astype(np.float32)
    P = len(points)
    cap = cap or _round_cap(P, cfg.cap_bucket)
    K = (cfg.sh_degree + 1) ** 2

    xyz = np.zeros((cap, 3), np.float32)
    xyz[:P] = points
    f_dc = np.zeros((cap, 1, 3), np.float32)
    f_dc[:P, 0] = (_np(colors).astype(np.float32) - 0.5) / SH_C0   # RGB2SH
    f_rest = np.zeros((cap, K - 1, 3), np.float32)
    opacity = np.full((cap, 1), inverse_sigmoid(0.1), np.float32)
    rotation = np.zeros((cap, 4), np.float32)
    rotation[:, 0] = 1.0
    alive = np.zeros(cap, bool)
    alive[:P] = True
    scaling = torch.full((cap, 3), -10.0, device=dev)
    scaling[:P] = knn_ops.initial_log_scales(torch.from_numpy(points).to(dev))
    t = _to_dev(SceneParams(xyz, f_dc, f_rest, opacity, xyz, rotation,
                            alive), dev)
    return t._replace(scaling=scaling)


def init_adam(scene: SceneParams) -> AdamState:
    def zeros():
        return SceneParams(*[torch.zeros_like(t) for t in scene])
    return AdamState(zeros(), zeros(),
                     torch.zeros((), dtype=torch.int32,
                                 device=scene.xyz.device))


def init_stats(scene: SceneParams) -> SceneStats:
    cap, dev = scene.xyz.shape[0], scene.xyz.device
    return SceneStats(*[torch.zeros(cap, device=dev) for _ in range(3)])


def expon_lr(step, lr_init, lr_final, delay_mult, max_steps):
    """Plenoxels/JaxNeRF log-linear decay (utils/general_utils.py:29-61);
    the trainer runs with lr_delay_steps=0 so no delay ramp applies.
    `step` is a float32 tensor (or a number)."""
    t = torch.clamp(torch.as_tensor(step, dtype=torch.float32) / max_steps,
                    0.0, 1.0)
    return torch.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)


def activated(scene: SceneParams) -> dict:
    """Activation functions of GaussianModel (scene/gaussian_model.py:26-59)."""
    rot = scene.rotation / (torch.linalg.norm(scene.rotation, dim=-1,
                                              keepdim=True) + 1e-12)
    return {
        "xyz": scene.xyz,
        "scaling": torch.exp(scene.scaling),
        "rotation": rot,
        "opacity": torch.sigmoid(scene.opacity),
        "shs": torch.cat([scene.f_dc, scene.f_rest], 1),
    }


def render_scene(scene: SceneParams, camera, cfg: PerSceneConfig, bg,
                 active_sh_degree: int, means2d_stats=None,
                 scale_modifier: float = 1.0):
    """rasterize.render of the live scene, dead rows culled by the mask."""
    g = activated(scene)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=scene.xyz.device)
    return rasterize.render(
        g["xyz"], g["scaling"], g["rotation"], g["opacity"], g["shs"],
        camera, bg, sh_degree=active_sh_degree,
        kernel_size=cfg.kernel_size, scale_modifier=scale_modifier,
        pair_cap=cfg.pair_cap, max_per_tile=cfg.max_per_tile,
        chunk=cfg.chunk, means2d_stats=means2d_stats, mask=scene.alive)


@torch.no_grad()
def needed_caps(scene: SceneParams, cameras, cfg: PerSceneConfig) -> dict:
    """What the scene's alive rows need at `cameras`, at most over them:
    {'pairs': the (Gaussian, tile) pair count, 'tile': the fullest tile's
    Gaussians}, both exact: binning.footprint_need of the alive rows for
    each group of cameras that share a size and field of view.  Dead rows,
    which the render culls, add no pair.  No binning; one host read a
    group."""
    g = activated(scene)
    alive = [g[k][scene.alive][None] for k in ("xyz", "scaling", "rotation")]
    groups: dict = {}
    for cam in cameras:
        groups.setdefault((cam.width, cam.height, cam.tan_fovx,
                           cam.tan_fovy), []).append(cam)
    needs = [binning.footprint_need(
        *alive, np.stack([c.world_view for c in cams]),
        np.stack([c.full_proj for c in cams]), cams[0], cfg.kernel_size)
        for cams in groups.values()]
    return {k: max(n[k] for n in needs) for k in ("pairs", "tile")}


def plan_caps(need: dict, cfg: PerSceneConfig) -> dict:
    """Caps for `need` (needed_caps) times CAP_HEADROOM, never below the
    config's: pair_cap rounded up to binning.suggest_pair_cap's bucket,
    max_per_tile to a multiple of 256 (the slab's wide alignment)."""
    pairs = binning.suggest_pair_cap(math.ceil(need["pairs"] * CAP_HEADROOM))
    tile = -(-math.ceil(need["tile"] * CAP_HEADROOM) // 256) * 256
    return {"pair_cap": max(cfg.pair_cap, pairs),
            "max_per_tile": max(cfg.max_per_tile, tile)}


def _loss_fn(diff_params, alive, stats_in, camera, target, bg,
             cfg: PerSceneConfig, active_sh_degree: int):
    scene = SceneParams(*diff_params, alive=alive)
    out = render_scene(scene, camera, cfg, bg, active_sh_degree,
                       means2d_stats=stats_in)
    img = out["render"][None]
    tgt = target[None]
    l1 = losses.l1(img, tgt)
    ssim_v = losses.ssim(img, tgt)
    loss = (1.0 - cfg.lambda_dssim) * l1 + cfg.lambda_dssim * (1.0 - ssim_v)
    return loss, l1, out


@profiling.spanned("fit_step")
def train_step(scene: SceneParams, opt: AdamState, stats: SceneStats,
               cam_arrays, target, bg, cfg: PerSceneConfig,
               active_sh_degree: int, cam_statics, timings=None):
    """One optimisation step: render, L1 + lambda (1 - SSIM)
    (train.py:91-93), functional Adam with per-group learning rates, and
    the densification statistics.  Returns new (scene, opt, stats, aux);
    aux holds device tensors: loss, l1, n_visible and overflow.

    cam_arrays = (world_view, full_proj, cam_center) numpy;
    cam_statics = (width, height, tan_fovx, tan_fovy).  `timings`: a dict
    that receives the forward, backward and Adam milliseconds from CUDA
    events (one sync at the end of the step; none without it).  While
    tracing is on (utils.profiling) the step is a root span `fit_step`
    with children `forward`, `backward` and `adam`, `timings` or not.
    """
    dev = scene.xyz.device
    clock = profiling.StageClock(dev, timings, unit="ms")
    camera = Camera(*cam_arrays, *cam_statics)
    cap = scene.xyz.shape[0]
    diff = [t.detach().requires_grad_() for t in tuple(scene)[:-1]]
    stats_in = torch.zeros((cap, 3), device=dev, requires_grad=True)
    loss, l1, out = _loss_fn(diff, scene.alive, stats_in, camera, target, bg,
                             cfg, active_sh_degree)
    clock.lap("forward")
    *g_scene, g_stats = torch.autograd.grad(loss, diff + [stats_in])
    clock.lap("backward")

    with torch.no_grad():
        step = opt.step + 1
        tf = step.float()
        lrs = (expon_lr(tf, cfg.position_lr_init, cfg.position_lr_final,
                        cfg.position_lr_delay_mult,
                        cfg.position_lr_max_steps),
               cfg.feature_lr, cfg.feature_lr / 20.0, cfg.opacity_lr,
               cfg.scaling_lr, cfg.rotation_lr)
        b1, b2, eps = 0.9, 0.999, 1e-15
        bc1, bc2 = 1 - b1 ** tf, 1 - b2 ** tf
        new_p, new_m, new_v = [], [], []
        for p, g, m, v, lr in zip(scene, g_scene, opt.mu, opt.nu, lrs):
            g = torch.where(scene.alive.reshape((-1,) + (1,) * (p.dim() - 1)),
                            g, 0.0)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mhat = m / bc1
            vhat = v / bc2
            new_p.append(p - lr * mhat / (torch.sqrt(vhat) + eps))
            new_m.append(m)
            new_v.append(v)
        alive = scene.alive
        new_scene = SceneParams(*new_p, alive=alive)
        new_opt = AdamState(SceneParams(*new_m, alive=opt.mu.alive),
                            SceneParams(*new_v, alive=opt.nu.alive), step)

        radii = out["radii"]
        visible = radii > 0
        vs_norm = torch.sqrt(g_stats[:, 0] ** 2 + g_stats[:, 1] ** 2)
        new_stats = SceneStats(
            grad_accum=stats.grad_accum + torch.where(visible, vs_norm, 0.0),
            denom=stats.denom + visible.float(),
            max_radii2d=torch.maximum(
                stats.max_radii2d, torch.where(visible, radii.float(), 0.0)))
    clock.lap("adam")
    clock.close()
    return new_scene, new_opt, new_stats, {
        "loss": loss.detach(), "l1": l1.detach(), "n_visible": visible.sum(),
        "overflow": out["overflow"]}


# ---------------------------------------------------------------------------
# densification surgery (host-side numpy, every densification_interval steps)
# ---------------------------------------------------------------------------

def densify_and_prune(scene: SceneParams, opt: AdamState, stats: SceneStats,
                      cfg: PerSceneConfig, extent: float,
                      prune_big: bool, rng: np.random.Generator):
    """Clone + split + prune (scene/gaussian_model.py:349-403) on the
    fixed-capacity arrays, on the host; grows capacity by bucket when
    needed.  Returns (scene, opt, stats) on the scene's device, with stats
    reset (as the reference's prune path rebuilds its accumulators)."""
    dev = scene.xyz.device
    s = _to_np(scene)
    mu, nu = _to_np(opt.mu), _to_np(opt.nu)
    alive = s.alive.copy()

    denom = _np(stats.denom)
    grads = np.where(denom > 0, _np(stats.grad_accum) / np.maximum(denom, 1),
                     0.0)
    scalings = np.exp(s.scaling)
    max_scale = scalings.max(-1)
    hot = (grads >= cfg.densify_grad_threshold) & alive

    clone_m = hot & (max_scale <= cfg.percent_dense * extent)
    split_m = hot & (max_scale > cfg.percent_dense * extent)

    # --- build new rows ---------------------------------------------------
    new_fields = {k: [] for k in s._fields if k != "alive"}

    def push(sel_idx, xyz=None, scaling=None):
        for k in new_fields:
            v = getattr(s, k)[sel_idx]
            if k == "xyz" and xyz is not None:
                v = xyz
            if k == "scaling" and scaling is not None:
                v = scaling
            new_fields[k].append(v)

    # clones: verbatim copies (densify_and_clone :374-387)
    idx_c = np.where(clone_m)[0]
    if len(idx_c):
        push(idx_c)

    # splits: N=2 samples from N(0, scale) in the gaussian frame, scale /1.6
    # (densify_and_split :349-372); originals are pruned
    idx_s = np.where(split_m)[0]
    N = 2
    if len(idx_s):
        rep = np.repeat(idx_s, N)
        std = scalings[rep]
        samples = rng.normal(size=(len(rep), 3)).astype(np.float32) * std
        q = s.rotation[rep] / np.linalg.norm(s.rotation[rep], axis=-1,
                                             keepdims=True)
        R = quat_to_rotmat(torch.from_numpy(q)).numpy()
        new_xyz = np.einsum('pij,pj->pi', R, samples) + s.xyz[rep]
        new_scaling = np.log(np.maximum(scalings[rep] / (0.8 * N), 1e-10))
        push(rep, xyz=new_xyz, scaling=new_scaling)
        alive[idx_s] = False

    # prune: low opacity; optionally big-in-screen / big-in-world (:389-403)
    opac = 1.0 / (1.0 + np.exp(-s.opacity[:, 0]))
    prune = (opac < cfg.min_opacity) & alive
    if prune_big:
        prune |= (_np(stats.max_radii2d) > cfg.max_screen_size) & alive
        prune |= (max_scale > 0.1 * extent) & alive
    alive[prune] = False

    n_new = (int(np.concatenate(new_fields["xyz"]).shape[0])
             if new_fields["xyz"] else 0)

    # --- place new rows: reuse dead slots, grow capacity if short ---------
    need = int(alive.sum()) + n_new
    cap = len(alive)
    if need > cap:
        new_cap = _round_cap(need, cfg.cap_bucket)

        def grow(a):
            out = np.zeros((new_cap,) + a.shape[1:], a.dtype)
            out[:cap] = a
            return out
        s = SceneParams(*[grow(v) for v in s[:-1]], alive=grow(alive))
        mu = SceneParams(*[grow(v) for v in mu])
        nu = SceneParams(*[grow(v) for v in nu])
        alive = s.alive.copy()
        cap = new_cap
    else:
        s = s._replace(alive=alive.copy())

    if n_new:
        dead_slots = np.where(~alive)[0][:n_new]
        for k in new_fields:
            merged = np.concatenate(new_fields[k])[:len(dead_slots)]
            arr = getattr(s, k).copy()
            arr[dead_slots] = merged
            s = s._replace(**{k: arr})
            # zero optimizer state for new rows (cat_tensors_to_optimizer)
            m_arr = getattr(mu, k).copy()
            v_arr = getattr(nu, k).copy()
            m_arr[dead_slots] = 0
            v_arr[dead_slots] = 0
            mu = mu._replace(**{k: m_arr})
            nu = nu._replace(**{k: v_arr})
        alive[dead_slots] = True
        s = s._replace(alive=alive)

    scene_d = _to_dev(s, dev)
    opt_d = AdamState(_to_dev(mu, dev), _to_dev(nu, dev), opt.step)
    return scene_d, opt_d, init_stats(scene_d)


def reset_opacity(scene: SceneParams, opt: AdamState):
    """opacity <- min(opacity, inverse_sigmoid(0.01)); its Adam moments are
    zeroed (reset_opacity + replace_tensor_to_optimizer, :210-271)."""
    # the reset value becomes a new leaf: no gradient flows through it
    new_op = torch.clamp_max(scene.opacity,
                             float(np.float32(inverse_sigmoid(0.01))))
    scene = scene._replace(opacity=new_op)
    opt = AdamState(opt.mu._replace(opacity=torch.zeros_like(new_op)),
                    opt.nu._replace(opacity=torch.zeros_like(new_op)),
                    opt.step)
    return scene, opt


def fit_scene(cameras, targets, init_points, init_colors,
              cfg: PerSceneConfig, bg=None, extent: float | None = None,
              seed: int = 0, log_every: int = 0, gui=None, device=None,
              timings=None, caps: str = "fixed"):
    """Full training loop (train.py:51-132): random camera order, render,
    loss, densify/prune window, opacity resets, SH-degree warmup.

    cameras: list of core.cameras.Camera; targets: (V, 3, H, W) float32
    (array or tensor).  gui: optional utils.network_gui.NetworkGUI, polled
    every iteration with a live-scene render closure (train.py:52-65).
    Runs on `device` (default: that of `targets` if a tensor, else
    `cuda`).  `timings`: a dict that receives the seconds of the scene's
    init (KNN included), the steps and the surgery (the card synchronised
    around each surgery; no sync without it), and with planning the
    planning's.  While tracing is on (utils.profiling) each surgery and
    each plan is a root span (`surgery`, `plan`), `timings` or not.

    caps: "fixed" renders at cfg's caps (the JAX package's behaviour);
    "plan" plans them (plan_caps over needed_caps at every camera, with
    CAP_HEADROOM) at init and every cfg.densification_interval steps, and
    after an opacity reset.

    Returns (scene, hist): hist["loss"] / ["alive"] every `log_every`
    steps (as the JAX package), and, read at surgery or at the end,
    ["densify"] (iteration, alive rows and capacity after each surgery),
    ["step_loss"] (every step's loss), ["overflow_steps"] (steps whose
    render was truncated by the caps), ["caps"] (each plan: iteration,
    need and caps; empty with fixed caps) and ["plan_s"] (the seconds the
    plans took, the card synchronised before each).
    """
    if caps not in ("fixed", "plan"):
        raise ValueError(f"caps must be 'fixed' or 'plan', got {caps!r}")
    dev = resolve_device(device, targets if torch.is_tensor(targets)
                         else None)
    clock = profiling.StageClock(dev, timings, accumulate=True,
                                 spans={"surgery_s": "surgery",
                                        "plan_s": "plan"})

    rng = np.random.default_rng(seed)
    scene = init_scene(init_points, init_colors, cfg, device=dev)
    opt = init_adam(scene)
    stats = init_stats(scene)
    bg = torch.zeros(3, device=dev) if bg is None else torch.as_tensor(
        bg, dtype=torch.float32, device=dev)
    if extent is None:
        pts = _np(init_points)
        c = pts.mean(0)
        extent = float(np.linalg.norm(pts - c, axis=-1).max()) * 1.1
    targets = torch.as_tensor(targets, dtype=torch.float32, device=dev)
    step_loss = torch.zeros(cfg.iterations, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    clock.lap("init_s")

    hist = {"loss": [], "alive": [], "densify": [], "caps": [],
            "plan_s": 0.0}

    def replan(it):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        need = needed_caps(scene, cameras, cfg)
        planned = plan_caps(need, cfg)
        hist["plan_s"] += time.perf_counter() - t0
        hist["caps"].append({"it": it, **need, **planned})
        clock.lap("plan_s")
        return cfg._replace(**planned)

    plan = caps == "plan"
    run_cfg = replan(0) if plan else cfg
    # epoch-style sampling without replacement: the reference pops from a
    # reshuffled copy of the camera list (train.py:78-82 viewpoint_stack),
    # so no view starves on few-view scenes
    viewpoint_stack: list = []
    for it in range(1, cfg.iterations + 1):
        active_sh = min(it // cfg.sh_degree_interval, cfg.sh_degree)
        if not viewpoint_stack:
            viewpoint_stack = list(rng.permutation(len(cameras)))
        v = int(viewpoint_stack.pop())
        cam = cameras[v]
        scene, opt, stats, aux = train_step(
            scene, opt, stats, (cam.world_view, cam.full_proj,
                                cam.cam_center),
            targets[v], bg, run_cfg, active_sh,
            (cam.width, cam.height, cam.tan_fovx, cam.tan_fovy))
        step_loss[it - 1] = aux["loss"]
        overflow += aux["overflow"]

        if cfg.densify_from_iter < it < cfg.densify_until_iter \
                and it % cfg.densification_interval == 0:
            clock.lap("steps_s")
            scene, opt, stats = densify_and_prune(
                scene, opt, stats, cfg, extent,
                prune_big=it > cfg.opacity_reset_interval, rng=rng)
            hist["densify"].append({"it": it,
                                    "alive": int(scene.alive.sum()),
                                    "cap": int(scene.xyz.shape[0])})
            clock.lap("surgery_s")
        if it % cfg.opacity_reset_interval == 0 and it < cfg.densify_until_iter:
            scene, opt = reset_opacity(scene, opt)
        if plan and it < cfg.iterations and (
                it % cfg.densification_interval == 0
                or it % cfg.opacity_reset_interval == 0):
            clock.lap("steps_s")
            run_cfg = replan(it)

        if log_every and it % log_every == 0:
            hist["loss"].append(float(aux["loss"]))
            hist["alive"].append(int(scene.alive.sum()))
            hist["overflow_steps"] = int(overflow)
        if gui is not None:
            gui.poll(lambda vc: _gui_render(scene, vc, bg, run_cfg,
                                            active_sh))
    clock.lap("steps_s")
    hist["step_loss"] = step_loss.tolist()
    hist["overflow_steps"] = int(overflow)
    return scene, hist


def _gui_render(scene: SceneParams, viewer_cam: dict, bg, cfg, active_sh):
    """Render the live scene for a network_gui viewer camera dict (the
    viewer's custom_cam path, train.py:54-58).  The viewer's
    scaling_modifier drives the gaussian-scale slider; its z_near/z_far
    are honoured through the full_proj matrix it sends."""
    wv = viewer_cam["world_view"]
    cam = Camera(
        world_view=wv, full_proj=viewer_cam["full_proj"],
        cam_center=np.linalg.inv(wv)[3, :3].astype(np.float32),
        width=viewer_cam["width"], height=viewer_cam["height"],
        tan_fovx=float(np.tan(viewer_cam["fov_x"] / 2)),
        tan_fovy=float(np.tan(viewer_cam["fov_y"] / 2)))
    with torch.no_grad():
        out = render_scene(scene, cam, cfg, bg, active_sh,
                           scale_modifier=float(
                               viewer_cam.get("scaling_modifier", 1.0)))
    return out["render"].cpu().numpy()
