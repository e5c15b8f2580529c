"""Per-scene fitting (loop `fit`): one call of `per_scene.fit_scene(caps=
"plan")` from the random init cloud, on a NeRF-synthetic-shaped scene
made from the seed (cameras on the upper hemisphere, targets ray-cast
from an analytic scene on the card).  The window is that call: the
harness's `gui` object, which fit_scene polls after every iteration,
counts the iterations and raises once `--seconds` have passed; the card
is then synchronised.  `scene_iters_per_s` is the iterations completed
over that time.

`correct` (the training rule, with fit_scene's own loop as the step):
the program's state is read where fit_scene hands control to the poll
(the caller's frame: the scene, the Adam state, the loss), and the
initial scene where `per_scene.init_scene` returns it.  The reference
(its frozen copy of the per-scene step: the plain render, L1 + D-SSIM,
autograd, the functional Adam) follows the first `check_steps` iterations
from the same init cloud and camera order and is compared by each step's
loss, the norm of each leaf's first gradient (from the Adam moments after
step 1) and the norm of each leaf's change after the steps.  The
densification stage, which the first steps do not reach, is checked by
itself: from the program's state after iteration `surgery_at - 1`, the
reference takes iteration `surgery_at` (its step, then its copy of the
clone / split / prune surgery with the program's random generator state)
and the scenes after the surgery are compared: the alive counts
(`surgery_gap`), and row by row every leaf of the rows alive
(`surgery_leaf_gap`, the worst leaf's max |gap| over its max; inf where
the two keep other rows alive, or another capacity).
"""
from __future__ import annotations

import copy
import sys
import time

import numpy as np
import torch

from .. import harness as H
from .. import inputs

LEAVES = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")
ADAM_B1 = 0.9


class State:
    pass


class WindowClosed(Exception):
    pass


def setup_inputs(cell, seed, device):
    """The cell's inputs, made by the benchmark and handed to both sides:
    the cameras, the ray-cast targets on the card, the random init cloud,
    the scene extent and fit_scene's seed."""
    from ..reference.cameras import Camera
    st = State()
    st.cell, st.seed, st.device = cell, seed, device
    st.traffic = cell.traffic
    sc = cell.config["scene"]
    c2ws = inputs.hemisphere_c2w(sc["views"], sc["radius"])
    st.cams = inputs.blender_cameras(Camera, c2ws, sc["camera_angle_x"],
                                     sc["resolution"], sc["resolution"])
    st.targets = torch.stack([inputs.raycast(c, device) for c in st.cams])
    # the scene is the mix's (its data seed); the run's seed orders the
    # cameras and draws the surgery's samples
    rng = np.random.default_rng(cell.traffic["data_seed"])
    st.points, st.colors = inputs.random_init(rng, sc["init_points"])
    st.extent = inputs.nerfpp_radius(st.cams)
    st.fit_seed = H.seed_int(seed, 5)
    return st


def setup(cell, seed, device, tracer, spans):
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.train import per_scene as PS

    if torch.device(device).type == "cuda":
        cuda_raster.load()
    st = setup_inputs(cell, seed, device)
    st.tracer, st.spans = tracer, spans
    st.cfg = PS.PerSceneConfig(**H.fields(cell.config["per_scene"]))
    # warm-up: the same call for a few iterations (kernels, cuDNN, the
    # KNN init, the cap planner)
    PS.fit_scene(st.cams, st.targets, st.points, st.colors,
                 st.cfg._replace(iterations=st.traffic["warmup_iters"]),
                 extent=st.extent, seed=st.fit_seed, device=device,
                 caps="plan")
    H.card_sync(device)
    return st


class Poll:
    """The `gui` fit_scene polls after every iteration: it counts them,
    captures what the check reads from fit_scene's frame, brackets the
    profiled iterations, and ends the window."""

    def __init__(self, st, seconds):
        self.st, self.seconds = st, seconds
        self.t0 = time.perf_counter()
        self.it = 0
        self.steps = {}        # it -> (scene, loss) for it <= check_steps
        self.mu1 = None        # Adam first moments after iteration 1
        self.before = None     # the state after iteration surgery_at - 1
        self.after = None      # the scene after iteration surgery_at

    def poll(self, render_fn, *args, **kwargs):
        st, t = self.st, self.st.traffic
        f = sys._getframe(1).f_locals
        it = self.it = int(f["it"])
        if it <= t["check_steps"]:
            self.steps[it] = (f["scene"], f["aux"]["loss"])
            if it == 1:
                self.mu1 = f["opt"].mu
        if it == t["surgery_at"] - 1:
            self.before = {"scene": f["scene"], "opt": f["opt"],
                           "stats": f["stats"], "run_cfg": f["run_cfg"],
                           "stack": list(f["viewpoint_stack"]),
                           "rng": copy.deepcopy(f["rng"])}
        if it == t["surgery_at"]:
            self.after = f["scene"]
        if st.tracer.enabled:
            if it == t["trace_from"]:
                st.tracer.start()
            elif it == t["trace_from"] + t["trace_iters"]:
                st.tracer.stop()
        # the window closes at the first iteration after `seconds` that
        # leaves the surgery the check reads, and the profiled part, behind
        if (time.perf_counter() - self.t0 >= self.seconds
                and it >= t["surgery_at"]
                and (not st.tracer.enabled or st.tracer.done)):
            raise WindowClosed
        return False


def window(st, seconds, run):
    from f3d_gaus_torch.ops import rasterize
    from f3d_gaus_torch.train import per_scene as PS

    captured = {}
    init_scene = PS.init_scene

    def keep_init(*a, **k):
        captured["scene0"] = init_scene(*a, **k)
        return captured["scene0"]
    PS.init_scene = keep_init
    if st.tracer.enabled:
        st.spans.wrap(rasterize, "prepare", "bench.prepare")
        st.spans.wrap(rasterize, "composite", "bench.composite")
        st.spans.wrap(PS, "densify_and_prune", "bench.surgery")
    timings = {} if st.tracer.enabled else None
    poll = Poll(st, seconds)
    try:
        PS.fit_scene(st.cams, st.targets, st.points, st.colors, st.cfg,
                     extent=st.extent, seed=st.fit_seed, gui=poll,
                     device=st.device, timings=timings, caps="plan")
    except WindowClosed:
        pass
    finally:
        PS.init_scene = init_scene
        st.spans.close()
    H.card_sync(st.device)
    elapsed = time.perf_counter() - poll.t0 - st.tracer.overhead_s
    st.poll, st.scene0 = poll, captured.get("scene0")
    run.counters["iterations"] = poll.it
    run.counters["window_s"] = elapsed
    if timings is not None:
        run.spans["fit_s"] = timings
    if st.tracer.enabled:
        run.counts["trace_iters"] = st.traffic["trace_iters"]
    return {"values": {"scene_iters_per_s": poll.it / elapsed},
            "attempted": poll.it, "failed": 0}


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

def _reference_side(st):
    from ..reference import per_scene as RPS
    cfg = RPS.PerSceneConfig(**H.fields(st.cell.config["per_scene"]))
    return RPS, cfg, st.cams


def _leaves(scene):
    return {k: getattr(scene, k) for k in LEAVES}


def _step(RPS, scene, opt, stats, cams, targets, v, cfg, it, bg):
    cam = cams[v]
    active_sh = min(it // cfg.sh_degree_interval, cfg.sh_degree)
    return RPS.train_step(scene, opt, stats, (cam.world_view, cam.full_proj,
                                               cam.cam_center),
                          targets[v], bg, cfg, active_sh,
                          (cam.width, cam.height, cam.tan_fovx, cam.tan_fovy))


def _bf16(scene):
    """The scene's leaves rounded to bfloat16 (held in float32)."""
    return scene._replace(**{k: getattr(scene, k).bfloat16().float()
                             for k in LEAVES})


def reference_steps(st, n, bf16_state=False):
    """The reference's first n iterations from the init cloud: each step's
    loss, the first gradient by leaf (from the Adam moments after step 1),
    the initial and the final scene.  With `bf16_state` (the control) the
    scene's parameters are held in bfloat16: rounded at init and after
    every step."""
    RPS, cfg, cams = _reference_side(st)
    dev = st.device
    bg = torch.zeros(3, device=dev)
    keep = _bf16 if bf16_state else (lambda x: x)
    scene = keep(RPS.init_scene(st.points, st.colors, cfg, device=dev))
    scene0 = scene
    opt, stats = RPS.init_adam(scene), RPS.init_stats(scene)
    run_cfg = cfg._replace(**RPS.plan_caps(
        RPS.needed_caps(scene, cams, cfg), cfg))
    rng = np.random.default_rng(st.fit_seed)
    stack: list = []
    losses, mu1 = [], None
    for it in range(1, n + 1):
        if not stack:
            stack = list(rng.permutation(len(cams)))
        v = int(stack.pop())
        scene, opt, stats, aux = _step(RPS, scene, opt, stats, cams,
                                       st.targets, v, run_cfg, it, bg)
        scene = keep(scene)
        if bool(aux["overflow"]):
            raise RuntimeError("the reference's planned caps truncated")
        losses.append(float(aux["loss"]))
        if it == 1:
            mu1 = opt.mu
    return {"losses": losses,
            "grads": {k: getattr(mu1, k) / (1 - ADAM_B1) for k in LEAVES},
            "scene0": _leaves(scene0), "scene": _leaves(scene)}


def program_steps(st, n):
    poll = st.poll
    if len(poll.steps) < n or st.scene0 is None:
        raise RuntimeError(f"the window ended after {poll.it} iterations, "
                           f"before the {n} the check follows")
    return {"losses": [float(poll.steps[i][1]) for i in range(1, n + 1)],
            "grads": {k: getattr(poll.mu1, k) / (1 - ADAM_B1)
                      for k in LEAVES},
            "scene0": _leaves(st.scene0), "scene": _leaves(poll.steps[n][0])}


def compare_steps(got, want):
    """loss_gap: the worst step's relative loss gap; grad_gap and
    change_gap: by the worst leaf, the gap between the program's norm and
    the reference's, over the larger of the reference's norm of that leaf
    and of the median leaf.  Leaves whose reference gradient is under a
    thousandth of the median leaf's are left out of both (they move under
    Adam by round-off alone)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                        want["losses"]))
    gn = {k: float(want["grads"][k].double().norm()) for k in LEAVES}
    med_g = float(np.median(list(gn.values())))
    kept = [k for k in LEAVES if gn[k] >= 1e-3 * med_g]

    def gap(norm_got, norm_want):
        med = float(np.median([norm_want[k] for k in kept]))
        return max(abs(norm_got[k] - norm_want[k]) / max(norm_want[k], med)
                   for k in kept)
    grad_gap = gap({k: float(got["grads"][k].double().norm()) for k in kept},
                   gn)

    def change(side):
        return {k: float((side["scene"][k].double()
                          - side["scene0"][k].double()).norm())
                for k in kept}
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": gap(change(got), change(want)),
            "left_out": [k for k in LEAVES if k not in kept]}


def reference_surgery(st, bf16_state=False):
    """Iteration surgery_at from the program's state after the one
    before: the reference's step, then its surgery, with the program's
    camera stack and random generator.  Returns the scene after it.  With
    `bf16_state` (the control of this stage) the state's leaves are
    rounded to bfloat16 first and after the step."""
    RPS, cfg, cams = _reference_side(st)
    b = st.poll.before
    it = st.traffic["surgery_at"]
    run_cfg = cfg._replace(pair_cap=b["run_cfg"].pair_cap,
                           max_per_tile=b["run_cfg"].max_per_tile)
    rng, stack = copy.deepcopy(b["rng"]), list(b["stack"])
    keep = _bf16 if bf16_state else (lambda x: x)
    scene = keep(RPS.SceneParams(*b["scene"]))
    opt = RPS.AdamState(RPS.SceneParams(*b["opt"].mu),
                        RPS.SceneParams(*b["opt"].nu), b["opt"].step)
    stats = RPS.SceneStats(*b["stats"])
    if not stack:
        stack = list(rng.permutation(len(cams)))
    v = int(stack.pop())
    scene, opt, stats, _ = _step(RPS, scene, opt, stats, cams, st.targets,
                                 v, run_cfg, it,
                                 torch.zeros(3, device=st.device))
    scene, opt, stats = RPS.densify_and_prune(
        keep(scene), opt, stats, cfg, st.extent,
        prune_big=it > cfg.opacity_reset_interval, rng=rng)
    return scene


def surgery_leaf_gap(got, want, rows="same"):
    """The worst leaf's max |gap| over its max on the rows alive; inf
    where the capacities differ, or (rows "same") the alive rows.  With
    rows "both", over the rows alive on both sides (a reading only)."""
    if got.alive.shape != want.alive.shape:
        return float("inf")
    if rows == "same" and not bool(torch.equal(got.alive, want.alive)):
        return float("inf")
    m = got.alive & want.alive
    return max(H.max_rel_gap(getattr(got, k)[m], getattr(want, k)[m])
               for k in LEAVES)


def check(st, run):
    n, lim = st.traffic["check_steps"], st.cell.limits
    checks = H.Checks(lim["limits"])
    got = program_steps(st, n)
    if torch.device(st.device).type == "cuda":
        torch.cuda.empty_cache()
    nums = compare_steps(got, reference_steps(st, n))
    if st.poll.after is None:
        raise RuntimeError(f"the window ended after {st.poll.it} "
                           "iterations, before the surgery the check reads")
    after_r = reference_surgery(st)
    alive_p = int(st.poll.after.alive.sum())
    alive_r = int(after_r.alive.sum())
    nums["surgery_gap"] = abs(alive_p - alive_r) / alive_r
    nums["surgery_leaf_gap"] = surgery_leaf_gap(st.poll.after, after_r)
    for k in lim["limits"]:
        checks.add(k, nums[k])
    # the surgery left out (its state returned unchanged) would read
    # |alive before - alive_r| / alive_r
    alive_b = int(st.poll.before["scene"].alive.sum())
    run.counters["diagnostics"] = {
        "left_out": nums["left_out"],
        "alive_program": alive_p, "alive_reference": alive_r,
        "surgery_unchanged_reads": abs(alive_b - alive_r) / alive_r}
    return checks


def state_control(st):
    """The control of the surgery stage, from the program's state after
    a window (for calibrate.py): the reference's iteration surgery_at
    from that state held in bfloat16, against it in float32."""
    got, want = reference_surgery(st, bf16_state=True), reference_surgery(st)
    return {"surgery_leaf_gap": surgery_leaf_gap(got, want),
            "surgery_leaf_gap_both_alive": surgery_leaf_gap(got, want,
                                                            "both"),
            "surgery_gap": abs(int(got.alive.sum()) - int(want.alive.sum()))
            / int(want.alive.sum())}


def control(cell, seed, device):
    """The control: the reference with the scene held in bfloat16 in the
    program's place for the first check_steps iterations, compared as
    `check` compares the program.  (The per-scene step runs nothing on
    the tensor cores, so TF32 would change no number: bfloat16 is the
    next precision below the configuration's float32 there.)"""
    st = setup_inputs(cell, seed, device)
    n = cell.traffic["check_steps"]
    return compare_steps(reference_steps(st, n, bf16_state=True),
                         reference_steps(st, n))
