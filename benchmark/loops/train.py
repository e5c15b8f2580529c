"""Feed-forward training (loop `train`): `feedforward.train_step` at batch B
with the configuration's loss weights, the VGG16 and CLIP towers at full
width, `make_cameras_pack` / `Curriculum()` at their defaults and Adam at
the configuration's learning rate.  Each step takes the next B images of
a pool (smooth_rgbd from the mix's data seed), in cycles ordered by the
run's seed; a step whose renders overflow the caps doubles them and runs
again, as chip_smoke.py's training path does.

Set-up builds the one training state from the seeded weights and drives
it through its first `first_steps` steps (rows that all differ), through
the window's own call and feed; the window then carries on with the same
state and closes at the first step after `--seconds` that completes a
cycle through the pool (and not before `check_steps` steps), so every run
trains on each image equally often.  `train_images_per_s` is B times the
applied steps over that time.

`correct` (the training rule), in two parts.  The start: the reference
(frozen copies of the predictor, the towers, loss_fn with the plain
renders at exact caps, and torch's Adam) follows set-up's first
`check_steps` steps from the same seeded weights on the same batches.
The window: set-up's end state (parameters, Adam moments, step count) is
copied to the host before the window; the reference follows the window's
first `check_steps` steps from that copy on the same batches.  Each part
compares each step's loss (`loss_gap`, `window_loss_gap`), the norm of
each parameter's first gradient as Adam got it (from its first moment
before and after the step) by the median parameter (`grad_gap`,
`window_grad_gap`), and the norm of each parameter's change after the
compared steps by the worst parameter (`change_gap`,
`window_change_gap`).  The first gradient is taken by the median
parameter because by the worst one it swings from seed to seed: the
head's bias sums every pixel's gradient through K2, whose f32 decisions
flip on some pairs against the plain backward's.

Those decisions move a step's losses and gradients between any two f32
implementations about as much as TF32 convolutions do (the EDM-init
Gaussians sit at alpha = 1/255 on many pixels), so the arithmetic of the
predictor and the towers is also compared where no render lies in
between: `predict_gap`, the Gaussians of set-up's first predictor call,
and the replay of the window's first step.  That step records each
predictor call and each tower call on the render (its inputs, outputs
and the gradients that reached its outputs, and a tower's input
gradient); the reference runs the same calls from the copied state and
takes the same gradients back through them.  `replay_gap` is the worst
gap of their outputs (max |gap| over the field's max), `backward_gap` the
worst of each parameter's first gradient against the replay's (the norm
of the difference over the larger of the parameter's and the median
parameter's norm) and each tower's input gradient (the norm of the
difference over the reference's norm).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from .. import harness as H
from .. import inputs, weights

ADAM_B1 = 0.9
MAX_DOUBLINGS = 7


class State:
    pass


def _pool(cell, r, device):
    """The mix's images and depths, (pool, r, r, 3) and (pool, r, r), on
    the card."""
    t = cell.traffic
    rng = np.random.default_rng(t["data_seed"])
    images, depths = zip(*(inputs.smooth_rgbd(rng, r)
                           for _ in range(t["pool"])))
    return (torch.from_numpy(np.concatenate(images)).to(device),
            torch.from_numpy(np.concatenate(depths)).to(device))


def _order(cell, seed):
    t = cell.traffic
    rng = np.random.default_rng(H.seed_int(seed, 2))
    return np.concatenate([rng.permutation(t["pool"])
                           for _ in range(t["max_cycles"])])


def _batch(st, k):
    """The k-th step's batch (0-based)."""
    B = st.traffic["batch"]
    idx = torch.as_tensor(st.order[k * B:(k + 1) * B], device=st.device)
    return {"images": st.images[idx], "depth": st.depths[idx]}


def _named(model):
    return dict(model.named_parameters())


GAUSS_FIELDS = ("xyz", "opacity", "scaling", "rotation", "features_dc",
                "features_rest")


@contextlib.contextmanager
def first_call(model, into: dict):
    """`into` receives the Gaussians of the model's first forward call
    inside the block (detached copies)."""
    def hook(module, args, out):
        if not into:
            into.update({k: out[k].detach().clone() for k in GAUSS_FIELDS})
    handle = model.register_forward_hook(hook)
    try:
        yield into
    finally:
        handle.remove()


def predict_gap(got, want):
    """By the worst field, max |got - want| over max |want|; a batch of
    another shape reads inf."""
    if any(got[k].shape != want[k].shape for k in GAUSS_FIELDS):
        return float("inf")
    return max(H.max_rel_gap(got[k], want[k]) for k in GAUSS_FIELDS)


def _moments(model, optimizer):
    """Each parameter's Adam first moment, copied to the host (zeros
    before the first step)."""
    return {n: (optimizer.state[p]["exp_avg"] if p in optimizer.state
                else torch.zeros_like(p)).detach().to("cpu", copy=True)
            for n, p in _named(model).items()}


def _first_grads(m0, m1):
    """Each parameter's gradient as Adam got it, from its first moment
    before (m0) and after (m1) the step: m1 = b1 m0 + (1 - b1) g."""
    return {n: (m1[n].double() - ADAM_B1 * m0[n].double()) / (1 - ADAM_B1)
            for n in m1}


def _norms(tensors):
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def _params(model):
    """The parameters, copied to the host."""
    return {n: p.detach().to("cpu", copy=True)
            for n, p in _named(model).items()}


def _change(p1, p0):
    return {n: float((p1[n].double() - p0[n].double()).norm()) for n in p1}


def snapshot(model, optimizer, step, k):
    """The training state on the host: parameters, Adam's state by
    parameter name, the step count and the next batch's index."""
    names = {p: n for n, p in _named(model).items()}
    return {"params": _params(model), "step": step, "k": k,
            "adam": {names[p]: {key: v.detach().cpu().clone()
                                for key, v in s.items()}
                     for p, s in optimizer.state.items()}}


# ---------------------------------------------------------------------------
# the calls the replay reads
# ---------------------------------------------------------------------------

def _grab(store, key):
    def hook(g):
        store[key] = g.detach().clone()
    return hook


def _record(calls, args, out, x=None):
    """One call: its inputs, its outputs, and hooks that keep the
    gradients reaching its outputs from outside the call (and its input
    `x`'s).  Returns the output with each tensor replaced by a view of
    itself: a tap that also feeds the call's later layers (VGG's) then
    shows the outside's gradient alone."""
    if isinstance(out, dict):
        outs, pack = out, dict
    elif isinstance(out, (list, tuple)):
        outs, pack = dict(enumerate(out)), lambda d: type(out)(d.values())
    else:
        outs, pack = {0: out}, lambda d: d[0]
    call = {"args": [a.detach().clone() for a in args],
            "out": {k: v.detach().clone() for k, v in outs.items()},
            "grad": {}, "in_grad": {}}
    seen = {}
    for k, v in outs.items():
        if v.requires_grad:
            v = v.view_as(v)
            v.register_hook(_grab(call["grad"], k))
        seen[k] = v
    if x is not None:
        x.register_hook(_grab(call["in_grad"], 0))
    calls.append(call)
    return pack(seen)


@contextlib.contextmanager
def taking(model, vgg, clip_ns, into: dict):
    """Inside the block `into` receives every call of the predictor
    `model`, and each call of the `vgg` tower and of `clip_ns`'s
    encode_image on an input that needs a gradient (the render's)."""
    into.update(predictor=[], vgg=[], clip=[])

    def on_predictor(module, args, out):
        return _record(into["predictor"], args, out)

    def on_vgg(module, args, out):
        if args[0].requires_grad:
            return _record(into["vgg"], args, out, args[0])
        return None
    encode = clip_ns.encode_image

    def on_clip(tower, x):
        out = encode(tower, x)
        if x.requires_grad:
            return _record(into["clip"], (x,), out, x)
        return out
    handles = [model.register_forward_hook(on_predictor),
               vgg.register_forward_hook(on_vgg)]
    clip_ns.encode_image = on_clip
    try:
        yield into
    finally:
        clip_ns.encode_image = encode
        for h in handles:
            h.remove()


def to_host(x):
    if torch.is_tensor(x):
        return x.cpu()
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, list):
        return [to_host(v) for v in x]
    return x


def setup(cell, seed, device, tracer, spans):
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.pipeline import config as C
    from f3d_gaus_torch.pipeline import dataset as D
    from f3d_gaus_torch.train import feedforward as F

    st = State()
    st.cell, st.seed, st.device = cell, seed, device
    st.tracer, st.spans = tracer, spans
    st.traffic = t = cell.traffic
    tr = cell.config["train"]
    st.fields = pf = H.fields(cell.config["pipeline"])
    if torch.device(device).type == "cuda":
        cuda_raster.load()
    # the program's own training entry (its device set-up turns TF32 off,
    # as the configuration states), then the benchmark's weights
    st.state = F.init_state(None, C.PipelineConfig(**pf), lr=tr["lr"],
                            device=device)
    model = st.state.model
    ref = weights.reference_predictor(pf, H.seed_int(seed, 1), device)
    model.load_state_dict(ref.state_dict())
    del ref
    rt = weights.reference_towers(H.seed_int(seed, 6), device)
    st.towers = weights.program_towers(rt, device)
    del rt
    st.weights = F.LossWeights(**tr["loss_weights"])
    st.cfg = C.PipelineConfig(**pf)
    st.pack = F.make_cameras_pack(st.cfg, D.canonical_cameras(st.cfg))
    st.images, st.depths = _pool(cell, st.cfg.resolution, device)
    st.order = _order(cell, seed)
    st.cycle = t["pool"] // t["batch"]          # steps a cycle
    if st.cycle * t["batch"] != t["pool"]:
        raise ValueError("the pool must hold whole batches")
    st.replans, st.k = [], 0
    p0 = _params(model)
    m0 = _moments(model, st.state.optimizer)
    st.setup_rec = {"losses": [], "first": {}}
    for k in range(t["first_steps"]):
        with first_call(model, st.setup_rec["first"]):
            loss, _ = _step(st, None)
        if k < t["check_steps"]:
            st.setup_rec["losses"].append(float(loss))
        if k == 0:
            st.setup_rec["grads"] = _norms(_first_grads(
                m0, _moments(model, st.state.optimizer)))
        if k + 1 == t["check_steps"]:
            st.setup_rec["change"] = _change(_params(model), p0)
    del p0, m0
    H.card_sync(device)
    # the state the window starts from, which the reference follows
    st.snap = snapshot(model, st.state.optimizer, st.state.step, st.k)
    return st


def _step(st, timings, on_retry=None):
    """One applied step on the next batch; on an overflow the caps double
    and the step runs again (after `on_retry()`, where given)."""
    from f3d_gaus_torch.pipeline import renderer
    from f3d_gaus_torch.train import feedforward as F
    batch = _batch(st, st.k)
    for _ in range(MAX_DOUBLINGS + 1):
        try:
            out = F.train_step(st.state, st.cfg, batch, st.pack, st.weights,
                               timings=timings, towers=st.towers)
            st.k += 1
            return out
        except renderer.RenderOverflow:
            st.cfg = dataclasses.replace(st.cfg, pair_cap=st.cfg.pair_cap * 2,
                                         max_per_tile=st.cfg.max_per_tile * 2)
            st.replans.append(st.k)
            if on_retry is not None:
                on_retry()
    raise RuntimeError(f"the caps still overflow after {MAX_DOUBLINGS} "
                       "doublings")


def window(st, seconds, run):
    from f3d_gaus_torch.models import clip as CL
    from f3d_gaus_torch.models import predictor as P
    from f3d_gaus_torch.models import vgg as VG
    from f3d_gaus_torch.ops import rasterize

    tracing = st.tracer.enabled
    if tracing:
        st.spans.wrap(rasterize, "prepare", "bench.prepare")
        st.spans.wrap(rasterize, "composite", "bench.composite")
        st.spans.wrap(P.GaussianPredictor, "forward", "bench.predictor")
        st.spans.wrap(VG.VGG16, "forward", "bench.vgg")
        st.spans.wrap(CL.CLIPVisual, "forward", "bench.clip")
    trace_at = st.traffic["trace_step"]
    n_check = st.traffic["check_steps"]
    model, opt = st.state.model, st.state.optimizer
    rec = st.window_rec = {"losses": [], "taken": {}}
    replans0, stages, n = len(st.replans), [], 0
    t0 = time.perf_counter()
    while True:
        timings = {} if tracing else None
        if tracing and n == trace_at:
            st.tracer.start()
        if n == 0:
            # the calls of the attempt that was applied (an overflow's
            # attempt takes no backward)
            taken = rec["taken"]
            with taking(model, st.towers["vgg"], CL, taken):
                loss, _ = _step(st, timings, on_retry=lambda: taken.update(
                    predictor=[], vgg=[], clip=[]))
        else:
            loss, _ = _step(st, timings)
        H.card_sync(st.device)
        if tracing and n == trace_at:
            st.tracer.stop()
        stages.append(timings)
        n += 1
        # what the check reads of the window's first steps
        if n <= n_check:
            rec["losses"].append(float(loss))
        if n == 1:
            rec["taken"] = to_host(rec["taken"])
            rec["m1"] = _moments(model, opt)
        if n == n_check:
            rec["params"] = _params(model)
        now = time.perf_counter()
        if (now - t0 >= seconds and st.k % st.cycle == 0 and n >= n_check
                and (not tracing or st.tracer.done)):
            break
    elapsed = now - t0 - st.tracer.overhead_s
    st.spans.close()
    B = st.traffic["batch"]
    run.counters["steps"] = n
    run.counters["replans"] = len(st.replans) - replans0
    run.counters["window_s"] = elapsed
    if tracing:
        run.spans["step_s"] = stages
        from ..counts import train_step_flops
        run.counts["flops_per_step"] = train_step_flops(
            st.fields, B, st.weights._asdict())
    return {"values": {"train_images_per_s": B * n / elapsed},
            "attempted": n, "failed": 0}


def _window_got(snap, rec):
    """The comparison's reading of a window: losses, first gradients (in
    full, for the replay) and the change after the compared steps."""
    m0 = {n: snap["adam"][n]["exp_avg"] if n in snap["adam"]
          else torch.zeros_like(m) for n, m in rec["m1"].items()}
    g = _first_grads(m0, rec["m1"])
    return {"losses": rec["losses"], "g": g, "grads": _norms(g),
            "change": _change(rec["params"], snap["params"]),
            "taken": rec["taken"]}


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

class _Reference:
    """The reference's training state on `device`: the seeded predictor
    (or a snapshot's), its Adam, the seeded towers, the pool and the
    run's batch order."""

    def __init__(self, cell, seed, device, snap=None):
        from ..reference import config as RCF
        from ..reference import dataset as RD
        from ..reference import feedforward as RF
        tr = cell.config["train"]
        pf = H.fields(cell.config["pipeline"])
        model = weights.reference_predictor(pf, H.seed_int(seed, 1),
                                            device).train()
        opt = RF.make_optimizer(model.parameters(), tr["lr"])
        if snap is not None:
            named = _named(model)
            with torch.no_grad():
                for n, p in named.items():
                    p.copy_(snap["params"][n].to(device))
            for n, s in snap["adam"].items():
                opt.state[named[n]] = {
                    k: v.clone() if k == "step" else v.to(device).clone()
                    for k, v in s.items()}
        self.state = RF.TrainState(model, opt, snap["step"] if snap else 0)
        self.towers = weights.reference_towers(H.seed_int(seed, 6), device)
        self.cfg = RCF.PipelineConfig(**pf)
        self.pack = RF.make_cameras_pack(self.cfg,
                                         RD.canonical_cameras(self.cfg))
        self.w = RF.LossWeights(**tr["loss_weights"])
        self.st = State()
        self.st.traffic, self.st.device = cell.traffic, device
        self.st.images, self.st.depths = _pool(cell, self.cfg.resolution,
                                               device)
        self.st.order = _order(cell, seed)
        self.k = snap["k"] if snap else 0

    def step(self, tf32=False, half_batch=False):
        """One step on the next batch (with `half_batch`, a fault's
        reading, the first half of it only); returns the loss."""
        from ..reference import feedforward as RF
        batch = _batch(self.st, self.k)
        if half_batch:
            h = batch["images"].shape[0] // 2
            batch = {key: v[:h] for key, v in batch.items()}
        with H.precision(tf32), H.exact_render_caps():
            loss, _ = RF.train_step(self.state, self.cfg, batch, self.pack,
                                    self.w, towers=self.towers)
        self.k += 1
        return float(loss)

    def run(self, n, tf32=False, half_batch=False, first=None, taken=None):
        """n steps: their losses, the first gradient, the change after
        them; `first` receives step 1's first predictor call, `taken` step
        1's calls."""
        from ..reference import clip as RCL
        model, opt = self.state.model, self.state.optimizer
        p0, m0 = _params(model), _moments(model, opt)
        losses, g = [], None
        for k in range(n):
            with contextlib.ExitStack() as stack:
                if k == 0 and first is not None:
                    stack.enter_context(first_call(model, first))
                if k == 0 and taken is not None:
                    stack.enter_context(taking(model, self.towers["vgg"],
                                               RCL, taken))
                losses.append(self.step(tf32, half_batch))
            if k == 0:
                g = _first_grads(m0, _moments(model, opt))
                if taken is not None:
                    taken.update(to_host(taken))
        return {"losses": losses, "g": g, "grads": _norms(g),
                "change": _change(_params(model), p0)}

    def replay(self, taken):
        """The recorded calls again, from this state in f32, with the
        recorded gradients taken back through them: (replay_gap, the
        parameters' gradients, the towers' input-gradient gap)."""
        from ..reference import clip as RCL
        dev = self.st.device
        model = self.state.model
        model.zero_grad(set_to_none=True)
        fwd, tower_bwd = 0.0, 0.0
        towers = {"vgg": self.towers["vgg"],
                  "clip": lambda x: RCL.encode_image(self.towers["clip"], x)}
        with H.precision(False):
            for call in taken["predictor"]:
                out = model(*[a.to(dev) for a in call["args"]])
                fwd = max(fwd, max(H.max_rel_gap(v, out[k].detach().cpu())
                                   for k, v in call["out"].items()))
                keys = list(call["grad"])
                if keys:
                    torch.autograd.backward(
                        [out[k] for k in keys],
                        [call["grad"][k].to(dev) for k in keys])
                del out
            for name, fn in towers.items():
                for call in taken[name]:
                    x = call["args"][0].to(dev).requires_grad_(True)
                    out = fn(x)
                    outs = out if isinstance(out, list) else [out]
                    fwd = max(fwd, max(H.max_rel_gap(
                        v, outs[k].detach().cpu())
                        for k, v in call["out"].items()))
                    keys = list(call["grad"])
                    if not keys:
                        # no gradient reached the program's call: neither
                        # may one have reached its input
                        if call["in_grad"]:
                            tower_bwd = float("inf")
                        continue
                    torch.autograd.backward(
                        [outs[k] for k in keys],
                        [call["grad"][k].to(dev) for k in keys])
                    want = x.grad.double().cpu()
                    gap = (call["in_grad"][0].double() - want).norm()
                    tower_bwd = max(tower_bwd, float(gap / want.norm()))
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 .detach().cpu() for n, p in _named(model).items()}
        model.zero_grad(set_to_none=True)
        return fwd, grads, tower_bwd


def _kept(gn):
    """The parameters compared: those whose reference gradient is at least
    a thousandth of the median parameter's (the others move under Adam by
    round-off alone)."""
    med = float(np.median(list(gn.values())))
    return [k for k in gn if gn[k] >= 1e-3 * med]


def _gaps(a, b, kept):
    """For each kept parameter, |a - b| over the larger of b and the
    median parameter's b."""
    m = float(np.median([b[k] for k in kept]))
    return {k: abs(a[k] - b[k]) / max(b[k], m) for k in kept}


def _worst(gaps, ref, n=3):
    return sorted(((v, k, ref[k]) for k, v in gaps.items()),
                  reverse=True)[:n]


def compare(got, want, prefix=""):
    """loss_gap: the worst step's relative loss gap; for each parameter,
    the gap between the program's norm and the reference's over the
    larger of the reference's norm of that parameter and of the median
    parameter: grad_gap the median parameter's of the first gradient,
    change_gap the worst parameter's of the change (grad_gap_worst, the
    worst of the gradient, is printed beside them)."""
    loss = [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                 want["losses"])]
    gn = want["grads"]
    kept = _kept(gn)
    g = _gaps(got["grads"], gn, kept)
    c = _gaps(got["change"], want["change"], kept)
    out = {f"{prefix}loss_gap": max(loss),
           f"{prefix}grad_gap": float(np.median(list(g.values()))),
           f"{prefix}change_gap": max(c.values()),
           f"{prefix}grad_gap_worst": max(g.values()),
           f"{prefix}left_out": len(gn) - len(kept),
           f"{prefix}worst_grads": _worst(g, gn),
           f"{prefix}worst_changes": _worst(c, want["change"]),
           f"{prefix}step_loss_gaps": loss}
    if "first" in got:
        out["predict_gap"] = predict_gap(got["first"], want["first"])
    return out


def compare_replay(got, replayed):
    """replay_gap and backward_gap of the window's first step (see the
    module docstring)."""
    fwd, grads, tower_bwd = replayed
    gn = _norms(grads)
    kept = _kept(gn)
    diff = {k: float((got["g"][k] - grads[k].double()).norm())
            for k in kept}
    m = float(np.median([gn[k] for k in kept]))
    worst = {k: diff[k] / max(gn[k], m) for k in kept}
    return {"replay_gap": fwd,
            "backward_gap": max(max(worst.values()), tower_bwd),
            "backward_gap_towers": tower_bwd,
            "worst_backward": _worst(worst, gn)}


def reference_window(cell, seed, device, snap, got):
    """The reference from a window's starting state: the replay of its
    first step's calls, then its first check_steps steps."""
    n = cell.traffic["check_steps"]
    ref = _Reference(cell, seed, device, snap)
    replayed = ref.replay(got["taken"])
    want = ref.run(n)
    return {**compare(got, want, "window_"), **compare_replay(got, replayed)}


DIAGNOSTICS = ("left_out", "step_loss_gaps", "grad_gap_worst", "worst_grads",
               "worst_changes", "window_step_loss_gaps",
               "window_grad_gap_worst", "window_worst_grads",
               "window_worst_changes", "backward_gap_towers",
               "worst_backward")


def check(st, run):
    n = st.traffic["check_steps"]
    got_window = _window_got(st.snap, st.window_rec)
    snap = st.snap
    del st.state, st.towers, st.window_rec, st.snap
    if torch.device(st.device).type == "cuda":
        torch.cuda.empty_cache()
    want = _Reference(st.cell, st.seed, st.device)
    first = {}
    nums = compare(st.setup_rec, want.run(n, first=first) | {"first": first})
    del want
    nums.update(reference_window(st.cell, st.seed, st.device, snap,
                                 got_window))
    checks = H.Checks(st.cell.limits["limits"])
    for k in st.cell.limits["limits"]:
        checks.add(k, nums[k])
    run.counters["diagnostics"] = {k: nums[k] for k in DIAGNOSTICS
                                   if k in nums}
    return checks


def emulate(cell, seed, device, tf32=False, half_batch=False):
    """The reference put in the program's place (in TF32 for the control,
    or with half of each batch for a fault), driven as setup and window
    drive the program; compared as `check` compares the program."""
    t = cell.traffic
    n = t["check_steps"]
    side = _Reference(cell, seed, device)
    first = {}
    setup_got = side.run(n, tf32, half_batch, first=first)
    setup_got["first"] = first
    for _ in range(t["first_steps"] - n):
        side.step(tf32, half_batch)
    snap = snapshot(side.state.model, side.state.optimizer, side.state.step,
                    side.k)
    taken = {}
    win = side.run(n, tf32, half_batch, taken=taken)
    del side
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    want = _Reference(cell, seed, device)
    first_r = {}
    nums = compare(setup_got, want.run(n, first=first_r) | {"first": first_r})
    del want
    got_window = {"losses": win["losses"], "g": win["g"],
                  "grads": win["grads"], "change": win["change"],
                  "taken": taken}
    nums.update(reference_window(cell, seed, device, snap, got_window))
    return nums


def control(cell, seed, device):
    """The control: the reference in TF32 in the program's place."""
    return emulate(cell, seed, device, tf32=True)


def fault_readings(cell, seed, device):
    """What the faults a training cell can have read, planted in the
    reference put in the program's place: half of each batch left out (a
    state left unchanged reads 1 by change_gap's measure, with no run)."""
    return {"half_batch": emulate(cell, seed, device, half_batch=True)}
