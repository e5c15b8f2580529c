#!/usr/bin/env python3
"""What the port's tracing (utils/profiling.py) costs, on one card.

    python3 scripts/tracing_cost.py [--seed 7] [--reps 3] [--fit_iters 200]
                                    [--cells nvs,fit,train]
                                    [--out build/tracing_cost.json]

For each cell of the benchmark it sets the cell up as benchmark/run.py
does (its configuration, seeded weights and inputs, its warm-up), then
times the cell's unit of work with tracing off and inside
profiling.record(), in turns (off, on, on, off, repeated --reps times),
the card synchronised before and after each: an nvs request
(cycle.run_nvs_replanned from the caps the pool settled on), a fit
(per_scene.fit_scene over --fit_iters iterations from the cell's init
cloud, caps planned; reported per iteration too) and a training step
(feedforward.train_step at the cell's batch, with the towers).  It also
times a span and a count with tracing off and on (ns each), and checks
the registry's clock against the profiler's on this torch: a span around a
CUDA matmul under torch.profiler, with the matmul's host event put back
on the trace's start.  Prints one JSON object (and writes it to --out).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT]
CELLS = {"nvs": "imagenetgs_256.nvs_b1", "fit": "gof_nerf_synthetic_800.fit",
         "train": "imagenetgs_256.train_b6"}


def timed_turns(unit, reps):
    """Seconds of unit() with tracing off and on, in turns off, on, on,
    off; returns {"off": [...], "on": [...]} and the last snapshot."""
    import torch
    from f3d_gaus_torch.utils import profiling
    out, snap = {"off": [], "on": []}, None
    for _ in range(reps):
        for side in ("off", "on", "on", "off"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if side == "on":
                with profiling.record():
                    unit()
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                snap = profiling.snapshot()
            else:
                unit()
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            out[side].append(dt)
    return out, snap


def summary(times, per=1):
    med = {k: statistics.median(v) / per for k, v in times.items()}
    return {"off_s": [t / per for t in times["off"]],
            "on_s": [t / per for t in times["on"]],
            "median_off_s": med["off"], "median_on_s": med["on"],
            "cost_pct": 100.0 * (med["on"] / med["off"] - 1.0)}


def nvs_cost(H, seed, reps):
    from benchmark.loops import nvs
    from f3d_gaus_torch.pipeline import cycle
    st = nvs.setup(H.load_cell(CELLS["nvs"]), seed, "cuda", H.Tracer(False),
                   H.Spans())
    image, depth = st.pool[0]

    def unit():
        cycle.run_nvs_replanned(st.model, st.cfg, st.cams, image, depth,
                                device="cuda", log=st.replans.append)
    times, snap = timed_turns(unit, reps)
    return summary(times), snap


def fit_cost(H, seed, reps, iters):
    from benchmark.loops import fit
    from f3d_gaus_torch.train import per_scene as PS
    st = fit.setup(H.load_cell(CELLS["fit"]), seed, "cuda", H.Tracer(False),
                   H.Spans())
    cfg = st.cfg._replace(iterations=iters)

    def unit():
        PS.fit_scene(st.cams, st.targets, st.points, st.colors, cfg,
                     extent=st.extent, seed=st.fit_seed, device="cuda",
                     caps="plan")
    times, snap = timed_turns(unit, reps)
    return {"iterations": iters, "per_call": summary(times),
            "per_iteration": summary(times, iters)}, snap


def train_cost(H, seed, reps):
    from benchmark.loops import train
    st = train.setup(H.load_cell(CELLS["train"]), seed, "cuda",
                     H.Tracer(False), H.Spans())
    times, snap = timed_turns(lambda: train._step(st, None), reps)
    return summary(times), snap


def span_ns(n=200_000):
    """ns per `with span(...)` and per count(...), off and on (on: inside
    record(), CUDA in use, so each span records its two events)."""
    from f3d_gaus_torch.utils import profiling

    def spans():
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with profiling.span("x"):
                pass
        return (time.perf_counter_ns() - t0) / n

    def counts():
        t0 = time.perf_counter_ns()
        for _ in range(n):
            profiling.count("x", 1)
        return (time.perf_counter_ns() - t0) / n

    def empty():
        t0 = time.perf_counter_ns()
        for _ in range(n):
            pass
        return (time.perf_counter_ns() - t0) / n
    loop = empty()
    off = {"span_ns": spans() - loop, "count_ns": counts() - loop}
    with profiling.record():
        on = {"span_ns": spans() - loop, "count_ns": counts() - loop}
    return {"off": off, "on": on, "loop_ns": loop}


def clock_check():
    """The registry's host stamps against the profiler's: a span around a
    CUDA matmul, the matmul's host event (aten::mm) put back on the
    trace's start; offsets in us (both >= 0 when the span brackets it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from f3d_gaus_torch.utils import profiling
    x = torch.ones(1024, 1024, device="cuda")
    x @ x
    torch.cuda.synchronize()
    rows = []
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall0 = time.time_ns()
            with profiling.span("mm"):
                x @ x
            torch.cuda.synchronize()
        start_ns = prof.profiler.kineto_results.trace_start_ns()
        mm = next(e for e in prof.events() if e.name == "aten::mm")
        (r,) = profiling.records()
        rows.append({
            "mm_after_span_start_us":
                (start_ns + mm.time_range.start * 1e3 - r["start_ns"]) / 1e3,
            "span_end_after_mm_us":
                (r["end_ns"] - start_ns - mm.time_range.end * 1e3) / 1e3,
            "trace_start_minus_time_ns_us": (start_ns - wall0) / 1e3,
            "user_annotation_field": hasattr(mm, "is_user_annotation")})
    return {"torch": torch.__version__,
            "hooks": hasattr(torch.autograd.profiler, "_is_profiler_enabled")
            and hasattr(torch.autograd.profiler, "_run_on_profiler_start"),
            "rows": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--fit_iters", type=int, default=200)
    ap.add_argument("--cells", default="nvs,fit,train")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    import torch
    from benchmark import harness as H
    from f3d_gaus_torch.utils import profiling
    if not torch.cuda.is_available():
        print("tracing_cost.py needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, torch.get_num_threads()))
    res = {"card": torch.cuda.get_device_name(0), "clock": clock_check(),
           "span_cost": span_ns()}
    for cell in args.cells.split(","):
        if cell == "nvs":
            res["nvs"], snap = nvs_cost(H, args.seed, args.reps)
        elif cell == "fit":
            res["fit"], snap = fit_cost(H, args.seed, args.reps,
                                        args.fit_iters)
        else:
            res["train"], snap = train_cost(H, args.seed, args.reps)
        res[cell]["snapshot"] = snap
        print(cell, json.dumps({k: v for k, v in res[cell].items()
                                if k != "snapshot"}), file=sys.stderr,
              flush=True)
        torch.cuda.empty_cache()
    with profiling.record():
        pass
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
