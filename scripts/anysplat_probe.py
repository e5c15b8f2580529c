#!/usr/bin/env python3
"""One AnySplat pose-free request at the published widths on one card, split
by the program's own spans.

    python3 scripts/anysplat_probe.py [--requests 3] [--seed 7]
                                      [--out build/anysplat_probe.json]

Builds the benchmark cell anysplat_scene_448.unposed_b1's model (weights
drawn from --seed on the card, not the benchmark's stream) and its first
scene (benchmark/loops/unposed.py:make_pool), then serves the scene's
images through reconstruct.run_gslrm with no input cameras --requests
times, the card synchronised around each
(the first is the warm-up), and once more inside profiling.record():
the wall seconds of each request, the peak memory of the last untraced
one (max_memory_allocated after reset_peak_memory_stats), and the traced
request's spans (calls, device ms) and counters.  A torch.profiler pass
over one more request gives the device's busy time, its time by kernel
(the 25 largest) and its idle gaps (benchmark/harness.py:reduce_trace).
Prints one JSON object and writes it to --out.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT]
CELL = "anysplat_scene_448.unposed_b1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default="build/anysplat_probe.json")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from benchmark import harness as H
    from benchmark.loops import unposed
    from f3d_gaus_torch.core.device import resolve_device
    from f3d_gaus_torch.models import anysplat as A
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.pipeline import config as C
    from f3d_gaus_torch.pipeline import reconstruct as R
    from f3d_gaus_torch.utils import profiling

    dev = resolve_device("cuda")
    cell = H.load_cell(CELL)
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()}
    torch.manual_seed(args.seed)
    with torch.device(dev):
        model = A.AnySplat(A.AnySplatConfig(**H.fields(
            cell.config["model"])), None)
    model = model.eval()
    cuda_raster.load()
    cfg = C.PipelineConfig(**H.fields(cell.config["render"]))
    obj = unposed.make_pool(cell, dev)[0]

    def request():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = R.run_gslrm(model, cfg, obj.images, device=dev)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    walls = []
    for i in range(args.requests):
        if i == args.requests - 1:
            torch.cuda.reset_peak_memory_stats()
        res, s = request()
        cfg = res.cfg
        walls.append(s)
        del res
    out["wall_s"] = walls
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    out["caps"] = {"pair_cap": cfg.pair_cap, "max_per_tile": cfg.max_per_tile}
    with profiling.record():
        res, s = request()
        snap = profiling.snapshot()
    out["traced_wall_s"] = s
    out["spans"] = {k: {"calls": v["calls"], "device_ms": v["device_ms"]}
                    for k, v in snap["spans"].items()}
    out["counters"] = {k: v for k, v in snap["counters"].items()}
    out["attempts"] = res.attempts
    out["merged"] = int(res.gaussians["xyz"].shape[1])
    out["alpha_mean"] = float(res.renders["rendered_alpha"].mean())
    out["pose_enc"] = res.cameras["pose_enc"][0].tolist()
    del res
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res, s = request()
    del res
    trace = H.reduce_trace(prof.events(), s, top=25)
    out["profiled_wall_s"] = s
    out["busy_s"] = trace.busy_s
    out["device_s_by_kernel"] = trace.device_ops
    out["idle_gaps"] = trace.idle_gaps
    text = json.dumps(out)
    print(text)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
