#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Set-up (imports, the kernels' build or load,
the seeded weights and inputs, the warm-up) is timed from the start of
this script to the start of the window; then the cell's traffic runs for
`--seconds`; then the program's state is freed and the reference decides
`correct`.  With `--trace 1` part of the window is profiled and the
cell's per-layer metrics are reported instead of its end-to-end ones.

The last line of standard output is one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` `breakdown`,
and last `checks`: each number compared with its limit); the last lines
of standard error repeat the checks.  Without as many CUDA cards as the
cell asks for, or with JAX loaded once the window has closed, it prints
no result and exits with a code other than 0.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, root: Path = ROOT, device: str | None = None,
         t_start: float | None = None) -> int:
    """One run.  `device` None asks for the cell's CUDA cards (the
    benchmark); the tests pass "cpu" to drive the rest of a run."""
    t_start = T_START if t_start is None else t_start
    args = parse(argv)
    # a library the port uses must not load JAX behind its back
    os.environ.setdefault("USE_FLAX", "0")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark import harness as H

    cell = H.load_cell(args.workload, root)
    import torch
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell.chips):
            print(f"{cell.name} needs {cell.chips} CUDA card(s); "
                  f"{torch.cuda.device_count()} available", file=sys.stderr)
            return 2
        device = "cuda"
    on_card = torch.device(device).type == "cuda"
    loop = H.load_loop(cell)
    run = H.Run(cell, args.seconds)
    tracer = H.Tracer(bool(args.trace) and on_card)
    spans = H.Spans()
    torch.set_num_threads(min(4, torch.get_num_threads()))

    state = loop.setup(cell, args.seed, device, tracer, spans)
    H.card_sync(device)
    setup_s = time.perf_counter() - t_start
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    win = loop.window(state, args.seconds, run)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    bad = H.forbidden_modules()
    if bad:
        print(f"loaded once the window closed: {bad}", file=sys.stderr)
        return 3
    run.trace = tracer.finish()
    checks = loop.check(state, run)
    bad = H.forbidden_modules()
    if bad:
        print(f"loaded once the window closed: {bad}", file=sys.stderr)
        return 3

    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = H.load_reader(m["name"], root / "benchmark")(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if run.trace is not None:
            device_info["busy_s"] = run.trace.busy_s
            device_info["window_s"] = run.trace.window_s
            breakdown = {"device_ops": run.trace.device_ops,
                         "idle_gaps": run.trace.idle_gaps}
    else:
        values = {**win["values"], "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]],
                               "unit": units[m["name"]]}
                   for m in cell.end_to_end}
    print(f"window: {win['attempted']} attempted, {win['failed']} failed; "
          + "; ".join(f"{k} {v!r}" for k, v in run.counters.items()
                      if k != "diagnostics"), file=sys.stderr)
    diag = run.counters.get("diagnostics", {})
    if diag:
        print("diagnostics (not compared): " + ", ".join(
            f"{k} {v!r}" for k, v in diag.items()), file=sys.stderr)
    for line in checks.lines():
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(H.result_line(checks.correct, win["attempted"], win["failed"],
                        metrics, device_info, checks, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
