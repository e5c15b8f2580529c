#!/usr/bin/env python3
"""The readings the limits of `correct` are set from, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control 4,5,6 [--seconds 3]

For each of `--seeds` it runs the cell as run.py does (set-up, a short
window of `--seconds`, the check) and prints the numbers compared; for
each of `--control` it prints the same numbers for the control, the
reference in the next lower precision put in the program's place
(the loop's `control`), and, where the loop has them, what the faults a
training cell can have read (`fault_readings`), each judged against the
cell's limits as a run's numbers are (`correct`, `fails`).  Where a
stage's control can start only from the program's state (the loop's
`state_control`), it follows each program seed.  One JSON line per seed
on standard output.  The benchmark's own runs never run the control.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _judged(cell, values: dict) -> dict:
    """The numbers a control or a fault reads, judged as a run's are (by
    H.Checks against the cell's limits): `correct`, which of them fail,
    and all it read."""
    from benchmark import harness as H
    limits = cell.limits["limits"]
    checks = H.Checks({k: v for k, v in limits.items() if k in values})
    for k in checks.limits:
        checks.add(k, values[k])
    return {"correct": checks.correct,
            "fails": sorted(k for k in checks.limits
                            if not values[k] <= limits[k]),
            "values": values}


def main(argv=None, root: Path = ROOT, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import harness as H
    cell = H.load_cell(args.workload, root)
    loop = H.load_loop(cell)
    if device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        run = H.Run(cell, args.seconds)
        st = loop.setup(cell, seed, device, H.Tracer(False), H.Spans())
        win = loop.window(st, args.seconds, run)
        checks = loop.check(st, run)
        print(json.dumps({"side": "program", "seed": seed,
                          "correct": checks.correct,
                          "values": {n: v for n, v, _ in checks.items},
                          "diagnostics": run.counters.get("diagnostics", {}),
                          "attempted": win["attempted"],
                          "s": time.perf_counter() - t0}), flush=True)
        if hasattr(loop, "state_control"):
            # a stage the control can reach only from the program's state
            values = loop.state_control(st)
            print(json.dumps({"side": "state_control", "seed": seed,
                              **_judged(cell, values)}), flush=True)
        del st, run
        if device == "cuda":
            torch.cuda.empty_cache()
    for seed in [int(s) for s in args.control.split(",") if s]:
        t0 = time.perf_counter()
        values = loop.control(cell, seed, device)
        print(json.dumps({"side": "control", "seed": seed,
                          **_judged(cell, values),
                          "s": time.perf_counter() - t0}), flush=True)
        if device == "cuda":
            torch.cuda.empty_cache()
        if hasattr(loop, "fault_readings"):
            t0 = time.perf_counter()
            faults = loop.fault_readings(cell, seed, device)
            print(json.dumps({"side": "faults", "seed": seed,
                              **{k: _judged(cell, v)
                                 for k, v in faults.items()},
                              "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
