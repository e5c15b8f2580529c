"""The Mamba2 scans' share of their roofline in the traced request: the
benchmark's count of each scan's least time in a request
(benchmark/counts_longlrm.py:ssd_bound, its FLOPs at the FP32 peak or its
bytes at the memory rate, whichever is larger), summed and times the
requests the program's `ssd` spans cover, over those spans' device
milliseconds.  It reads the same work whatever implements the scan."""
from benchmark.program import program_snapshot


def read(run):
    bounds = run.counts.get("ssd_bound_ms")
    snap = program_snapshot(run)
    if not bounds or snap is None:
        return None
    s = snap["spans"].get("ssd")
    if not s or not s["device_ms"]:
        return None
    return 100.0 * sum(bounds) * (s["calls"] / len(bounds)) / s["device_ms"]
