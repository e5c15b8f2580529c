"""What the readers of the program's own spans and counters share.

While the traced run's profiler records, f3d_gaus_torch's registry
(`utils/profiling.py`) keeps the spans and counters the program records
there; `profiling.snapshot()` reads them after the window: per span name
its calls and device milliseconds, and each counter's total.  Each
function returns None where the run was not traced, or where the program
keeps no such registry (a program from before it), so the metric is left
out of the line.
"""
from __future__ import annotations


def program_snapshot(run):
    """profiling.snapshot() after the traced window, or None."""
    if run.trace is None:
        return None
    from f3d_gaus_torch.utils import profiling
    read = getattr(profiling, "snapshot", None)
    return None if read is None else read()


def span_ms_per(run, names, per: str):
    """Device milliseconds of the spans `names` together, per call of the
    span `per` (a request's or step's root, or the span itself)."""
    snap = program_snapshot(run)
    if snap is None:
        return None
    spans = snap["spans"]
    calls = spans.get(per, {}).get("calls")
    if not calls or not any(n in spans for n in names):
        return None
    return sum(spans[n]["device_ms"] for n in names if n in spans) / calls


def counter_ratio(run, num: str, den: str):
    """The total of counter `num` over that of counter `den`."""
    snap = program_snapshot(run)
    if snap is None:
        return None
    c = snap["counters"]
    if num not in c or not c.get(den):
        return None
    return c[num] / c[den]
