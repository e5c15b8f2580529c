"""Arithmetic the per-layer readers (metrics/<name>.py) share.  Each
returns None where its run holds nothing to read, and the harness then
leaves the metric out of the line."""
from __future__ import annotations

from .harness import PEAK_FP32_FLOPS


def mean_stage_ms(run, key: str, stage: str):
    """The mean of a program stage's seconds (run.spans[key]: one dict of
    stage seconds per request or step) in milliseconds."""
    rows = [t[stage] for t in run.spans.get(key) or [] if t and stage in t]
    return 1e3 * sum(rows) / len(rows) if rows else None


def span_device_ms(run, span: str):
    """Device milliseconds per call of the kernels launched inside the
    harness's profiler range `span`."""
    tr = run.trace
    if tr is None or not tr.span_calls.get(span):
        return None
    return tr.span_device_us[span] / tr.span_calls[span] / 1e3


def device_idle_pct(run):
    """The share of the traced window in which no device operation ran."""
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def mfu_pct(run, flops_key: str, unit_key: str):
    """The benchmark's FLOP count per unit of work times the units the
    traced window completed, over its seconds, against the FP32 peak."""
    flops = run.counts.get(flops_key)
    units = run.counters.get(unit_key)
    secs = run.counters.get("window_s")
    if not flops or not units or not secs:
        return None
    return 100.0 * flops * units / secs / PEAK_FP32_FLOPS


def kernels_named(run, part: str):
    """The traced window's device operations whose name holds `part`, in
    start order: (name, start_us, dur_us)."""
    tr = run.trace
    return [] if tr is None else [k for k in tr.kernels if part in k[0]]
