"""What every cell shares: its files found by name, the numbers that decide
`correct`, the traced window's reduction and the result line.

A cell of BENCHMARK.json names a configuration, a traffic mix and its
chips.  The configuration is `configs/<config>.json`, the traffic mix
`traffic/<traffic>.json` (its `loop` key names the traffic loop,
`loops/<loop>.py`), the limits of the comparison `workloads/<cell>.json`,
and each per-layer metric's reader `metrics/<metric>.py`.  Adding a cell,
a mix, a configuration or a metric adds files; none here changes.
"""
from __future__ import annotations

import contextlib
import heapq
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import NamedTuple

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# modules that may not be loaded in the process that prints a result,
# compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "f3d_gaus_tpu")
# H100 SXM (NVIDIA data sheet): FP32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    limits: dict          # workloads/<cell>.json
    end_to_end: list      # the end-to-end metrics this cell reports
    per_layer: list       # the per-layer metrics this cell reports


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its files; raises
    KeyError for a name the benchmark does not hold."""
    spec = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(it holds {sorted(cells)})")
    w = cells[name]
    bench = root / "benchmark"
    config = next(c for c in spec["configs"] if c["name"] == w["config"])
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    # a per-layer metric without `workloads` is reported wherever its
    # end-to-end metric is
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in e2e_names)]
    return Cell(name, int(w["chips"]), _read_json(root / config["file"]),
                _read_json(bench / "traffic" / f"{w['traffic']}.json"),
                _read_json(bench / "workloads" / f"{name}.json"),
                e2e, layer)


def load_loop(cell: Cell):
    """The traffic loop module the cell's mix names."""
    return importlib.import_module(f"benchmark.loops.{cell.traffic['loop']}")


def load_reader(metric: str, bench: Path = BENCH):
    """`read(run)` of metrics/<metric>.py (file names hold dots, so the
    file is loaded by path)."""
    path = bench / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """The FORBIDDEN top-level names present in sys.modules."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def seed_int(seed: int, salt: int = 0) -> int:
    """A non-negative 63-bit seed for one stream of the run (`salt` keeps
    the streams of one run apart)."""
    return (int(seed) * 1_000_003 + salt) % (1 << 63)


# ---------------------------------------------------------------------------
# the comparison that decides `correct`
# ---------------------------------------------------------------------------

class Checks:
    """The numbers compared with their limits: a number passes when it is
    finite and at most its limit."""

    def __init__(self, limits: dict):
        self.limits = limits
        self.items: list = []

    def add(self, name: str, value: float):
        self.items.append((name, float(value), float(self.limits[name])))

    @property
    def correct(self) -> bool:
        return bool(self.items) and all(
            math.isfinite(v) and v <= lim for _, v, lim in self.items)

    def as_dict(self) -> dict:
        return {n: {"value": v, "limit": lim} for n, v, lim in self.items}

    def lines(self) -> list:
        return [f"check {n}: {v!r} (limit {lim!r}) "
                f"{'ok' if math.isfinite(v) and v <= lim else 'FAILED'}"
                for n, v, lim in self.items]


def max_rel_gap(got, want) -> float:
    """max |got - want| over max |want| (the gap of the worst element
    against the field's own scale)."""
    got, want = got.double(), want.double()
    scale = float(want.abs().max())
    if scale == 0.0:
        return float((got - want).abs().max())
    return float((got - want).abs().max()) / scale


def mean_rel_gap(got, want) -> float:
    """mean |got - want| over max |want|: a gap that keeps its size, so a
    small region far off shows as well as many elements a little off."""
    got, want = got.double(), want.double()
    scale = float(want.abs().max()) or 1.0
    return float((got - want).abs().mean()) / scale


def share_off(got, want, rel_tol: float) -> float:
    """The share of elements with |got - want| > rel_tol * max |want|."""
    got, want = got.double(), want.double()
    tol = rel_tol * float(want.abs().max())
    return float(((got - want).abs() > tol).double().mean())


@contextlib.contextmanager
def precision(tf32: bool):
    """Matmuls and convolutions in TF32 (the control) or in full f32.  The
    reference's resolve_device turns TF32 off at every call, so for the
    control each reference module's resolve_device is wrapped to turn it
    on again."""
    import torch
    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("benchmark.reference.")
            and hasattr(m, "resolve_device")]
    saved = [(m, m.resolve_device) for m in mods]

    def set_flags():
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32

    def with_flags(orig):
        def resolve(*a, **k):
            out = orig(*a, **k)
            set_flags()
            return out
        return resolve
    try:
        for m, orig in saved:
            m.resolve_device = with_flags(orig)
        set_flags()
        yield
    finally:
        for m, orig in saved:
            m.resolve_device = orig
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def exact_render_caps():
    """Every render of the reference's renderer at the caps its own
    plan_caps finds for that render (the plain version's time grows with
    max_per_tile; exact caps never truncate)."""
    import dataclasses
    from .reference import rasterize as RZ
    from .reference import renderer as RR
    from .reference.cameras import Camera
    orig = RR.render_gaussians

    def planned(g, b, world_view, full_proj, cam_center, bg, cfg):
        cam = Camera(world_view, full_proj, cam_center, cfg.resolution,
                     cfg.resolution, cfg.tan_fov, cfg.tan_fov)
        caps = RZ.plan_caps(g["xyz"][b].detach(), g["scaling"][b].detach(),
                            g["rotation"][b].detach(),
                            g["opacity"][b].detach(), cam)
        return orig(g, b, world_view, full_proj, cam_center, bg,
                    dataclasses.replace(cfg, **caps))
    RR.render_gaussians = planned
    try:
        yield
    finally:
        RR.render_gaussians = orig


# ---------------------------------------------------------------------------
# the traced window
# ---------------------------------------------------------------------------

class Spans:
    """torch.profiler ranges (record_function) around calls into the
    program's layers, installed only for the traced run and removed by
    `close`.  `wrap` replaces a module or class attribute, so callers that
    look the name up at call time pass through the range."""

    def __init__(self):
        self._undo = []

    def wrap(self, owner, attr: str, name: str):
        from torch.profiler import record_function
        orig = getattr(owner, attr)

        def wrapped(*args, **kwargs):
            with record_function(name):
                return orig(*args, **kwargs)
        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, orig))

    def close(self):
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()


class TraceSummary(NamedTuple):
    window_s: float        # host seconds from start to stop, card synced
    busy_s: float          # union of the device operations' intervals
    kernels: list          # (name, start_us, dur_us) by start
    span_device_us: dict   # span name -> device time of its kernels
    span_calls: dict       # span name -> calls
    device_ops: list       # [[name, seconds]] the 10 largest by name
    idle_gaps: list        # [[host op, seconds]] idle time by host op


def _interval_union(iv):
    """Merged (start, end) intervals of sorted (start, end) pairs."""
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce_trace(events, window_s: float, span_prefix: str = "bench.",
                 top: int = 10) -> TraceSummary:
    """The traced window from torch.profiler's events: device operations
    (kernels, copies, fills) and their busy union, the device time of the
    kernels launched inside each `span_prefix` range, the device time by
    operation, and the idle gaps between device operations named by the
    innermost host operation running at each gap's middle."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            # a profiler range shows on the device too: not an operation
            if not e.name.startswith(span_prefix):
                dev.append((e.name, tr.start, tr.end - tr.start))
        elif e.device_type == DeviceType.CPU:
            host.append((tr.start, tr.end, e.name))
    dev.sort(key=lambda k: k[1])
    union = _interval_union([(s, s + d) for _, s, d in dev])
    busy_us = sum(e - s for s, e in union)
    by_name: dict = {}
    for name, _, d in dev:
        by_name[name] = by_name.get(name, 0.0) + d
    device_ops = sorted(([n[:120], t / 1e6] for n, t in by_name.items()),
                        key=lambda r: -r[1])[:top]
    span_us, span_calls = {}, {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith(span_prefix):
            span_us[e.name] = span_us.get(e.name, 0.0) + e.device_time_total
            span_calls[e.name] = span_calls.get(e.name, 0) + 1
    # idle gaps: innermost host op (latest start) covering each midpoint
    gaps = [((a[1] + b[0]) / 2, b[0] - a[1]) for a, b in zip(union, union[1:])
            if b[0] > a[1]]
    host.sort()
    named: dict = {}
    heap: list = []
    j = 0
    for mid, length in sorted(gaps):
        while j < len(host) and host[j][0] <= mid:
            heapq.heappush(heap, (-host[j][0], host[j][1], host[j][2]))
            j += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        name = heap[0][2] if heap else "(no host op)"
        named[name] = named.get(name, 0.0) + length
    idle_gaps = sorted(([n[:120], t / 1e6] for n, t in named.items()),
                       key=lambda r: -r[1])[:top]
    return TraceSummary(window_s, busy_us / 1e6, dev, span_us, span_calls,
                        device_ops, idle_gaps)


class Tracer:
    """The profiled part of a traced run's window: `start` and `stop`
    bracket it (the card synchronised at both), `summary` reduces it.
    Off (every call a no-op) in an untraced run."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.summary: TraceSummary | None = None
        self.done = False
        self.overhead_s = 0.0

    def start(self):
        if not self.enabled or self.prof is not None or self.done:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        """Close the profiled part; `overhead_s` is the time the profiler's
        stop took, which the loop takes out of its traced window."""
        if self.prof is None or self.done:
            return
        import torch
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        self.window_s = t1 - self.t0
        self.prof.__exit__(None, None, None)
        self.overhead_s = time.perf_counter() - t1
        self.done = True

    def finish(self):
        """Reduce the profiled part (after the window)."""
        if self.done and self.summary is None:
            self.summary = reduce_trace(self.prof.events(), self.window_s)
        return self.summary


class Run:
    """What a traffic loop hands to the per-layer readers: the cell, the
    trace summary (None if nothing was traced), the program's counters
    and span times, and the benchmark's own counts."""

    def __init__(self, cell: Cell, seconds: float):
        self.cell = cell
        self.seconds = seconds
        self.trace: TraceSummary | None = None
        self.counters: dict = {}
        self.spans: dict = {}
        self.counts: dict = {}


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: Checks, breakdown=None) -> str:
    """The result: one JSON object, the numbers compared last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks.as_dict()
    return json.dumps(out)


def fields(section: dict) -> dict:
    """A configuration section as constructor keywords (JSON lists become
    the tuples the dataclasses hold)."""
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in section.items()}


def card_sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
