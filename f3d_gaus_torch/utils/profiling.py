"""Spans, counters, stage clocks and traces of the port (counterpart of
f3d_gaus_tpu/utils/profiling.py).

The reference times iterations with paired CUDA events
(src/gaussian-splatting/train.py:44-95).  Here one in-memory registry
holds what the program records while tracing is on:

* `span(name)` (a context manager) and `spanned(name)` (a decorator) mark
  a layer's call: name, parent span, root id (shared by every span of one
  request or step), host start and end on the clock torch.profiler stamps
  its host events with (`time.time_ns`, epoch nanoseconds), and where CUDA
  is in use a `torch.cuda.Event` pair on the current stream, read only by
  `snapshot`.
* `count(name, value)` adds a host int, or keeps a device tensor that is
  summed only by `snapshot`.
* `StageClock` times the stages of one call between its laps into a
  `timings=` dict (seconds with a sync per lap, or milliseconds from CUDA
  events) and, while tracing is on, closes a span per stage.
* `snapshot()` reads the registry: per span name the calls, host ms, self
  host ms and device ms, and the counters' totals.
* `captured()` marks a CUDA graph's capture, which runs no work: spans
  opened inside keep their host interval only (no CUDA event), and what
  `count` receives there is kept for the graph; `replayed` counts one
  replay (`graph.replays`) and, while tracing is on, adds what the capture
  counted again, so a replayed render counts as an eager one does.

Tracing is on while any torch.profiler records (a new profiler session
clears the registry) and inside `record()` (which clears it too).  Off,
`span` costs one check and returns a shared no-op: no event, no clock
read, no allocation.  The program never opens a profiler range
(`record_function`): under a profiler someone else started, its spans
stay out of that trace.  `trace(logdir)` runs the block under a profiler
of its own and writes its Chrome trace with the program's spans as a
track of their own, and `spans.json` (the snapshot and `idle_by_span`).
`timed` is a wall clock that waits for the card before reading either
end.  `StepTimer`, the JAX package's EMA iteration clock, is not ported:
nothing in the port reads it.
"""
from __future__ import annotations

import contextlib
import functools
import heapq
import json
import os
import threading
import time

import torch
import torch.autograd.profiler as _ap


class _Span:
    """One span, and the context manager that records it: ids, host
    stamps (ns) and the CUDA events, if any."""
    __slots__ = ("name", "id", "parent", "root", "gen", "t0", "t1", "ev0",
                 "ev1")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        reg = _REG
        top = reg.stack[-1] if reg.stack else None
        self.id, self.gen = reg.new_id(), reg.gen
        self.parent = top.id if top is not None else None
        self.root = top.root if top is not None else self.id
        self.ev0 = _event()
        self.t0 = time.time_ns()
        reg.stack.append(self)
        return self

    def __exit__(self, *exc):
        reg = _REG
        self.t1 = time.time_ns()
        self.ev1 = _new_event() if self.ev0 is not None else None
        if self.gen == reg.gen:
            # spans a raise left open above this one close with it
            while reg.stack:
                if reg.stack.pop() is self:
                    break
            reg.records.append(self)
        return False

    def device_ms(self) -> float:
        """Milliseconds between the span's CUDA events (waits for the
        end event); the host interval where it recorded none."""
        if self.ev0 is None:
            return (self.t1 - self.t0) / 1e6
        self.ev1.synchronize()
        return self.ev0.elapsed_time(self.ev1)


class _Registry:
    """The spans closed and open, and the counters, of one tracing
    session (`gen` tells the sessions apart)."""

    def __init__(self):
        self.depth = 0            # record() blocks open
        self.gen = 0
        self.clear()

    def clear(self):
        self.gen += 1
        self.records: list = []   # closed spans, in closing order
        self.stack: list = []     # open spans, innermost last
        self.counters: dict = {}
        self.tensors: dict = {}
        self.next_id = 0

    def new_id(self) -> int:
        self.next_id += 1
        return self.next_id


_REG = _Registry()


def tracing() -> bool:
    """Whether the program records spans and counters now."""
    return _REG.depth > 0 or _ap._is_profiler_enabled


def _install_session_hook():
    """Clear the registry whenever a torch.profiler session starts (torch
    calls autograd.profiler._run_on_profiler_start at each start)."""
    start = _ap._run_on_profiler_start
    if getattr(start, "clears_span_registry", False):
        return

    def run_on_profiler_start(*args, **kwargs):
        start(*args, **kwargs)
        _REG.clear()
    run_on_profiler_start.clears_span_registry = True
    _ap._run_on_profiler_start = run_on_profiler_start


_install_session_hook()


_STREAMS: dict = {}


def _stream():
    """The current CUDA stream (torch.cuda.current_stream builds a new
    Stream object under a device guard, several us a call; the Stream is
    kept by device and raw stream)."""
    dev = torch._C._cuda_getDevice()
    key = (dev, torch._C._cuda_getCurrentRawStream(dev))
    s = _STREAMS.get(key)
    if s is None:
        s = _STREAMS[key] = torch.cuda.current_stream(dev)
    return s


def _new_event():
    """A timing event recorded now on the current stream."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(_stream())
    return ev


def _event():
    """_new_event(), where CUDA is in use and no graph is being captured
    (None elsewhere)."""
    return (_new_event() if _CAPTURE is None and torch.cuda.is_initialized()
            else None)


class _Off:
    """The span handed out while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_COUNT_LOCK = threading.Lock()
# what `count` received since the innermost open `captured()` began, or
# None outside every capture
_CAPTURE = None


def span(name: str):
    """A context manager that records the block as span `name` while
    tracing is on (a shared no-op while it is off)."""
    if not (_REG.depth or _ap._is_profiler_enabled):
        return _OFF
    return _Span(name)


def spanned(name: str):
    """Decorator: every call of the function runs inside span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, value=1):
    """Add `value` (an int, or a 0-d tensor summed only by `snapshot`, so
    no kernel and no sync here) to counter `name` while tracing is on;
    inside `captured()` keep it for the graph's replays instead."""
    if _CAPTURE is not None:
        _CAPTURE.append((name, value))
        return
    if not (_REG.depth or _ap._is_profiler_enabled):
        return
    with _COUNT_LOCK:   # autograd's device threads count the backward
        if torch.is_tensor(value):
            _REG.tensors.setdefault(name, []).append(value)
        else:
            _REG.counters[name] = _REG.counters.get(name, 0) + int(value)


@contextlib.contextmanager
def record():
    """Turn tracing on inside the block (no profiler needed), starting
    from an empty registry; `snapshot` reads what it recorded."""
    _REG.clear()
    _REG.depth += 1
    try:
        yield
    finally:
        _REG.depth -= 1


@contextlib.contextmanager
def captured():
    """The block captures a CUDA graph, which runs nothing until it is
    replayed: spans opened inside record no CUDA event (they keep their
    host interval), and the counts made inside go to the yielded list of
    (name, value) instead of the registry, whether tracing is on or not;
    hand it to `replayed` at each replay."""
    global _CAPTURE
    outer, _CAPTURE = _CAPTURE, []
    try:
        yield _CAPTURE
    finally:
        _CAPTURE = outer


def replayed(tally: list):
    """While tracing is on, count one replay of a graph whose capture
    counted `tally` (`captured`): `graph.replays`, and each of the tally's
    counts again, a device tensor as a copy made now (the graph's next
    replay overwrites the tensor itself)."""
    if not (_REG.depth or _ap._is_profiler_enabled):
        return
    count("graph.replays")
    for name, value in tally:
        count(name, value.clone() if torch.is_tensor(value) else value)


def records() -> list:
    """The closed spans as dicts: name, id, parent, root and the host
    start and end (ns, time.time_ns's clock)."""
    return [{"name": r.name, "id": r.id, "parent": r.parent, "root": r.root,
             "start_ns": r.t0, "end_ns": r.t1} for r in _REG.records]


def snapshot() -> dict:
    """The registry read: {"spans": {name: {calls, host_ms, self_ms,
    device_ms}}, "counters": {name: total}}.  self_ms is the host time
    not covered by the span's children; device_ms the time between its
    CUDA events (the host time for spans that recorded none, as on the
    CPU).  Waits for the spans' last events; leaves the registry as it
    is."""
    recs = _REG.records
    child_ns: dict = {}
    for r in recs:
        if r.parent is not None:
            child_ns[r.parent] = child_ns.get(r.parent, 0) + r.t1 - r.t0
    spans: dict = {}
    for r in recs:
        s = spans.setdefault(r.name, {"calls": 0, "host_ms": 0.0,
                                      "self_ms": 0.0, "device_ms": 0.0})
        host = (r.t1 - r.t0) / 1e6
        s["calls"] += 1
        s["host_ms"] += host
        s["self_ms"] += host - child_ns.get(r.id, 0) / 1e6
        s["device_ms"] += r.device_ms()
    counters = dict(_REG.counters)
    for name, ts in _REG.tensors.items():
        counters[name] = counters.get(name, 0) + sum(int(t) for t in ts)
    return {"spans": spans, "counters": counters}


_NO_MARK = (0.0, 0, None, None)


def _position():
    """Where the registry stands: (generation, spans closed, innermost
    open span)."""
    reg = _REG
    return reg.gen, len(reg.records), reg.stack[-1] if reg.stack else None


class StageClock:
    """The stages of one call: each `lap(name)` closes the stage begun at
    the previous lap (or at construction).

    timings: a dict that receives each stage's time under its lap name,
    or None.  unit "s": wall seconds, the card synchronised at each lap
    (only with `timings`); "ms": milliseconds between CUDA events
    recorded at the laps (the host clock on the CPU), with no sync until
    `close`, which waits for the last.  accumulate: add to the dict's
    value instead of replacing it.  While tracing is on each lap also
    closes a span over its stage, named `spans[name]` (laps missing from
    `spans` make none) or, with spans None, the lap's name; the spans
    recorded inside the stage become its children.
    """

    def __init__(self, device, timings=None, *, unit: str = "s",
                 accumulate: bool = False, spans: dict | None = None):
        self.device = torch.device(device)
        self.timings, self.unit = timings, unit
        self.accumulate, self.spans = accumulate, spans
        self.cuda = self.device.type == "cuda"
        self.pending: list = []
        self.mark = self._mark()

    def _mark(self):
        """(perf_counter, host ns, event, registry position) of now; the
        position (generation, records closed, enclosing span) is None
        while tracing is off."""
        on = tracing()
        if self.timings is None and not on:
            return _NO_MARK
        ev = None
        if self.cuda and (on or (self.unit == "ms"
                                 and self.timings is not None)):
            ev = _new_event()
        return (time.perf_counter(), time.time_ns(), ev,
                _position() if on else None)

    def lap(self, name: str):
        if self.timings is not None and self.unit == "s" and self.cuda:
            torch.cuda.synchronize(self.device)
        (p0, h0, ev0, pos), self.mark = self.mark, self._mark()
        p1, h1, ev1, _ = self.mark
        if self.timings is not None:
            if self.unit == "s":
                self._put(name, p1 - p0)
            else:
                self.pending.append((name, ev0, ev1, p1 - p0))
        span_name = name if self.spans is None else self.spans.get(name)
        if pos is not None and span_name is not None:
            self._stage_span(span_name, pos, h0, h1, ev0, ev1)
            if self.mark[3] is not None:
                # the next stage's spans come after this stage's record
                self.mark = self.mark[:3] + (_position(),)

    def _put(self, name, value):
        if self.accumulate:
            value += self.timings.get(name, 0.0)
        self.timings[name] = value

    @staticmethod
    def _stage_span(name, pos, h0, h1, ev0, ev1):
        """Record the stage (h0, h1) as a span under the span enclosing
        its start; spans recorded inside it under that same parent become
        its children."""
        reg = _REG
        gen, n0, top = pos
        if gen != reg.gen:
            return
        r = _Span(name)
        r.id, r.gen = reg.new_id(), gen
        r.parent = top.id if top is not None else None
        r.root = top.root if top is not None else r.id
        r.t0, r.t1 = h0, h1
        if ev0 is not None and ev1 is not None:
            r.ev0, r.ev1 = ev0, ev1
        else:
            r.ev0 = r.ev1 = None
        inside = reg.records[n0:]
        moved = set()
        for c in inside:
            if c.parent == r.parent:
                c.parent = r.id
                if top is None:
                    moved.add(c.id)
        for c in inside:
            if c.root in moved:
                c.root = r.root
        reg.records.append(r)

    def close(self):
        """Write the "ms" stages (waiting for the last event)."""
        if not self.pending:
            return
        if self.cuda:
            self.pending[-1][2].synchronize()
        for name, a, b, host_s in self.pending:
            self._put(name, a.elapsed_time(b) if self.cuda else host_s * 1e3)
        self.pending.clear()


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------

def _device_ops(events):
    """(start_us, end_us) of the device operations among torch.profiler's
    events, by start (a profiler range's device row is no operation)."""
    from torch.autograd import DeviceType
    return sorted((e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))


def idle_by_span(events, trace_start_ns: int, top: int = 10) -> list:
    """The idle time between device operations put down to the innermost
    program span open at each gap's middle: [[span name, seconds]], the
    largest `top` ("(no span)" for gaps outside every span).

    events: torch.profiler's events (prof.events()), whose times are
    microseconds from trace_start_ns (prof.profiler.kineto_results.
    trace_start_ns(), on the registry's clock).  Gaps are those between
    the merged intervals of the device operations."""
    merged: list = []
    for s, e in _device_ops(events):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps = sorted((trace_start_ns + (a[1] + b[0]) * 500.0, (b[0] - a[1]) / 1e6)
                  for a, b in zip(merged, merged[1:]) if b[0] > a[1])
    spans = sorted((r.t0, r.t1, r.name) for r in _REG.records)
    named: dict = {}
    heap: list = []
    j = 0
    for mid, secs in gaps:
        while j < len(spans) and spans[j][0] <= mid:
            heapq.heappush(heap, (-spans[j][0], spans[j][1], spans[j][2]))
            j += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        name = heap[0][2] if heap else "(no span)"
        named[name] = named.get(name, 0.0) + secs
    return sorted(([n, t] for n, t in named.items()), key=lambda r: -r[1])[:top]


def _add_span_track(path: str):
    """Append the registry's spans to the Chrome trace at `path` as a
    process of their own, on the trace's time base."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"]
    base = data.get("baseTimeNanoseconds", 0)
    pid = 1 + max((e["pid"] for e in events
                   if isinstance(e.get("pid"), int)), default=0)
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": "f3d_gaus_torch spans"}})
    for r in _REG.records:
        events.append({"ph": "X", "cat": "program_span", "name": r.name,
                       "pid": pid, "tid": 0, "ts": (r.t0 - base) / 1e3,
                       "dur": (r.t1 - r.t0) / 1e3,
                       "args": {"id": r.id, "parent": r.parent,
                                "root": r.root}})
    with open(path, "w") as f:
        json.dump(data, f)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the CPU and, where a card is
    present, the CUDA activity inside the block, with the program's spans
    recorded (`record`).  Writes `logdir`/trace.json (Chrome trace format,
    the spans a track of their own) and `logdir`/spans.json (`snapshot`
    and `idle_by_span`).  Yields the profiler, whose key_averages() the
    caller may read after the block."""
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        with record():
            yield prof
    finally:
        prof.stop()
        path = os.path.join(logdir, "trace.json")
        prof.export_chrome_trace(path)
        _add_span_track(path)
        start_ns = prof.profiler.kineto_results.trace_start_ns()
        with open(os.path.join(logdir, "spans.json"), "w") as f:
            json.dump({**snapshot(),
                       "idle_by_span": idle_by_span(prof.events(), start_ns)},
                      f, indent=1)


def _sync(out):
    """Wait for every CUDA device that holds a tensor of `out` (nested
    tuples, lists and dicts)."""
    devices = set()

    def walk(x):
        if torch.is_tensor(x):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(out)
    for d in devices:
        torch.cuda.synchronize(d)


def timed(fn, *args, iters: int = 10, warmup: int = 1, **kw):
    """Wall-clock `fn(*args, **kw)`: `warmup` calls, then the mean seconds
    of `iters` calls, waiting for the outputs' card before each clock
    read.  Returns (mean_s, out), out from the last call."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kw)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kw)
    _sync(out)
    return (time.perf_counter() - t0) / iters, out
