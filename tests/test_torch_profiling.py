"""The port's spans, counters, stage clocks and traces (f3d_gaus_torch/
utils/profiling.py) on the CPU: off, nothing is recorded and no event made;
on (under a torch.profiler the program did not start, or inside
`record()`), spans nest with parents, roots and self time on the
profiler's host clock and stay out of the profiler's events; a new
session clears the registry; the binning's counters; the stage clocks'
`timings=` dicts and spans; `trace` writes its Chrome trace with the
spans' track and spans.json; `timed`; and the benchmark's readers of the
registry."""
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_cases  # tests/ is on sys.path under pytest (rootdir-less dir)
from f3d_gaus_torch import utils as TU
from f3d_gaus_torch.ops import rasterize as TR
from f3d_gaus_torch.train import per_scene as PS
from f3d_gaus_torch.utils import profiling as TP

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the suite runs in several xdist workers on one CPU: torch's intra-op
# threads would oversubscribe the cores, so each worker keeps one
torch.set_num_threads(1)


def test_utils_exports_profiling():
    assert TU.profiling is TP
    assert hasattr(TU, "logging")


def test_trace_writes_a_chrome_trace(tmp_path):
    with TP.trace(str(tmp_path / "tr")) as prof:
        x = torch.ones(64, 64)
        (x @ x).sum()
    data = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name", "") for e in data["traceEvents"]}
    assert any("mm" in n for n in names), sorted(names)[:20]
    assert any("mm" in e.key for e in prof.key_averages())


def test_timed_counts_calls_and_returns_the_last_output():
    calls = []

    def fn(a, b=0):
        calls.append((a, b))
        return {"sum": torch.tensor(float(a + b + len(calls)))}
    mean_s, out = TP.timed(fn, 2, iters=5, warmup=3, b=1)
    assert len(calls) == 8 and calls[0] == (2, 1)
    assert float(out["sum"]) == 2 + 1 + 8
    assert mean_s >= 0.0
    mean_s, out = TP.timed(lambda: (torch.zeros(2), [torch.ones(1)]),
                           iters=1, warmup=0)
    assert out[1][0].item() == 1.0


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

class FakeEvent:
    """torch.cuda.Event on the CPU: counts what is made and recorded; the
    elapsed time is the host's."""
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.fixture
def fake_card(monkeypatch):
    """CUDA in use, as far as the registry can tell, with counted
    events."""
    FakeEvent.made = 0
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(TP, "_stream", lambda: None)
    return FakeEvent


def _span_work():
    with TP.span("a"):
        TP.count("n", 2)
        TP.count("n", torch.tensor(3))


def _clock_work():
    clock = TP.StageClock("cuda", None)
    clock.lap("first")
    clock.lap("second")
    clock.close()


@pytest.mark.parametrize("work", [_span_work, _clock_work])
def test_off_records_nothing_and_makes_no_event(fake_card, work):
    with TP.record():
        pass
    assert not TP.tracing()
    work()
    assert fake_card.made == 0
    assert TP.snapshot() == {"spans": {}, "counters": {}}
    assert TP.span("a") is TP.span("b")


def test_on_records_an_event_pair_per_span_and_sums_counters(fake_card):
    with TP.record():
        _span_work()
        assert fake_card.made == 2
        _clock_work()
        # one event per lap mark: construction and the two laps
        assert fake_card.made == 5
    snap = TP.snapshot()
    assert snap["counters"] == {"n": 5}
    assert set(snap["spans"]) == {"a", "first", "second"}
    assert all(s["calls"] == 1 and s["device_ms"] >= 0
               for s in snap["spans"].values())


def test_counts_from_many_threads_add_up():
    """autograd's device threads count the backward's launches: no count
    is lost to a race (more threads than cores, a short switch
    interval)."""
    import threading
    n_threads, n = 32, 2000

    def work():
        for _ in range(n):
            TP.count("c")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with TP.record():
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert TP.snapshot()["counters"] == {"c": n_threads * n}


def test_spans_nest_under_a_profiler_with_roots_and_self_time():
    x = torch.ones(32, 32)
    with torch.profiler.profile():
        assert TP.tracing()
        for _ in range(2):
            with TP.span("request"):
                with TP.span("stage"):
                    with TP.span("op"):
                        x @ x
                    time.sleep(0.002)
                with TP.span("stage"):
                    pass
    assert not TP.tracing()
    recs = {(r["name"], r["id"]): r for r in TP.records()}
    by_id = {r["id"]: r for r in recs.values()}
    roots = [r for r in by_id.values() if r["name"] == "request"]
    assert len(roots) == 2 and all(r["parent"] is None for r in roots)
    for r in by_id.values():
        if r["name"] != "request":
            parent = by_id[r["parent"]]
            assert parent["name"] == {"stage": "request", "op": "stage"}[
                r["name"]]
            assert r["root"] == parent["root"]
            assert parent["start_ns"] <= r["start_ns"] <= r["end_ns"] <= \
                parent["end_ns"]
    assert len({r["root"] for r in by_id.values()}) == 2
    spans = TP.snapshot()["spans"]
    assert spans["stage"]["calls"] == 4 and spans["op"]["calls"] == 2
    stage = spans["stage"]
    assert stage["self_ms"] == pytest.approx(
        stage["host_ms"] - spans["op"]["host_ms"])
    assert stage["self_ms"] >= 2 * 2.0 * 0.9
    assert spans["request"]["self_ms"] < spans["request"]["host_ms"]


def _profiler_session():
    return torch.profiler.profile()


@pytest.mark.parametrize("session", [_profiler_session, TP.record])
def test_a_new_session_clears_the_registry(session):
    with session():
        with TP.span("old"):
            TP.count("old", 1)
    assert "old" in TP.snapshot()["spans"]
    with session():
        with TP.span("new"):
            pass
    snap = TP.snapshot()
    assert set(snap["spans"]) == {"new"} and snap["counters"] == {}


def test_program_spans_stay_out_of_the_profilers_events():
    x = torch.ones(16, 16)
    with torch.profiler.profile() as prof:
        with TP.span("program_span_a"):
            with TP.span("program_span_b"):
                x @ x
    names = {e.name for e in prof.events()}
    assert "aten::mm" in names
    assert not names & {"program_span_a", "program_span_b"}
    assert set(TP.snapshot()["spans"]) == {"program_span_a",
                                           "program_span_b"}


def test_a_span_brackets_the_profilers_event_on_its_clock():
    """The registry stamps host time on the profiler's own clock: an
    aten::mm inside a span, put back on the trace's start, lies inside
    it."""
    x = torch.ones(128, 128)
    with torch.profiler.profile() as prof:
        with TP.span("mm"):
            x @ x
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    mm = [e for e in prof.events() if e.name == "aten::mm"]
    (r,) = TP.records()
    assert len(mm) == 1
    a = start_ns + mm[0].time_range.start * 1e3
    b = start_ns + mm[0].time_range.end * 1e3
    assert r["start_ns"] - 1e3 <= a <= b <= r["end_ns"] + 1e3


@pytest.mark.parametrize("pair_cap, max_per_tile, lanes",
                         [(1000, 256, 256), (1 << 12, 384, 128),
                          (3000, 128, 128)])
def test_binning_counts_the_slots_walked_and_the_pairs_binned(
        pair_cap, max_per_tile, lanes):
    cam, cloud = torch_cases.setup(np.random.default_rng(0))
    args = [torch.from_numpy(a) for a in cloud]
    with TP.record():
        inp = TR.prepare(*args, cam, torch.zeros(3), pair_cap=pair_cap,
                         max_per_tile=max_per_tile, chunk=32)
    snap = TP.snapshot()
    assert snap["counters"] == {
        "binning.slots": -(-pair_cap // lanes) * lanes,
        "binning.pairs": int(inp.binning.num_pairs)}
    assert 0 < snap["counters"]["binning.pairs"] <= pair_cap
    by_id = {r["id"]: r for r in TP.records()}
    assert sorted(r["name"] for r in by_id.values()) == [
        "binning", "prepare", "preprocess"]
    for r in by_id.values():
        if r["name"] != "prepare":
            assert by_id[r["parent"]]["name"] == "prepare"


# ---------------------------------------------------------------------------
# the stage clock
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("unit, accumulate", [("s", False), ("s", True),
                                              ("ms", False)])
def test_stage_clock_keeps_its_timings(monkeypatch, unit, accumulate):
    """Each lap writes the stage since the last one under its name: wall
    seconds or (host clock on the CPU) milliseconds at close, replaced or
    added; with tracing on each lap is also a span of that stage."""
    ticks = iter([10.0, 10.5, 11.25, 12.0, 12.5])
    monkeypatch.setattr(TP.time, "perf_counter", lambda: next(ticks))
    timings = {"b": 1.0} if accumulate else {}
    with TP.record():
        with TP.span("root"):
            clock = TP.StageClock("cpu", timings, unit=unit,
                                  accumulate=accumulate)
            clock.lap("a")
            with TP.span("inner"):
                pass
            clock.lap("b")
            clock.lap("a")
            clock.close()
    scale = 1e3 if unit == "ms" else 1.0
    want = {"a": 0.75 * scale, "b": 0.75 * scale}
    if accumulate:
        want = {"a": 1.25, "b": 1.75}
    assert timings == pytest.approx(want)
    by_id = {r["id"]: r for r in TP.records()}
    names = {i: r["name"] for i, r in by_id.items()}
    assert sorted(names.values()) == ["a", "a", "b", "inner", "root"]
    inner = next(r for r in by_id.values() if r["name"] == "inner")
    assert names[inner["parent"]] == "b"
    assert all(names[r["parent"]] == "root" for r in by_id.values()
               if r["name"] in ("a", "b"))
    assert len({r["root"] for r in by_id.values()}) == 1


def _scene_step_args(rng, cfg):
    pts = (rng.normal(size=(40, 3)) * 0.3 + [0, 0, 7.667]).astype(np.float32)
    cols = rng.uniform(size=(40, 3)).astype(np.float32)
    scene = PS.init_scene(pts, cols, cfg, device="cpu")
    cam = torch_cases.orbit_camera(32, 32)
    target = torch.from_numpy(rng.uniform(size=(3, 32, 32)).astype(
        np.float32))
    return (scene, PS.init_adam(scene), PS.init_stats(scene),
            (cam.world_view, cam.full_proj, cam.cam_center), target,
            torch.zeros(3), cfg, 1,
            (cam.width, cam.height, cam.tan_fovx, cam.tan_fovy))


SCENE_CFG = dict(sh_degree=1, pair_cap=1 << 12, max_per_tile=128, chunk=32,
                 cap_bucket=128)


def test_per_scene_step_is_a_root_span_with_its_three_phases():
    """train_step's phases: milliseconds into `timings`, and with tracing
    on the spans fit_step > forward, backward, adam, timings or not (the
    render's spans under forward)."""
    cfg = PS.PerSceneConfig(**SCENE_CFG)
    args = _scene_step_args(np.random.default_rng(0), cfg)
    timings = {}
    PS.train_step(*args, timings=timings)
    assert set(timings) == {"forward", "backward", "adam"}
    assert all(t > 0 for t in timings.values())
    with TP.record():
        PS.train_step(*args)
    by_id = {r["id"]: r for r in TP.records()}
    (root,) = [r for r in by_id.values() if r["parent"] is None]
    assert root["name"] == "fit_step"
    phases = [r for r in by_id.values() if r["parent"] == root["id"]]
    assert sorted(r["name"] for r in phases) == ["adam", "backward",
                                                 "forward"]
    assert by_id[next(r["parent"] for r in by_id.values()
                      if r["name"] == "prepare")]["name"] == "forward"
    assert all(r["root"] == root["id"] for r in by_id.values())


def test_fit_scene_spans_surgery_and_plan_and_keeps_its_timings():
    """fit_scene(caps="plan"): its accumulated stage seconds keep their
    keys; with tracing on each step, surgery and plan is a root span of
    its own."""
    rng = np.random.default_rng(1)
    cams = [torch_cases.orbit_camera(32, 32, yaw=y) for y in (0.0, 0.2)]
    targets = torch.from_numpy(rng.uniform(size=(2, 3, 32, 32)).astype(
        np.float32))
    pts = (rng.normal(size=(40, 3)) * 0.3 + [0, 0, 7.667]).astype(np.float32)
    cols = np.full((40, 3), 0.5, np.float32)
    cfg = PS.PerSceneConfig(**SCENE_CFG, iterations=22,
                            densification_interval=20, densify_from_iter=10,
                            densify_until_iter=21)
    timings = {}
    with TP.record():
        PS.fit_scene(cams, targets, pts, cols, cfg, device="cpu",
                     timings=timings, caps="plan")
    assert set(timings) == {"init_s", "steps_s", "surgery_s", "plan_s"}
    spans = TP.snapshot()["spans"]
    assert spans["fit_step"]["calls"] == 22
    assert spans["surgery"]["calls"] == 1 and spans["plan"]["calls"] == 2
    roots = {r["name"] for r in TP.records() if r["parent"] is None}
    assert roots == {"fit_step", "surgery", "plan"}


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------

class Ev:
    """What idle_by_span reads of a torch.profiler event."""

    def __init__(self, name, start_us, end_us, device="CUDA", ann=False):
        from torch.autograd import DeviceType

        class Range:
            pass
        self.name, self.is_user_annotation = name, ann
        self.device_type = getattr(DeviceType, device)
        self.time_range = Range()
        self.time_range.start, self.time_range.end = start_us, end_us


def test_idle_by_span_names_the_innermost_span_at_each_gap():
    """Device operations at 0-10, 30-40 (and 35-50) and 60-70 us leave gaps
    of 20 us (middle 20) and 10 us (middle 55); an annotation row on the
    device is no operation.  Spans: outer over 0-100, inner over 15-25."""
    t0 = 1_000_000_000
    with TP.record():
        pass
    reg = TP._REG
    for name, a, b, parent in (("inner", 15, 25, 1), ("outer", 0, 100, None)):
        r = TP._Span(name)
        r.id, r.parent, r.root, r.gen = len(reg.records) + 1, parent, 1, \
            reg.gen
        r.t0, r.t1, r.ev0, r.ev1 = t0 + a * 1000, t0 + b * 1000, None, None
        reg.records.append(r)
    events = [Ev("k", 0, 10), Ev("k", 30, 40), Ev("k", 35, 50),
              Ev("k", 60, 70), Ev("range", 10, 30, ann=True),
              Ev("aten::mm", 0, 100, device="CPU")]
    got = TP.idle_by_span(events, t0)
    assert got == [["inner", pytest.approx(20e-6)],
                   ["outer", pytest.approx(10e-6)]]
    assert TP.idle_by_span(events, t0 + 10**9) == [
        ["(no span)", pytest.approx(30e-6)]]


def test_trace_writes_the_spans_track_and_spans_json(tmp_path):
    x = torch.ones(64, 64)
    with TP.trace(str(tmp_path / "tr")):
        with TP.span("step"):
            with TP.span("mm"):
                x @ x
            TP.count("things", 4)
    data = json.loads((tmp_path / "tr" / "trace.json").read_text())
    ev = data["traceEvents"]
    track = [e for e in ev if e.get("cat") == "program_span"]
    assert sorted(e["name"] for e in track) == ["mm", "step"]
    (pid,) = {e["pid"] for e in track}
    assert pid not in {e["pid"] for e in ev if e.get("cat") != "program_span"
                       and e.get("ph") == "X"}
    mm = next(e for e in ev if e.get("name") == "aten::mm")
    span = next(e for e in track if e["name"] == "mm")
    assert span["ts"] - 1 <= mm["ts"] <= mm["ts"] + mm["dur"] <= \
        span["ts"] + span["dur"] + 1
    spans = json.loads((tmp_path / "tr" / "spans.json").read_text())
    assert spans["spans"]["step"]["calls"] == 1
    assert spans["spans"]["mm"]["host_ms"] > 0
    assert spans["counters"] == {"things": 4}
    assert spans["idle_by_span"] == []


# ---------------------------------------------------------------------------
# the benchmark's readers of the registry
# ---------------------------------------------------------------------------

def _render_run():
    cam, cloud = torch_cases.setup(np.random.default_rng(2))
    args = [torch.from_numpy(a) for a in cloud]
    with TP.record():
        for pair_cap in (1000, 3000):
            TR.render(*args, cam, torch.zeros(3), pair_cap=pair_cap,
                      max_per_tile=256, chunk=32)


def _scene_run():
    cfg = PS.PerSceneConfig(**SCENE_CFG)
    args = _scene_step_args(np.random.default_rng(3), cfg)
    with TP.record():
        for _ in range(2):
            PS.train_step(*args)


def _train_run():
    from f3d_gaus_torch.models import clip as TCl
    from f3d_gaus_torch.models import vgg as TV
    from f3d_gaus_torch.pipeline import config as TC
    from f3d_gaus_torch.pipeline import dataset as TD
    from f3d_gaus_torch.train import feedforward as TF
    cfg = TC.PipelineConfig(resolution=32, base_dim=32, num_blocks=1,
                            attn_resolutions=(8,), model_channels=32,
                            pair_cap=1 << 14, max_per_tile=2048, chunk=128)
    state = TF.init_state(torch.Generator().manual_seed(0), cfg, lr=1e-4,
                          device="cpu")
    pack = TF.make_cameras_pack(cfg, TD.canonical_cameras(cfg), n_banks=1,
                                views_per_bank=1)
    gen = torch.Generator().manual_seed(1)
    towers = {"vgg": TV.VGG16(gen), "clip": TCl.CLIPVisual(7, gen)}
    for t in towers.values():
        t.requires_grad_(False)
    rng = np.random.default_rng(4)
    batch = {"images": rng.uniform(size=(1, 32, 32, 3)).astype(np.float32),
             "depth": rng.uniform(6.8, 8.5, size=(1, 32, 32)).astype(
                 np.float32)}
    with TP.record():
        TF.train_step(state, cfg, batch, pack,
                      TF.LossWeights(w_perceptual=2.0, w_clip=0.35),
                      towers=towers)


@pytest.fixture(scope="module")
def registries():
    """The snapshot of a CPU run of each cell's layers under record()."""
    out = {}
    for key, run in (("nvs", _render_run), ("fit", _scene_run),
                     ("train", _train_run)):
        run()
        out[key] = TP.snapshot()
    return out


def _per(snap, names, per):
    s = snap["spans"]
    return sum(s[n]["device_ms"] for n in names) / s[per]["calls"]


READERS = {
    "bin_slots_per_pair.nvs": ("nvs", lambda s: (
        (1024 + 3072) / s["counters"]["binning.pairs"])),
    "bin_ms.nvs": ("nvs", lambda s: _per(s, ["binning"], "binning")),
    "stage_ms.fit_forward": ("fit", lambda s: _per(s, ["forward"],
                                                   "fit_step")),
    "stage_ms.fit_backward": ("fit", lambda s: _per(s, ["backward"],
                                                    "fit_step")),
    "stage_ms.fit_adam": ("fit", lambda s: _per(s, ["adam"], "fit_step")),
    "predictor_fwd_ms.train": ("train", lambda s: _per(s, ["predictor"],
                                                       "step")),
    "towers_fwd_ms.train": ("train", lambda s: _per(s, ["vgg", "clip"],
                                                    "step")),
}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_reads_the_programs_registry(metric, registries, monkeypatch):
    """None on an empty run; on a traced run, the registry's number."""
    from benchmark import harness as H
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(m for m in spec["per_layer"] if m["name"] == metric)
    cell = H.load_cell(entry["workloads"][0])
    read = H.load_reader(metric)
    run = H.Run(cell, 1.0)
    assert read(run) is None
    key, want = READERS[metric]
    snap = registries[key]
    monkeypatch.setattr(TP, "snapshot", lambda: snap)
    run.trace = H.TraceSummary(1.0, 0.5, [], {}, {}, [], [])
    got = read(run)
    assert got == pytest.approx(want(snap)) and got > 0
    spans = snap["spans"]
    if key == "fit":
        assert spans["fit_step"]["calls"] == 2
    if key == "train":
        assert spans["step"]["calls"] == 1 and spans["predictor"]["calls"] == 2
        assert spans["clip"]["calls"] == 2 and spans["vgg"]["calls"] >= 2
