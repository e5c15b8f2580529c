"""The harness: cells found by name, a cell added as files alone, the
result line, the refusals (no card, JAX loaded), the trace's reduction
and the per-layer readers."""
import json
import shutil
import sys
import types

import pytest

from benchmark import harness as H
from runs import run_cell

SPEC = json.loads((H.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_by_name(name):
    cell = H.load_cell(name)
    assert cell.config and cell.traffic and cell.limits["limits"]
    assert (H.BENCH / "loops" / f"{cell.traffic['loop']}.py").exists()
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        H.load_cell("no_such.cell")


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_each_per_layer_metric_has_a_reader_that_reads_nothing_empty(metric):
    cell = H.load_cell(next(w for w in CELLS if w in metric_cells(metric)))
    assert H.load_reader(metric)(H.Run(cell, 1.0)) is None


def metric_cells(metric):
    m = next(x for x in SPEC["per_layer"] if x["name"] == metric)
    return m["workloads"]


def test_spec_names_and_units_follow_the_rules():
    import re
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in SPEC["workloads"]:
        assert name.match(w["name"]) and len(w["why"]) <= 200
        assert any(m["name"] != "setup_s" and w["name"] in m.get(
            "workloads", CELLS) for m in SPEC["end_to_end"])
        assert any(w["name"] in m["workloads"] for m in SPEC["per_layer"])
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_result_line_of_a_run(tmp_path, name):
    rc, res, err = run_cell(tmp_path, name)
    assert rc == 0, err
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, err
    cell = H.load_cell(name)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        got = res["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["checks"]) == set(cell.limits["limits"])
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") for line in tail)


def test_a_cell_added_as_files_alone(tmp_path):
    """A new mix of an existing loop: a traffic file, a limits file and
    an entry in BENCHMARK.json, no code."""
    def add(spec):
        spec["workloads"].append({
            "name": "imagenetgs_256.nvs_b1_two", "config": "imagenetgs_256",
            "traffic": "nvs_b1_two", "chips": 1, "why": "two images"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if "imagenetgs_256.nvs_b1" in m.get("workloads", []):
                m["workloads"].append("imagenetgs_256.nvs_b1_two")
    from tiny import tiny_root
    root = tiny_root(tmp_path, add)
    bench = root / "benchmark"
    t = json.loads((bench / "traffic" / "nvs_b1.json").read_text())
    (bench / "traffic" / "nvs_b1_two.json").write_text(
        json.dumps({**t, "pool": 2, "data_seed": 5}))
    shutil.copy(bench / "workloads" / "imagenetgs_256.nvs_b1.json",
                bench / "workloads" / "imagenetgs_256.nvs_b1_two.json")
    rc, res, err = run_cell(tmp_path, "imagenetgs_256.nvs_b1_two", root=root)
    assert rc == 0 and res["correct"], err


def test_no_card_no_result(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc, res, err = run_cell(tmp_path, CELLS[0], device=None)
    assert rc != 0 and res is None and "CUDA" in err


def test_jax_loaded_in_the_window_refuses_the_result(tmp_path, monkeypatch):
    from benchmark.loops import nvs
    window = nvs.window

    def loads_jax(*a, **k):
        sys.modules["jax"] = types.ModuleType("jax")
        return window(*a, **k)
    monkeypatch.setattr(nvs, "window", loads_jax)
    try:
        rc, res, err = run_cell(tmp_path, "imagenetgs_256.nvs_b1")
    finally:
        sys.modules.pop("jax", None)
    assert rc != 0 and res is None and "jax" in err


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client",
                        types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "f3d_gaus_tpu_extra",
                        types.ModuleType("y"))
    found = H.forbidden_modules()
    assert "jaxlib" in found and "f3d_gaus_tpu_extra" not in found
    assert "f3d_gaus_torch" not in found


def test_checks_fail_above_the_limit_and_on_nan():
    c = H.Checks({"a": 1.0, "b": 0.0})
    c.add("a", 0.5)
    c.add("b", 0.0)
    assert c.correct
    c.add("a", float("nan"))
    assert not c.correct
    assert [line.split()[-1] for line in c.lines()] == ["ok", "ok", "FAILED"]


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end


class _Ev:
    def __init__(self, name, dev, start, end, device_us=0.0):
        from torch.autograd import DeviceType
        self.name = name
        self.device_type = DeviceType.CUDA if dev else DeviceType.CPU
        self.time_range = _Range(start, end)
        self.device_time_total = device_us


def test_reduce_trace_busy_gaps_and_spans():
    ev = [_Ev("k1", True, 0, 10), _Ev("k2", True, 5, 20),
          _Ev("k3", True, 30, 40), _Ev("bench.prepare", True, 0, 40),
          _Ev("bench.prepare", False, 0, 22, device_us=25.0),
          _Ev("aten::item", False, 21, 29), _Ev("outer", False, 0, 45)]
    s = H.reduce_trace(ev, window_s=50e-6)
    assert s.busy_s == pytest.approx(30e-6)      # [0, 20] and [30, 40]
    assert [k[0] for k in s.kernels] == ["k1", "k2", "k3"]
    assert s.span_device_us == {"bench.prepare": 25.0}
    assert s.span_calls == {"bench.prepare": 1}
    # the gap [20, 30] has its middle in aten::item (innermost)
    assert s.idle_gaps == [["aten::item", pytest.approx(10e-6)]]
    assert s.device_ops[0][0] in ("k2", "k1", "k3")
