"""The port's tracing and timing helpers (f3d_gaus_torch/utils/
profiling.py) against the contract of the JAX package's
(f3d_gaus_tpu/utils/profiling.py): `trace` writes a readable Chrome trace,
`timed` calls its function warmup + iters times and returns (mean seconds,
the last output), and `StepTimer`'s EMA equals JAX's under the same
clock."""
import json

import torch

from f3d_gaus_tpu.utils import profiling as JP
from f3d_gaus_torch import utils as TU
from f3d_gaus_torch.utils import profiling as TP

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


def test_step_timer_matches_jax(monkeypatch):
    ticks = [0.0, 0.5, 0.7, 1.6, 1.65, 3.0]

    def run(module):
        clock = iter(ticks)
        monkeypatch.setattr(module.time, "perf_counter", lambda: next(clock))
        t = module.StepTimer(alpha=0.3)
        return [t.tick() for _ in ticks]
    assert run(TP) == run(JP)
    assert run(TP)[0] == 0.0 and run(TP)[1] == 0.5
