"""The attention's share of its roofline in the traced request: the
benchmark's count of one attention's least time
(benchmark/counts_gslrm.py:attention_bound, 4 N² w operations at the
FP32 peak) times the program's `attention` spans, over those spans'
device milliseconds.  It reads the same work whatever implements the
attention."""
from benchmark.program import program_snapshot


def read(run):
    bound = run.counts.get("attn_bound_ms")
    snap = program_snapshot(run)
    if not bound or snap is None:
        return None
    a = snap["spans"].get("attention")
    if not a or not a["device_ms"]:
        return None
    return 100.0 * bound * a["calls"] / a["device_ms"]
