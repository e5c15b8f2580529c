"""The attentions' share of their roofline in the traced request: the
benchmark's count of the least time of every attention in a request
(benchmark/counts_anysplat.py:attention_bound, 4 L² d operations a head
at the FP32 peak: DINOv2's, the frame and global blocks' and the camera
trunk's), times the requests the program's `attention` spans cover, over
those spans' device milliseconds.  It reads the same work whatever
implements the attention."""
from benchmark.program import program_snapshot


def read(run):
    bound = run.counts.get("attn_bound_ms")
    calls = run.counts.get("attn_calls")
    snap = program_snapshot(run)
    if not bound or not calls or snap is None:
        return None
    a = snap["spans"].get("attention")
    if not a or not a["device_ms"]:
        return None
    return 100.0 * bound * (a["calls"] / calls) / a["device_ms"]
