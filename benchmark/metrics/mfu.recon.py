"""GS-LRM's forward FLOPs (tokenizer, blocks, head; counted by the
benchmark, benchmark/counts_gslrm.py) times the objects served, over the
traced window's seconds, against 67 TFLOP/s FP32."""
from benchmark.readers import mfu_pct


def read(run):
    return mfu_pct(run, "flops_per_object", "objects")
