"""Long-LRM's forward FLOPs (tokenizer, Mamba2 and transformer blocks,
merge, head; counted by the benchmark, benchmark/counts_longlrm.py) times
the scenes served, over the traced window's seconds, against 67 TFLOP/s
FP32."""
from benchmark.readers import mfu_pct


def read(run):
    return mfu_pct(run, "flops_per_scene", "scenes")
