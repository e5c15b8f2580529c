"""AnySplat's forward FLOPs (DINOv2, the aggregator's frame and global
blocks, the camera head, both DPT heads; counted by the benchmark,
benchmark/counts_anysplat.py) times the scenes served, over the traced
window's seconds, against 67 TFLOP/s FP32."""
from benchmark.readers import mfu_pct


def read(run):
    return mfu_pct(run, "flops_per_scene", "scenes")
