"""A training step's FLOPs (the predictor's two calls forward and backward
and the towers' terms, counted by the benchmark) times the traced
window's steps over its seconds, against 67 TFLOP/s FP32."""
from benchmark.readers import mfu_pct


def read(run):
    return mfu_pct(run, "flops_per_step", "steps")
