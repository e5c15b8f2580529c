"""The requests' predictor FLOPs (9 image forwards at B = 1, counted by the
benchmark) over the traced window's seconds, against 67 TFLOP/s FP32."""
from benchmark.readers import mfu_pct


def read(run):
    return mfu_pct(run, "flops_per_image", "images")
