"""Device milliseconds per call of ops.rasterize.prepare (preprocess and
binning) in the traced training step."""
from benchmark.readers import span_device_ms


def read(run):
    return span_device_ms(run, "bench.prepare")
