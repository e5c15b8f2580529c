"""Device milliseconds per call of ops.rasterize.prepare (preprocess and
binning) in the profiled iterations of the fit."""
from benchmark.readers import span_device_ms


def read(run):
    return span_device_ms(run, "bench.prepare")
