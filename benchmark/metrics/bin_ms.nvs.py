"""Device milliseconds per call of ops.binning.bin_gaussians in the traced
request (the program's span `binning`, CUDA events at its ends)."""
from benchmark.program import span_ms_per


def read(run):
    return span_ms_per(run, ["binning"], "binning")
