"""Device milliseconds of AnySplat's forward per traced request (the
program's span `anysplat` over the root span `recon`, CUDA events at its
ends)."""
from benchmark.program import span_ms_per


def read(run):
    return span_ms_per(run, ["anysplat"], "recon")
