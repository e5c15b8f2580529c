"""Device milliseconds of the two DPT heads per traced request (the
program's `dpt` spans, depth then Gaussians, over the root span
`recon`)."""
from benchmark.program import span_ms_per


def read(run):
    return span_ms_per(run, ["dpt"], "recon")
