"""Device milliseconds of the Mamba2 blocks per traced request (the
program's 21 `mamba2` spans, each a block's LayerNorm, projections, conv,
scan and gated norm, over the root span `recon`)."""
from benchmark.program import span_ms_per


def read(run):
    return span_ms_per(run, ["mamba2"], "recon")
