"""Device milliseconds of GaussianPredictor.forward per training step (the
step's two predictor calls; the program's spans `predictor` under the root
`step`, CUDA events at their ends) in the traced step."""
from benchmark.program import span_ms_per


def read(run):
    return span_ms_per(run, ["predictor"], "step")
