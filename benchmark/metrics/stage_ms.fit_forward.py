"""Device milliseconds per per_scene.train_step in its forward phase (the
render and the loss) over the profiled iterations of the fit (the
program's span `forward` under its root `fit_step`, CUDA events at the
phase's ends)."""
from benchmark.program import span_ms_per


def read(run):
    return span_ms_per(run, ["forward"], "fit_step")
