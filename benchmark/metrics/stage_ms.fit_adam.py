"""Device milliseconds per per_scene.train_step in its adam phase (Adam and
the densification statistics) over the profiled iterations of the fit (the
program's span `adam` under its root `fit_step`, CUDA events at the
phase's ends)."""
from benchmark.program import span_ms_per


def read(run):
    return span_ms_per(run, ["adam"], "fit_step")
