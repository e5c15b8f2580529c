"""Device milliseconds per per_scene.train_step in its backward phase
(autograd's backward) over the profiled iterations of the fit (the
program's span `backward` under its root `fit_step`, CUDA events at the
phase's ends)."""
from benchmark.program import span_ms_per


def read(run):
    return span_ms_per(run, ["backward"], "fit_step")
