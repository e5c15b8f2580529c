"""Milliseconds of train_step's backward per step (train_step(timings=),
traced run)."""
from benchmark.readers import mean_stage_ms


def read(run):
    return mean_stage_ms(run, "step_s", "backward")
