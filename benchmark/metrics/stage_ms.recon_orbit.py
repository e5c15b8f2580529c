"""The mean wall milliseconds of run_gslrm's `orbit` stage (the turntable's
cap plan and renders) over the traced run's requests."""
from benchmark.readers import mean_stage_ms


def read(run):
    return mean_stage_ms(run, "stage_s", "orbit")
