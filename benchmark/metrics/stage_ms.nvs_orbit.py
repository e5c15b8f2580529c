"""Milliseconds of run_nvs's nvs_orbit stage per request
(run_nvs(timings=), traced run)."""
from benchmark.readers import mean_stage_ms


def read(run):
    return mean_stage_ms(run, "stage_s", "nvs_orbit")
