"""Share of the traced request in which no device operation ran."""
from benchmark.readers import device_idle_pct


def read(run):
    return device_idle_pct(run)
