"""The slots ops.binning walked (its pair_cap, lane-rounded) over the pairs
it binned, summed over the traced request's renders (the program's
counters `binning.slots` and `binning.pairs`)."""
from benchmark.program import counter_ratio


def read(run):
    return counter_ratio(run, "binning.slots", "binning.pairs")
