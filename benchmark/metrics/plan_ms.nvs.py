"""Device milliseconds of the serving path's cap planning per traced
request (the program's spans `plan_caps`, one per planned render stage,
over the root span `request`); none where the program plans no caps."""
from benchmark.program import span_ms_per


def read(run):
    return span_ms_per(run, ["plan_caps"], "request")
