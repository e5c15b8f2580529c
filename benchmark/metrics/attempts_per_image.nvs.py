"""run_nvs_replanned attempts per request over the window
(NVSResult.attempts; 1 = no cap doubling)."""


def read(run):
    a = run.counters.get("attempts")
    return sum(a) / len(a) if a else None
