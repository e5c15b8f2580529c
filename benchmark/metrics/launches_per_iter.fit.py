"""Kernels (device operations other than copies and fills) in the profiled
iterations of the fit, per iteration."""


def read(run):
    n = run.counts.get("trace_iters")
    if run.trace is None or not n:
        return None
    kernels = [k for k in run.trace.kernels
               if not k[0].startswith(("Memcpy", "Memset"))]
    return len(kernels) / n
