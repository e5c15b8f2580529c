"""K1's share of its roofline at the traced request's orbit renders: the
frozen count's least time (benchmark/counts.py:k1_bound, at the sampled
orbit views of the request's merged set) over the device time of the
decision and compositing kernels of those renders (the last
num_nvs_views + 1 launches of each in the traced request, in orbit
order)."""
from benchmark.readers import kernels_named


def read(run):
    bounds = run.counts.get("k1_bound_ms")
    decide = kernels_named(run, "gof_decide")
    fwd = kernels_named(run, "raster_fwd")
    n = run.counts.get("n_nvs")
    if not bounds or len(decide) < n or len(fwd) < n:
        return None
    ms = sum((decide[-n + v][2] + fwd[-n + v][2]) / 1e3
             for v in run.counts["nvs_views"])
    return 100.0 * sum(bounds) / ms
