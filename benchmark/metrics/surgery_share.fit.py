"""Share of the window in fit_scene's surgery and cap planning
(fit_scene(timings=): surgery_s + plan_s, traced run)."""


def read(run):
    t = run.spans.get("fit_s")
    secs = run.counters.get("window_s")
    if not t or not secs:
        return None
    return 100.0 * (t.get("surgery_s", 0.0) + t.get("plan_s", 0.0)) / secs
