"""Gap between streamed tokens, 95th percentile over every gap of every
request due in the window."""
from rcbench.stats import pct


def read(run):
    gaps = [(b - a) * 1e3 for r in run.window_reqs() for a, b in zip(r.times, r.times[1:])]
    return pct(gaps, 95)
