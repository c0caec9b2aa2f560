"""The load generator's lateness: submit time minus due time (the
request's preparation included), 90th percentile over the window."""
from rcbench.stats import pct


def read(run):
    return pct([(r.submit - r.due) * 1e3 for r in run.window_reqs()], 90)
