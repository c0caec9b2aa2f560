"""The chunked scheduler's tick: the worker's measured seconds of each
tick in the window (`batching.TickRecord.seconds`), 95th percentile."""
from rcbench.stats import pct


def read(run):
    return pct([t.seconds * 1e3 for t in run.ticks], 95)
