"""Rows in each decode step: the decode tokens of the window's ticks
that decode (`batching.TickRecord.decode_tokens`), mean."""
from rcbench.stats import mean


def read(run):
    return mean([t.decode_tokens for t in run.ticks if t.decode_tokens > 0])
