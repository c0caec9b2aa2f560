"""Due time to first token, 90th percentile over every request due in
the window (a failed or unfinished request counts as missing)."""
from rcbench.metrics import ttfts
from rcbench.stats import pct


def read(run):
    return pct(ttfts(run), 90)
