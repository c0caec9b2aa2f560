"""Due time to first token, median over every request due in the window;
a request that failed or did not finish counts as missing (infinite)."""
from rcbench.metrics import ttfts
from rcbench.stats import pct


def read(run):
    return pct(ttfts(run), 50)
