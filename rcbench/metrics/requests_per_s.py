"""Requests completed in the window over the window's length."""
from rcbench.stats import rate


def read(run):
    done = [r.done for r in run.reqs if r.finished(run.n_out)]
    return rate(done, run.t0, run.t1)
