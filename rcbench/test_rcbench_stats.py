"""The metric arithmetic: tails over every request, with a missing request
counted in the tail, and a rate over the whole window."""
import math
from types import SimpleNamespace

import numpy as np

from rcbench import stats
from rcbench.metrics import reader
from rcbench.serve import Req, Run


def test_pct_is_nearest_rank_over_all_values():
    xs = list(range(1, 101))
    assert stats.pct(xs, 50) == 50 and stats.pct(xs, 90) == 90 and stats.pct(xs, 100) == 100
    assert stats.pct([3.0], 95) == 3.0 and stats.pct([], 50) is None


def test_a_missing_request_counts_in_the_tail():
    xs = [10.0] * 95 + [math.inf] * 5
    assert stats.pct(xs, 90) == 10.0
    assert stats.pct(xs + [math.inf] * 6, 90) == math.inf


def test_rate_is_over_the_whole_window_so_a_stall_moves_it():
    steady = np.arange(0.0, 10.0, 0.1)
    stalled = np.concatenate([np.arange(0.0, 5.0, 0.1), np.arange(8.0, 10.0, 0.1)])
    assert abs(stats.rate(steady, 0.0, 10.0) - 10.0) < 1e-9
    assert stats.rate(stalled, 0.0, 10.0) < 0.75 * stats.rate(steady, 0.0, 10.0)


def _run(reqs, t0=0.0, t1=10.0):
    cell = SimpleNamespace(config={}, traffic={})
    return Run(cell=cell, seed=0, t0=t0, t1=t1, reqs=reqs, ticks=[], completions={},
               spans=[], n_out=3)


def _req(i, due, first, gap=0.05, n_out=3, reason="length"):
    r = Req(rid=i, due=due, submit=due + 0.001)
    r.times = [first + k * gap for k in range(n_out)]
    r.tokens = [1] * n_out
    r.reason, r.done = reason, r.times[-1]
    return r


def test_ttft_is_from_the_due_time_and_only_the_window_counts():
    reqs = [_req(i, 0.1 * i, 0.1 * i + 0.2) for i in range(100)]
    reqs.append(_req(100, -1.0, 5.0))                 # due before the window
    run = _run(reqs)
    assert abs(reader("ttft_p50_ms")(run) - 200.0) < 1e-6
    assert abs(reader("tbt_p95_ms")(run) - 50.0) < 1e-6
    reqs[3].reason = "cancelled"                      # failed: missing
    reqs[4].tokens = [1]                              # unfinished: missing
    reqs[5].reason = "rejected"
    assert abs(reader("ttft_p90_ms")(run) - 200.0) < 1e-6
    for r in reqs[6:20]:
        r.reason = "cancelled"
    assert reader("ttft_p90_ms")(run) == math.inf


def test_requests_per_s_counts_completions_in_the_window():
    reqs = [_req(i, 0.05 * i, 0.05 * i + 0.1) for i in range(220)]
    run = _run(reqs)
    done_in = sum(1 for r in reqs if 0.0 <= r.done < 10.0)
    assert abs(reader("requests_per_s")(run) - done_in / 10.0) < 1e-9
