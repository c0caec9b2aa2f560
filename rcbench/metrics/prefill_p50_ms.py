"""The batch engine's prefill: first token minus admission
(`batching.Completion.prefill_s`, on the worker's clock), median over
the window's finished requests."""
from rcbench.stats import pct


def read(run):
    c = [run.completions[r.rid] for r in run.window_reqs() if r.rid in run.completions]
    return pct([x.prefill_s * 1e3 for x in c], 50)
