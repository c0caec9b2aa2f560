"""Metric readers, found by name: `rcbench/metrics/<name>.py`, or, for a
name with a suffix such as `prefill_p50_ms.busy`, the reader of the part
before the first dot.  A reader's `read(run)` takes the metric from what
the run recorded (`serve.Run`) and returns a number, or None where it
finds nothing to read; the harness then leaves the metric out."""
from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def reader(name: str):
    for stem in (name, name.split(".")[0]):
        path = HERE / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"rcbench.metrics._{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise KeyError(f"no reader for metric {name!r} under {HERE}")


def window_work(run):
    """The window's counted work (`counts.window`), once per run."""
    from rcbench.counts.window import window_work as count

    if getattr(run, "_work", None) is None:
        run._work = count(run)
    return run._work


def roofline(run, key: str, *needles: str):
    """A kernel's share of its roofline over the traced window: the bound
    of the work the window's requests needed, over the device time of the
    events whose names hold a needle, in %."""
    if run.trace is None or not run.trace.events:
        return None
    t = run.trace.seconds_matching(*needles)
    w = window_work(run)
    if t <= 0 or w.bound_s(key) <= 0:
        return None
    return 100.0 * w.bound_s(key) / t


def ttfts(run):
    """Due time to first token (ms) of every request due in the window; a
    request that failed or did not finish is missing (infinite)."""
    import math

    return [(r.times[0] - r.due) * 1e3 if r.finished(run.n_out) else math.inf
            for r in run.window_reqs()]
