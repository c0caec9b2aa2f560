"""The work a window's requests needed, from what the run recorded: each
prefill whose first token came in the window, and each decode token
emitted in it, counted by `counts.work`."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np

from rcbench.counts import work as WK


@dataclass
class Work:
    flops: Dict[str, float] = field(default_factory=dict)
    nbytes: Dict[str, float] = field(default_factory=dict)
    model_flops: float = 0.0
    prefills_uncounted: int = 0     # first token in the window, no recompute mask read

    def add(self, key: str, fb) -> None:
        self.flops[key] = self.flops.get(key, 0.0) + float(fb[0])
        self.nbytes[key] = self.nbytes.get(key, 0.0) + float(fb[1])

    def bound_s(self, key: str) -> float:
        return WK.bound_s(self.flops.get(key, 0.0), self.nbytes.get(key, 0.0))


def window_work(run) -> Work:
    s = WK.Shape.of(run.cell.config)
    w = Work()
    for r in run.reqs:
        if r.times and run.in_window(r.times[0]):
            if r.recompute is None:
                w.prefills_uncounted += 1
            else:
                r_pos = np.where(r.recompute)[0]
                distinct = len(np.unique(r.table[r.have])) if r.have is not None else 0
                w.add("b2", WK.b2(s, r.n, r_pos))
                w.add("b4", WK.b4_pass(s, r.n, distinct, s.n_layers - 1))
                w.add("b4", WK.b4_copy(s, r.n, distinct))
                w.model_flops += WK.prefill_flops(s, r.n, r_pos)
        ctx = [r.n + k for k in range(1, len(r.times)) if run.in_window(r.times[k])]
        if ctx:
            w.add("b3", WK.b3(s, ctx))
            w.model_flops += sum(WK.decode_flops(s, c) for c in ctx)
    return w
