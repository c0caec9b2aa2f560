"""Cache-aware global scheduling (§III-C1) — the port of the JAX package's
`core/scheduler.py`.

Affinity(R, p) = α · Hit(R, p) + β · (1 − Load(p))          (Eq. 2)

Hit(R, p) = |I(R) ∩ C(p)| / |I(R)| from the placement map;
Load(p) = normalized queue depth.  Single-objective ablations (Hit-Only,
Load-Only) and stateless baselines (round-robin, least-loaded, seeded
random) included — the policies of Fig. 10.  Host numpy: routing reads no
device state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.placement import Placement


@dataclass
class SchedulerState:
    k: int
    queue_depth: np.ndarray                 # outstanding work per instance (s)
    rr_next: int = 0

    @staticmethod
    def fresh(k: int) -> "SchedulerState":
        return SchedulerState(k=k, queue_depth=np.zeros(k))


def hit_ratio(items: np.ndarray, placement: Placement, instance: int) -> float:
    return placement.hit_rate(items, instance)


def hit_vector(items: np.ndarray, placement: Placement) -> np.ndarray:
    """Hit(R, p) for all instances p at once."""
    hits = np.zeros(placement.k)
    for it in items:
        s = placement.shard_of[int(it)]
        if s < 0:
            hits += 1.0
        else:
            hits[s] += 1.0
    return hits / max(len(items), 1)


def load_vector(state: SchedulerState) -> np.ndarray:
    q = state.queue_depth
    hi = q.max()
    return q / hi if hi > 0 else np.zeros_like(q)


def route(items: np.ndarray, placement: Placement, state: SchedulerState,
          policy: str = "affinity", alpha: float = 0.7, beta: float = 0.3,
          rng: Optional[np.random.Generator] = None) -> int:
    """Pick the serving instance for one request."""
    if policy == "round_robin":
        p = state.rr_next % state.k
        state.rr_next += 1
        return p
    if policy == "random":
        return int((rng or np.random.default_rng()).integers(0, state.k))
    if policy == "least_loaded":
        return int(np.argmin(state.queue_depth))
    hits = hit_vector(items, placement)
    load = load_vector(state)
    if policy == "hit_only":
        score = hits - 1e-9 * load            # tie-break on load
    elif policy == "load_only":
        score = -load
    elif policy == "affinity":
        score = alpha * hits + beta * (1.0 - load)       # Eq. 2
    else:
        raise ValueError(policy)
    return int(np.argmax(score))


POLICIES = ("affinity", "hit_only", "load_only", "round_robin",
            "least_loaded", "random")


class ClusterScheduler:
    """Eq. 2 dispatcher over *live* worker load: serving hands it each
    worker's measured backlog at every arrival
    (`serving.batching.WorkerState.backlog_seconds`).  Stateful, so
    round-robin and the seeded RNG carry across calls."""

    def __init__(self, placement: Placement, policy: str = "affinity",
                 alpha: float = 0.7, beta: float = 0.3, seed: int = 0):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; one of {POLICIES}")
        self.placement = placement
        self.policy = policy
        self.alpha = alpha
        self.beta = beta
        self.state = SchedulerState.fresh(placement.k)
        self.rng = np.random.default_rng(seed)

    def dispatch(self, items: Sequence[int], queue_depth: Sequence[float]) -> int:
        """Route one request given its item set and live queue depths."""
        self.state.queue_depth = np.asarray(queue_depth, float)
        return route(np.asarray(items), self.placement, self.state,
                     policy=self.policy, alpha=self.alpha, beta=self.beta,
                     rng=self.rng)
