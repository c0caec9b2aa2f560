"""Algorithm 1: similarity-aware item placement with global hot replicas.

Phase 1  compute item popularity from historical requests
Phase 2  replicate the top 0.1% hottest items on every instance
Phase 3  long-tail items become graph nodes
Phase 4  edge weights = co-occurrence counts in historical requests
Phase 5  k-way partition minimizing edge cut under a balance constraint

METIS is not available offline, so Phase 5 is our own multilevel-flavored
partitioner: LDG-style weighted greedy streaming (heavy items first) followed
by boundary Kernighan–Lin refinement sweeps.  Same objective, same contract.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclass
class Placement:
    k: int
    hot_items: np.ndarray                  # replicated everywhere
    shard_of: np.ndarray                   # (n_items,) int32; -1 for hot
    edge_cut: float
    balance: np.ndarray                    # heat per shard

    def holders(self, item: int) -> Sequence[int]:
        if self.shard_of[item] < 0:
            return range(self.k)
        return (int(self.shard_of[item]),)

    def is_local(self, item: int, instance: int) -> bool:
        s = self.shard_of[item]
        return s < 0 or s == instance

    def items_on(self, instance: int) -> np.ndarray:
        return np.where((self.shard_of == instance) | (self.shard_of < 0))[0]

    def hit_rate(self, items: Sequence[int], instance: int) -> float:
        """Fraction of `items` resident on `instance` (hot replicas hit
        everywhere); 1.0 for no items."""
        if len(items) == 0:
            return 1.0
        return float(np.mean([self.is_local(int(i), instance) for i in items]))


def popularity_from_requests(n_items: int,
                             request_items: Sequence[np.ndarray]) -> np.ndarray:
    h = np.zeros(n_items, np.float64)
    for items in request_items:
        np.add.at(h, items, 1.0)
    return h


def cooccurrence_graph(n_items: int, request_items: Sequence[np.ndarray],
                       max_pairs_per_request: int = 64,
                       seed: int = 0) -> Dict[Tuple[int, int], float]:
    """Edge weights = co-occurrence counts (sampled pairs for long requests)."""
    rng = np.random.default_rng(seed)
    edges: Dict[Tuple[int, int], float] = {}
    for items in request_items:
        it = np.unique(items)
        n = len(it)
        pairs = [(int(it[i]), int(it[j]))
                 for i in range(n) for j in range(i + 1, n)]
        if len(pairs) > max_pairs_per_request:
            idx = rng.choice(len(pairs), max_pairs_per_request, replace=False)
            pairs = [pairs[i] for i in idx]
        for a, b in pairs:
            e = (a, b) if a < b else (b, a)
            edges[e] = edges.get(e, 0.0) + 1.0
    return edges


def partition(n_items: int, popularity: np.ndarray,
              edges: Dict[Tuple[int, int], float], k: int,
              hot_frac: float = 0.001, balance_slack: float = 1.1,
              refine_sweeps: int = 2, seed: int = 0) -> Placement:
    """Algorithm 1, Phases 1–5."""
    order = np.argsort(-popularity)
    n_hot = max(1, int(np.ceil(hot_frac * n_items)))
    hot = order[:n_hot]
    hot_set = set(int(h) for h in hot)

    # adjacency over cold items only
    adj: List[Dict[int, float]] = [dict() for _ in range(n_items)]
    for (a, b), w in edges.items():
        if a in hot_set or b in hot_set:
            continue                        # hot replicas cut no edges
        adj[a][b] = adj[a].get(b, 0.0) + w
        adj[b][a] = adj[b].get(a, 0.0) + w

    shard_of = np.full(n_items, -2, np.int32)
    shard_of[hot] = -1
    heat = np.zeros(k, np.float64)
    cap = popularity[order[n_hot:]].sum() / k * balance_slack + 1e-9

    # Phase 5a: LDG greedy streaming in BFS order over the similarity graph
    # (neighbors stream consecutively so the locality gain term is live;
    # components are seeded in popularity order — heavy clusters first).
    cold_order = []
    visited = np.zeros(n_items, bool)
    visited[hot] = True
    import collections
    for seed_i in order[n_hot:]:
        seed_i = int(seed_i)
        if visited[seed_i]:
            continue
        dq = collections.deque([seed_i])
        visited[seed_i] = True
        while dq:
            u = dq.popleft()
            cold_order.append(u)
            nbrs = sorted(adj[u].items(), key=lambda kv: -kv[1])
            for vtx, _w in nbrs:
                if not visited[vtx]:
                    visited[vtx] = True
                    dq.append(vtx)
    for i in cold_order:
        i = int(i)
        gain = np.zeros(k)
        for j, w in adj[i].items():
            if shard_of[j] >= 0:
                gain[shard_of[j]] += w
        penalty = heat / cap
        score = gain + 1e-6 - penalty * (1e-6 + gain.mean() + 1.0)
        score[heat + popularity[i] > cap] = -np.inf
        tgt = int(np.argmax(score))
        if not np.isfinite(score[tgt]):
            tgt = int(np.argmin(heat))
        shard_of[i] = tgt
        heat[tgt] += popularity[i]

    # Phase 5b: KL-style boundary refinement
    cold = [int(i) for i in order[n_hot:]]
    for _ in range(refine_sweeps):
        moved = 0
        for i in cold:
            s = shard_of[i]
            gain = np.zeros(k)
            for j, w in adj[i].items():
                if shard_of[j] >= 0:
                    gain[shard_of[j]] += w
            best = int(np.argmax(gain))
            if best != s and gain[best] > gain[s] and \
               heat[best] + popularity[i] <= cap:
                shard_of[i] = best
                heat[s] -= popularity[i]
                heat[best] += popularity[i]
                moved += 1
        if moved == 0:
            break

    cut = 0.0
    for (a, b), w in edges.items():
        sa, sb = shard_of[a], shard_of[b]
        if sa >= 0 and sb >= 0 and sa != sb:
            cut += w
    return Placement(k=k, hot_items=np.sort(hot).astype(np.int32),
                     shard_of=shard_of, edge_cut=cut, balance=heat)


def place(n_items: int, request_items: Sequence[np.ndarray], k: int,
          **kw) -> Placement:
    """Full Algorithm-1 pipeline from a historical request log."""
    pop = popularity_from_requests(n_items, request_items)
    edges = cooccurrence_graph(n_items, request_items)
    return partition(n_items, pop, edges, k, **kw)



def random_placement(n_items: int, popularity: np.ndarray, k: int,
                     hot_frac: float = 0.001, seed: int = 0) -> Placement:
    """Ablation baseline: hash-random sharding (no similarity awareness)."""
    rng = np.random.default_rng(seed)
    order = np.argsort(-popularity)
    n_hot = max(1, int(np.ceil(hot_frac * n_items)))
    shard_of = rng.integers(0, k, n_items).astype(np.int32)
    shard_of[order[:n_hot]] = -1
    heat = np.zeros(k)
    for i in range(n_items):
        if shard_of[i] >= 0:
            heat[shard_of[i]] += popularity[i]
    return Placement(k=k, hot_items=np.sort(order[:n_hot]).astype(np.int32),
                     shard_of=shard_of, edge_cut=float("nan"), balance=heat)


def needs_refresh(old_pop: np.ndarray, new_pop: np.ndarray,
                  drift_threshold: float = 0.25) -> bool:
    """Popularity-drift trigger for a background re-run of Algorithm 1:
    the total-variation distance between the normalised popularities
    exceeds `drift_threshold`."""
    a = old_pop / max(old_pop.sum(), 1e-9)
    b = new_pop / max(new_pop.sum(), 1e-9)
    return float(np.abs(a - b).sum()) / 2.0 > drift_threshold
