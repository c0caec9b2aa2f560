"""Discrete-event cluster simulator (the paper's Vidur-based engine,
§III-D) — the port of the JAX package's `core/simulator.py`, numpy only.

K stateful instances (each holding an item-KV shard and the replicated
semantic pool), a global scheduler routing by Eq. 2, per-instance FIFO
queues, and the analytic cost model (`core.cost_model`) as the clock.
Node failures (requests re-routed, the instance restored after repair),
stragglers (slowdown factors) and hedged requests.  No model runs and
nothing touches a device: `Hardware` names the rates the clock bills,
`cost_model.H100_SXM` for the port.

Outputs per-request TTFT (P50 / P90 / P99), cache hit rates and the
requests per instance.  ``mode="prefix"`` is the industrial
prefix-caching baseline (only the shared instruction prefix is free).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import LMConfig
from repro_torch.core import cost_model as CM
from repro_torch.core.placement import Placement
from repro_torch.core.scheduler import SchedulerState, route


@dataclass
class SimRequest:
    arrival_s: float
    n_total: int                     # prompt tokens
    n_instr: int
    item_ids: np.ndarray
    item_token_counts: np.ndarray
    n_history: int
    history_reuse_frac: float        # fraction of history tokens matched


@dataclass
class SimConfig:
    policy: str = "affinity"
    alpha: float = 0.7
    beta: float = 0.3
    mode: str = "rcllm"              # rcllm | full | prefix
    r_item: float = 0.3
    r_rev: float = 0.3
    window: int = 32
    # §III-C2a iii: item-cache misses are recomputed on the fly (the paper
    # never fetches item KV across nodes); remote_fetch=True pulls peer
    # blocks over the interconnect instead
    remote_fetch: bool = False
    hedge_ms: Optional[float] = None     # straggler mitigation: backup send
    seed: int = 0


@dataclass
class NodeFault:
    instance: int
    t_fail_s: float
    t_repair_s: float


@dataclass
class SimResult:
    ttft_s: np.ndarray
    hit_rates: np.ndarray
    per_instance_load: np.ndarray
    n_requests: int

    def pct(self, q: float) -> float:
        return float(np.percentile(self.ttft_s, q))

    def summary(self) -> Dict[str, float]:
        return {"p50": self.pct(50), "p90": self.pct(90), "p99": self.pct(99),
                "mean": float(self.ttft_s.mean()),
                "mean_hit": float(self.hit_rates.mean())}


def _service_time(cfg: LMConfig, hw: CM.Hardware, req: SimRequest,
                  placement: Placement, instance: int, sim: SimConfig,
                  slow: float) -> Tuple[float, float]:
    """-> (service seconds, hit rate)."""
    if sim.mode == "full":
        return slow * CM.full_prefill_ttft_s(cfg, hw, req.n_total), 0.0
    if sim.mode == "prefix":
        return slow * CM.prefix_cache_ttft_s(cfg, hw, req.n_total, req.n_instr), 0.0

    # RcLLM: resolve item blocks against this instance's shard
    local_t = remote_t = miss_t = 0
    for it, tc in zip(req.item_ids, req.item_token_counts):
        s = placement.shard_of[int(it)]
        if s < 0 or s == instance:
            local_t += int(tc)
        elif sim.remote_fetch:
            remote_t += int(tc)
        else:
            miss_t += int(tc)            # recomputed on the fly (paper)
    hist_hit = int(req.history_reuse_frac * req.n_history)
    local_t += hist_hit                  # the semantic pool is replicated

    n_cached_items = local_t - hist_hit + remote_t
    n_rec = (req.n_instr
             + int(sim.r_item * n_cached_items) + miss_t
             + int(sim.r_rev * hist_hit) + (req.n_history - hist_hit)
             + sim.window)
    n_rec = min(n_rec, req.n_total)
    t = CM.ttft_s(cfg, hw, req.n_total, n_rec, local_t, remote_t)
    hit = (local_t + remote_t) / max(req.n_total - req.n_instr, 1)
    return slow * t, hit


def simulate(cfg: LMConfig, hw: CM.Hardware, requests: Sequence[SimRequest],
             placement: Placement, sim: SimConfig,
             straggler_factors: Optional[np.ndarray] = None,
             faults: Sequence[NodeFault] = ()) -> SimResult:
    k = placement.k
    state = SchedulerState.fresh(k)
    rng = np.random.default_rng(sim.seed)
    free_at = np.zeros(k)                      # next idle time per instance
    slow = straggler_factors if straggler_factors is not None else np.ones(k)
    ttfts, hits = [], []
    load_count = np.zeros(k)

    def is_down(p: int, t: float) -> bool:
        return any(f.instance == p and f.t_fail_s <= t < f.t_repair_s
                   for f in faults)

    for req in requests:
        t = req.arrival_s
        # the scheduler sees queue depth in seconds of outstanding work
        state.queue_depth = np.maximum(free_at - t, 0.0)
        for p in range(k):
            if is_down(p, t):
                state.queue_depth[p] = 1e9    # effectively unroutable
        p = route(req.item_ids, placement, state, policy=sim.policy,
                  alpha=sim.alpha, beta=sim.beta, rng=rng)
        if is_down(p, t):                      # re-route around the fault
            up = [i for i in range(k) if not is_down(i, t)]
            p = up[int(np.argmin(free_at[np.asarray(up)]))] if up else p

        svc, hit = _service_time(cfg, hw, req, placement, p, sim, slow[p])
        start = max(t, free_at[p])

        if sim.hedge_ms is not None:
            # if the primary has not started within the hedge deadline, a
            # backup instance races it (the earlier finish wins)
            deadline = t + sim.hedge_ms * 1e-3
            if start > deadline:
                alt = int(np.argmin(free_at))
                if alt != p and not is_down(alt, t):
                    svc_alt, hit_alt = _service_time(
                        cfg, hw, req, placement, alt, sim, slow[alt])
                    start_alt = max(t, free_at[alt])
                    if start_alt + svc_alt < start + svc:
                        p, svc, hit, start = alt, svc_alt, hit_alt, start_alt

        finish = start + svc
        free_at[p] = finish
        load_count[p] += 1
        ttfts.append(finish - t)
        hits.append(hit)

    return SimResult(ttft_s=np.asarray(ttfts), hit_rates=np.asarray(hits),
                     per_instance_load=load_count, n_requests=len(requests))


def make_sim_setup(profile_name: str = "amazon", k: int = 40,
                   n_requests: int = 2000, qps: float = 80.0,
                   n_candidates: int = 20, n_users: int = 500,
                   n_items: Optional[int] = None, seed: int = 0,
                   placement_kind: str = "similarity"):
    """Paper-scale simulation inputs (numpy only, no model, no KV): a
    profile-shaped catalog, a request trace with the paper's prompt
    composition (median prefill 2.2-3.0K tokens, 207-token instruction),
    and an Algorithm-1 placement built from a separate history trace.
    -> (requests, placement, catalog)."""
    import dataclasses

    from repro_torch.core import placement as PL
    from repro_torch.data import synth as SY

    prof = SY.PROFILES[profile_name]
    if n_items is not None:
        # ~50 items per co-occurrence cluster (the profile default), so a
        # candidate set stays coverable by one replica in a smaller catalog
        prof = dataclasses.replace(prof, n_items=n_items,
                                   n_clusters=max(8, n_items // 50))
    catalog = SY.make_catalog(prof, seed=seed)
    pool = SY.make_review_pool(seed=seed + 1)
    hist = SY.make_trace(catalog, pool, prof, n_requests=max(500, k * 20),
                         qps=qps, n_users=n_users, n_candidates=n_candidates,
                         seed=seed + 2, cluster_bias=0.85)
    req_items = [r.candidate_items for r in hist]
    if placement_kind == "similarity":
        placement = PL.place(catalog.n_items, req_items, k)
    else:
        pop = PL.popularity_from_requests(catalog.n_items, req_items)
        # an independent seed: sharing the catalog's stream would make
        # "random" accidentally cluster-aligned
        placement = PL.random_placement(catalog.n_items, pop, k, seed=seed + 7919)
    trace = SY.make_trace(catalog, pool, prof, n_requests=n_requests,
                          qps=qps, n_users=n_users, n_candidates=n_candidates,
                          seed=seed + 3, cluster_bias=0.85)
    return requests_from_trace(trace, catalog, n_instr=207), placement, catalog


def requests_from_trace(trace, catalog, n_instr: int,
                        history_reuse_frac: float = 0.93) -> List[SimRequest]:
    """Synthetic trace requests (`data.synth`) as simulator inputs;
    `history_reuse_frac` defaults to the paper's >= 93% match rate (Fig. 3b)."""
    out = []
    for r in trace:
        counts = np.asarray([len(catalog.item_tokens[i]) + 1
                             for i in r.candidate_items])
        out.append(SimRequest(
            arrival_s=r.arrival_s,
            n_total=n_instr + len(r.history_tokens) + int(counts.sum()) + 1,
            n_instr=n_instr,
            item_ids=np.asarray(r.candidate_items),
            item_token_counts=counts,
            n_history=len(r.history_tokens),
            history_reuse_frac=history_reuse_frac))
    return out
