"""Serving workload construction: a synthetic request trace becomes
batcher requests plus the per-request assembly artifacts the rcllm
prefill path needs, its plan and block table (the port of the JAX
package's `serving/workload.py` single-instance producers)."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from repro_torch.serving.batching import PendingRequest


def rcllm_workload(
    system, trace: Sequence, decode_steps: int = 4
) -> Tuple[List[PendingRequest], Dict[int, tuple]]:
    """Route each traced request, build its assembly plan and its block
    table into the system's device pool of cached rows.  -> (pending
    requests for `ContinuousBatcher`, {rid: (plan, block_table,
    positions, have)} for `TorchEngineBackend`)."""
    plans: Dict[int, tuple] = {}
    pend: List[PendingRequest] = []
    for rid, rq in enumerate(trace):
        inst = system.best_instance(rq)
        plan = system.plan_for(rq, inst)
        plans[rid] = (plan, *system.cached_kv(plan, inst))
        pend.append(PendingRequest(arrival_s=float(rq.arrival_s), rid=rid,
                                   n_tokens=plan.n, decode_steps=decode_steps,
                                   tokens=plan.tokens))
    return pend, plans

