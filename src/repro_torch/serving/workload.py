"""Serving workload construction: a synthetic request trace becomes
batcher requests plus the per-request assembly artifacts the rcllm
prefill path needs, its plan and block table, and the cross-request
reuse metadata of the shared block store (the port of the JAX package's
`serving/workload.py` single-instance producers).

`build_request_reuse` is the one place that derives content keys and
block refs from a plan.  An item block ref names the block's first row
in the system's device pool of cached rows, so a store miss inserts the
block by a copy on the device."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.assembly import FROM_ITEM, AssemblyPlan
from repro_torch.serving.batch_engine import BatchRequest
from repro_torch.serving.batching import PendingRequest
from repro_torch.serving.block_store import BlockRef, RequestReuse, content_key


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


def rcllm_batch_requests(system, trace: Sequence, n_reserve: int = 0) -> List[BatchRequest]:
    """Direct `BatchEngine.prefill(mode="rcllm")` inputs for a trace, the
    no-batcher variant: each request's plan and its block table into the
    system's device pool of cached rows, `n_reserve` decode slots
    reserved, in request order."""
    _, plans = rcllm_workload(system, trace)
    return [BatchRequest(rid=rid, tokens=plan.tokens, plan=plan, block_table=table,
                         positions=positions, have=have, n_reserve=n_reserve)
            for rid, (plan, table, positions, have) in sorted(plans.items())]


# ------------------------- cross-request reuse -------------------------
def item_block_key(tokens: np.ndarray) -> tuple:
    """Content address of one item block: its token ids determine its
    offline KV bytes."""
    return content_key("item", np.asarray(tokens, np.int64))


def user_prefix_key(instruction: np.ndarray, request) -> tuple:
    """Content address of one user's prompt prefix (instruction + history
    + instance-specific markers): the pinned user tier's key."""
    return content_key(
        "user",
        np.asarray(instruction, np.int64),
        np.asarray(request.history_tokens, np.int64),
        np.asarray(request.history_marker_mask, np.int64),
    )


def build_request_reuse(
    plan: AssemblyPlan,
    have: np.ndarray,
    staged: Dict[int, object],
    user_key: Optional[tuple],
    prefix_end: int,
    item_keys: Optional[Dict[int, tuple]] = None,
    instr_len: int = 0,
) -> RequestReuse:
    """One request's shareable-block metadata from its plan.

    `staged` maps item id -> block (anything with `.tokens` and `.row`, an
    `item_cache.ItemBlock`); items absent from it produce no ref.
    `item_keys` short-circuits per-item digests the caller already
    computed.  `instr_len` > 0 enables the prefix tier over the leading
    instruction tokens.
    """
    refs: List[BlockRef] = []
    item_mask = (plan.source == FROM_ITEM) & have
    for it in np.unique(plan.block_item[item_mask]):
        it = int(it)
        blk = staged.get(it)
        if blk is None:
            continue
        positions = np.where(item_mask & (plan.block_item == it))[0]
        key = (item_keys[it] if item_keys is not None and it in item_keys
               else item_block_key(blk.tokens))
        refs.append(BlockRef(key=key, positions=positions,
                             offsets=plan.block_offset[positions].astype(np.int64),
                             row=int(blk.row), tokens=blk.tokens))
    prefix_key = None
    if instr_len > 0:
        prefix_key = content_key("prefix", np.asarray(plan.tokens[:instr_len], np.int64))
    return RequestReuse(user_key=user_key, prefix_end=prefix_end, blocks=refs,
                        prefix_key=prefix_key, prefix_len=instr_len)


def rcllm_reuse_info(system, trace: Sequence, plans: Dict[int, tuple]
                     ) -> Dict[int, RequestReuse]:
    """Reuse metadata for every request of a single-instance workload:
    item refs point at the system's item-store blocks (rows of its device
    pool), the user key covers instruction + history."""
    out: Dict[int, RequestReuse] = {}
    n_instr = len(system.instruction)
    key_of: Dict[int, tuple] = {}
    for rid, rq in enumerate(trace):
        plan, _, _, have = plans[rid]
        staged = {}
        item_mask = (plan.source == FROM_ITEM) & have
        for it in np.unique(plan.block_item[item_mask]):
            blk = system.item_store.get_block(int(it), 0)
            if blk is not None:
                staged[int(it)] = blk
                if int(it) not in key_of:
                    key_of[int(it)] = item_block_key(blk.tokens)
        out[rid] = build_request_reuse(
            plan, have, staged, user_prefix_key(system.instruction, rq),
            n_instr + len(rq.history_tokens), item_keys=key_of, instr_len=n_instr)
    return out


def heavy_tail_trace(catalog, pool, profile, n_requests: int, qps: float,
                     n_users: int, long_prompt_frac: float = 0.15,
                     long_prompt_reviews: int = 8, n_candidates: int = 8,
                     reviews_per_user: int = 1, seed: int = 2) -> List:
    """Heavy-tail prompt lengths: a `long_prompt_frac` fraction of users
    carries a lognormal pile of extra reviews, so their prompts are
    several times the base length (the head-of-line shape where the
    chunked scheduler and disaggregation pay)."""
    from repro_torch.data import synth as SY

    return SY.make_trace(catalog, pool, profile, n_requests, qps=qps, n_users=n_users,
                         n_candidates=n_candidates, reviews_per_user=reviews_per_user,
                         seed=seed, long_prompt_frac=long_prompt_frac,
                         long_prompt_reviews=long_prompt_reviews)


def zipf_repeat_trace(catalog, pool, profile, n_requests: int, qps: float,
                      n_users: int, zipf_a: float = 1.2, n_candidates: int = 8,
                      reviews_per_user: int = 2, seed: int = 2) -> List:
    """Repeat-user workload: user ids drawn Zipf(a), so a handful of heavy
    users dominate the stream (plus the catalog's own Zipf popularity on
    candidates) — the shape where the store's pinned user tier and LRU
    item tier both earn their keep."""
    from repro_torch.data import synth as SY

    return SY.make_trace(catalog, pool, profile, n_requests, qps=qps, n_users=n_users,
                         n_candidates=n_candidates, reviews_per_user=reviews_per_user,
                         seed=seed, user_zipf_a=zipf_a)
