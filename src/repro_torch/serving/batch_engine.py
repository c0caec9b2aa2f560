"""Batched prefill / paged decode over the port's engine — the port of the
JAX package's `serving/batch_engine.py` (the store-free paths: the block
store and migration are not ported yet).

* **prefill** — ``mode="full"`` runs a padded full-recompute batch
  (flash-attention kernel); ``mode="rcllm"`` runs the beyond-prefix
  selective path batched (`core.engine.selective_prefill_batch`), its
  cached KV gathered on the device by the block-gather kernel.  The
  prompt's merged pre-RoPE KV lands in the paged pool from the device:
  every prompt token is either cached or recomputed (a token without
  cached KV is always recomputed), so the merged rows — cached rows with
  the recomputed tokens' fresh KV over them, and the fresh layer-0
  plane — cover the whole prompt and go in as one write.

* **chunk-resumable prefill** — `begin_prefill` admits a request,
  `step` packs decode tokens plus layer-0 chunks and selective finalizes
  under one token budget (the unified step), `finalize_prefill` runs the
  same bucketed selective dispatch as the wave path, `abort_prefill`
  rolls a mid-prefill request back.  Each chunk's layer-0 KV is written
  into the pool in place as the chunk completes.

* **decode** — one token per running request, K/V read through the
  paged-decode kernel over per-request page views
  (`kv_pool.page_views`): keys are rotated to their positions inside the
  kernel and nothing is gathered.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.core import engine as ENG
from repro_torch.core.assembly import AssemblyPlan
from repro_torch.core.cache_rows import CacheRows
from repro_torch.kernels.paged_attention.ops import paged_decode_mha
from repro_torch.models import layers as L
from repro_torch.models.transformer import Transformer
from repro_torch.serving.kv_pool import PagedKVPool, page_views, pool_for


@dataclass
class BatchRequest:
    """One prompt for the batched engine.  `plan` and its block table into
    the engine's cached-row pool (`block_table`, `positions`, `have`, see
    `assembly.plan_block_table`) are required for the selective (rcllm)
    path and ignored for full prefill.  `n_reserve` pre-reserves page
    capacity for that many decode tokens."""

    rid: int
    tokens: np.ndarray
    plan: Optional[AssemblyPlan] = None
    block_table: Optional[np.ndarray] = None
    positions: Optional[np.ndarray] = None
    have: Optional[np.ndarray] = None
    n_reserve: int = 0


@dataclass
class PrefillState:
    """One request's chunk-resumable prefill, engine-side: the request and
    its `engine.ChunkedPrefill` (store-free, so no position is mapped at
    shared slots and no insert is owed)."""

    req: BatchRequest
    cp: ENG.ChunkedPrefill


@dataclass
class StepReport:
    """What one unified `BatchEngine.step` tick executed and charged."""

    decode_logits: Optional[np.ndarray] = None
    finalized: Dict[int, np.ndarray] = field(default_factory=dict)
    chunked: List[int] = field(default_factory=list)
    charge_decode: int = 0
    charge_chunks: int = 0
    charge_finalize: int = 0
    oversized: bool = False

    @property
    def charged(self) -> int:
        return self.charge_decode + self.charge_chunks + self.charge_finalize


@torch.no_grad()
def decode_step(model: Transformer, toks: np.ndarray, seq_lens: np.ndarray,
                new_pages: np.ndarray, new_slots: np.ndarray,
                page_ids: np.ndarray, slot_pos: np.ndarray,
                pool: PagedKVPool) -> np.ndarray:
    """One decode token per request through the paged arena.

    toks: (N,) last sampled token ids; seq_lens: (N,) tokens resident
    before this step (= the new token's position); new_pages/new_slots:
    (N,) the slot claimed for the new token; page_ids/slot_pos: the page
    view (`kv_pool.page_views`) including that slot.  -> logits (N, V).

    Each layer writes its fresh pre-RoPE K/V into the arena **in place**
    before attention, so the kernel reads the new token through the same
    page view as every cached token.
    """
    cfg = model.cfg
    dev = model.device
    t = lambda a, dt=torch.int64: torch.from_numpy(np.asarray(a)).to(dev, dt)
    x = model.embed_tokens(t(toks))                               # (N, D)
    pos_new = t(seq_lens)
    pages, slots = t(new_pages), t(new_slots)
    pg_ids, sl_pos = t(page_ids, torch.int32), t(slot_pos, torch.int32)
    for layer, lp in enumerate(model.layers):
        h = L.rms_norm(x, lp.attn_norm, cfg.norm_eps)
        q = torch.einsum("nd,dhe->nhe", h, lp.wq)
        k_new = torch.einsum("nd,dhe->nhe", h, lp.wk)             # pre-RoPE
        v_new = torch.einsum("nd,dhe->nhe", h, lp.wv)
        lidx = torch.full_like(pages, layer)
        pool.arena_k.index_put_((pages, slots, lidx), k_new.to(pool.arena_k.dtype))
        pool.arena_v.index_put_((pages, slots, lidx), v_new.to(pool.arena_v.dtype))
        q = L.apply_rope(q[:, None], pos_new[:, None], cfg.rope_theta)[:, 0]
        o = paged_decode_mha(q, pool.arena_k, pool.arena_v, pg_ids, sl_pos,
                             layer=layer, rope_theta=cfg.rope_theta)
        x = ENG._layer_step(x, lp, cfg, o)
    xf = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return (xf @ model.head()).float().cpu().numpy()


class BatchEngine:
    """Multi-request prefill + paged continuous decode on one device.

    `cache` is the device pool of cached rows that rcllm requests' block
    tables index (`RcLLMSystem.rows`); full prefill needs none."""

    def __init__(self, model: Transformer, cfg: LMConfig,
                 pool: Optional[PagedKVPool] = None,
                 sel: Optional[ENG.SelectiveConfig] = None,
                 bucket: int = 64, cache: Optional[CacheRows] = None,
                 chunk_tokens: int = 128):
        self.model = model
        self.cfg = cfg
        self.pool = pool if pool is not None else pool_for(cfg, device=model.device)
        self.sel = sel or ENG.SelectiveConfig()
        self.bucket = bucket
        self.cache = cache
        self.chunk_tokens = chunk_tokens
        self.last_stats: Dict[int, ENG.EngineStats] = {}
        self.prefill_states: Dict[int, PrefillState] = {}

    # ------------------------------ prefill --------------------------------
    def prefill(self, reqs: Sequence[BatchRequest], mode: str = "full") -> np.ndarray:
        """Prefill a batch; KV lands in the pool.  -> logits (N, V)."""
        if mode == "full":
            return self._prefill_full(reqs)
        if mode == "rcllm":
            return self._prefill_selective_batch(reqs)
        raise ValueError(mode)

    def _prefill_full(self, reqs: Sequence[BatchRequest]) -> np.ndarray:
        lens = [len(r.tokens) for r in reqs]
        S = max(self.bucket, -(-max(lens) // self.bucket) * self.bucket)
        toks = np.zeros((len(reqs), S), np.int32)
        for i, r in enumerate(reqs):
            toks[i, : lens[i]] = r.tokens
        last = np.asarray([n - 1 for n in lens], np.int64)
        logits, k, v = ENG.batched_prefill(self.model, toks, last)
        for i, r in enumerate(reqs):
            self.pool.alloc(r.rid, lens[i] + r.n_reserve)
            self.pool.write_prompt(r.rid, k[i, : lens[i]], v[i, : lens[i]])
        return logits

    def _check_plan(self, r: BatchRequest) -> None:
        if r.plan is None or r.block_table is None:
            raise ValueError(f"request {r.rid}: rcllm prefill needs a plan and "
                             "its block table")
        if self.cache is None:
            raise ValueError("rcllm prefill needs the engine's cached-row pool "
                             "(BatchEngine(cache=...))")

    def _item(self, r: BatchRequest) -> tuple:
        return (r.plan, r.block_table, r.positions, r.have)

    def _prefill_selective_batch(self, reqs: Sequence[BatchRequest]) -> np.ndarray:
        """Batched rcllm prefill, then one arena scatter of the merged
        rows for the whole batch."""
        for r in reqs:
            self._check_plan(r)
        results = ENG.selective_prefill_batch(
            self.model, self.cfg, [self._item(r) for r in reqs], self.sel,
            self.cache, bucket=self.bucket)
        out, entries = [], []
        for r, (logits, stats, k_all, v_all) in zip(reqs, results):
            self.last_stats[r.rid] = stats
            n = r.plan.n
            self.pool.alloc(r.rid, n + r.n_reserve)
            entries.append((r.rid, np.arange(n), k_all, v_all))
            out.append(logits)
        self.pool.write_at_batch(entries)
        return np.stack(out)

    # ------------------------ chunk-resumable prefill ------------------------
    def begin_prefill(self, r: BatchRequest) -> None:
        """Admit one request into chunk-resumable prefill: claim its pool
        pages (prompt + reserved decode tokens) up front, so neither the
        incremental chunk writes nor the finalize can hit `PoolExhausted`
        mid-prefill."""
        self._check_plan(r)
        if r.rid in self.prefill_states:
            raise KeyError(f"request {r.rid} already prefilling")
        n = r.plan.n
        empty = np.zeros(0, np.int64)
        self.pool.alloc_mapped(r.rid, n + r.n_reserve, empty, empty)
        cp = ENG.ChunkedPrefill(
            self.model, self.cfg, r.plan, r.block_table, r.positions, r.have,
            self.cache, self.sel, chunk_tokens=self.chunk_tokens,
            bucket=self.bucket)
        self.prefill_states[r.rid] = PrefillState(req=r, cp=cp)

    def abort_prefill(self, rid: int) -> None:
        """Roll back a mid-prefill preemption: drop the chunk state and
        release the pages.  The caller keeps the plan, so the victim can
        re-prefill from scratch (greedy decode regenerates the same
        tokens)."""
        self.prefill_states.pop(rid, None)
        self.release(rid)

    def finalize_prefill(self, rids: Sequence[int]) -> Dict[int, np.ndarray]:
        """Selective layers + pool insertion for fully-scanned requests:
        one bucketed dispatch (`engine.selective_layers_batch`, as the
        wave path), then one fused deep-layer pool scatter for the whole
        batch; the layer-0 plane already landed as chunks completed."""
        states = [self.prefill_states[rid] for rid in rids]
        sel_out = ENG.selective_layers_batch(
            self.model, self.cfg, [st.cp.sel_item() for st in states], self.cache)
        out: Dict[int, np.ndarray] = {}
        entries_deep = []
        for st, (logits, k_rest, v_rest) in zip(states, sel_out):
            r, cp = st.req, st.cp
            self.last_stats[r.rid] = cp.stats
            entries_deep.append((r.rid, np.arange(cp.n), k_rest[:cp.n], v_rest[:cp.n]))
            out[r.rid] = logits
            del self.prefill_states[r.rid]
        self.pool.write_at_batch(entries_deep, deep=True)
        return out

    def step(self, budget: int, decode_rids: Sequence[int],
             decode_tokens: Sequence[int],
             prefill_rids: Sequence[int]) -> StepReport:
        """One unified serving tick under a global token budget.

        Decode runs first (one token per running request, and first so a
        `PoolExhausted` preemption can retry before any prefill work
        runs); the rest of the budget packs prefill work over
        `prefill_rids` in admission order: fully-scanned requests
        finalize (charged their padded recompute budget), the others get
        layer-0 chunks round-robin, one chunk per request per cycle, so a
        short prompt admitted behind a long one finishes scanning in
        proportion to its own length.  When nothing fits the remaining
        budget, the single head work item runs anyway (an `oversized`
        tick): an indivisible selective finalize can exceed any fixed
        budget and must not starve.
        """
        rep = StepReport()
        if decode_rids:
            rep.decode_logits = self.decode(decode_rids, decode_tokens)
            rep.charge_decode = len(decode_rids)
        left = budget - rep.charge_decode
        active = [rid for rid in prefill_rids if rid in self.prefill_states]
        packed = False
        finalize: List[int] = []
        l0_entries: List[tuple] = []

        def try_finalize(rid) -> None:
            nonlocal left, packed
            fc = self.prefill_states[rid].cp.finalize_charge()
            if fc <= left or (not packed and not decode_rids):
                if fc > left:
                    rep.oversized = True
                finalize.append(rid)
                rep.charge_finalize += fc
                left -= fc
                packed = True

        # pass 1 (admission order): fully-scanned requests finalize first
        for rid in active:
            if self.prefill_states[rid].cp.scan_done:
                try_finalize(rid)
        # pass 2: round-robin chunks; a request finishing its scan may
        # finalize in the same tick if the budget still allows
        progress = True
        while progress:
            progress = False
            for rid in active:
                st = self.prefill_states[rid]
                if st.cp.scan_done:
                    continue
                c = st.cp.next_chunk_tokens()
                if c > left and (packed or decode_rids):
                    continue
                if c > left:
                    rep.oversized = True
                positions, k0, v0 = st.cp.run_chunk()
                l0_entries.append((rid, positions, k0, v0))
                rep.charge_chunks += c
                left -= c
                packed = True
                progress = True
                if rid not in rep.chunked:
                    rep.chunked.append(rid)
                if st.cp.scan_done and rid not in finalize:
                    try_finalize(rid)
        self.pool.write_at_batch(l0_entries, layer=0)
        if finalize:
            rep.finalized = self.finalize_prefill(finalize)
        return rep

    # ------------------------------- decode --------------------------------
    def decode(self, rids: Sequence[int], last_tokens: Sequence[int]) -> np.ndarray:
        """One token for each running request.  -> logits (N, V).  Eager
        PyTorch needs no shape buckets, so the batch is not padded."""
        tables, lens = self.pool.batch_tables(rids)
        pages, slots = self.pool.append_slots(rids)
        pg_ids, sl_pos = page_views(tables, lens, pages, slots,
                                    self.pool.page_size)
        return decode_step(self.model, np.asarray(last_tokens, np.int64), lens,
                           pages, slots, pg_ids, sl_pos, self.pool)

    def release(self, rid: int) -> None:
        """Free a request's pages.  Idempotent."""
        self.pool.free(rid)
        self.last_stats.pop(rid, None)
