"""Batched prefill / paged decode over the port's engine — the port of the
JAX package's `serving/batch_engine.py` (wave path; the block store,
chunked prefill and migration are not ported yet).

* **prefill** — ``mode="full"`` runs a padded full-recompute batch
  (flash-attention kernel); ``mode="rcllm"`` runs the beyond-prefix
  selective path batched (`core.engine.selective_prefill_batch`).  The
  prompt's pre-RoPE KV lands in the paged pool: cached spans plus the
  recomputed tokens' fresh KV, then the always-fresh layer-0 plane.

* **decode** — one token per running request, K/V read through the
  paged-decode kernel over per-request page views
  (`kv_pool.page_views`): keys are rotated to their positions inside the
  kernel and nothing is gathered.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.core import engine as ENG
from repro_torch.core.assembly import RECOMPUTE, AssemblyPlan, plan_spans
from repro_torch.kernels.paged_attention.ops import paged_decode_mha
from repro_torch.models import layers as L
from repro_torch.models.transformer import Transformer
from repro_torch.serving.kv_pool import PagedKVPool, page_views, pool_for


@dataclass
class BatchRequest:
    """One prompt for the batched engine.  `plan` + cached KV arrays are
    required for the selective (rcllm) path and ignored for full prefill.
    `n_reserve` pre-reserves page capacity for that many decode tokens."""

    rid: int
    tokens: np.ndarray
    plan: Optional[AssemblyPlan] = None
    cached_k: Optional[np.ndarray] = None
    cached_v: Optional[np.ndarray] = None
    have: Optional[np.ndarray] = None
    n_reserve: int = 0


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
    """Multi-request prefill + paged continuous decode on one device."""

    def __init__(self, model: Transformer, cfg: LMConfig,
                 pool: Optional[PagedKVPool] = None,
                 sel: Optional[ENG.SelectiveConfig] = None,
                 bucket: int = 64):
        self.model = model
        self.cfg = cfg
        self.pool = pool if pool is not None else pool_for(cfg, device=model.device)
        self.sel = sel or ENG.SelectiveConfig()
        self.bucket = bucket
        self.last_stats: Dict[int, ENG.EngineStats] = {}

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

    @staticmethod
    def _selective_rows(r: BatchRequest, stats: ENG.EngineStats, k_all, v_all):
        """Final pool rows for one selectively-prefilled request: cached
        span values, with the recomputed tokens' fresh KV over them,
        merged host-side so the arena scatter sees unique positions.
        -> (positions, k rows, v rows)."""
        plan = r.plan
        write = np.zeros(plan.n, bool)
        for s in plan_spans(plan):
            if s.source != RECOMPUTE:
                write[s.start : s.end] = True
        kw = np.array(r.cached_k, np.float32)
        vw = np.array(r.cached_v, np.float32)
        rec = stats.recompute_mask
        kw[rec] = k_all[rec]
        vw[rec] = v_all[rec]
        write |= rec
        pos = np.where(write)[0]
        return pos, kw[pos], vw[pos]

    def _prefill_selective_batch(self, reqs: Sequence[BatchRequest]) -> np.ndarray:
        """Batched rcllm prefill, then one arena scatter for the whole
        batch plus one for the layer-0 planes."""
        for r in reqs:
            if r.plan is None:
                raise ValueError(f"request {r.rid}: rcllm prefill needs a plan")
        results = ENG.selective_prefill_batch(
            self.model, self.cfg,
            [(r.plan, r.cached_k, r.cached_v, r.have) for r in reqs],
            self.sel, bucket=self.bucket)
        out = []
        entries, entries_l0 = [], []
        for r, (logits, stats, k_all, v_all) in zip(reqs, results):
            self.last_stats[r.rid] = stats
            n = r.plan.n
            self.pool.alloc(r.rid, n + r.n_reserve)
            pos, kw, vw = self._selective_rows(r, stats, k_all, v_all)
            entries.append((r.rid, pos, kw, vw))
            entries_l0.append((r.rid, np.arange(n), k_all[:, 0], v_all[:, 0]))
            out.append(logits)
        self.pool.write_at_batch(entries)
        self.pool.write_at_batch(entries_l0, layer=0)
        return np.stack(out)

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
