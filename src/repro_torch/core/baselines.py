"""Algorithmic baselines of the accuracy comparison (Table III),
CacheBlend [EuroSys'25] and EPIC [ICML'25] — the port of the JAX
package's `core/baselines.py`.

Both reuse the same assembled cache blocks as RcLLM but differ in how they
correct (or fail to correct) the approximation:

* CacheBlend: recompute the tokens ranked purely by KV deviation (Eq. 3
  with λ=1, one global budget), chunks treated as unstructured context —
  no heavy-hitter structure protection, and cached keys kept at the
  blocks' ORIGINAL positions (no RoPE realignment of the stitched layout).
  On the port those positions are the block-gather kernel's target
  positions: ``arange(n) - plan.rope_delta``.
* EPIC: position-independent blocks with a STATIC recompute pattern, the
  first `k_link` tokens of every block (AttnLink): no per-request
  adaptivity, no divergence correction.

Both run the port's layer 0 (`engine.plan_layer0`) and its single-request
selective layers (`engine.run_selective_layers`); the recompute sets are
numpy, as in the reference.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.configs.base import LMConfig
from repro_torch.core import engine as ENG
from repro_torch.core.assembly import FROM_ITEM, FROM_SEMANTIC, RECOMPUTE, AssemblyPlan
from repro_torch.core.cache_rows import CacheRows
from repro_torch.core.engine import EngineStats
from repro_torch.models.transformer import Transformer


def _layer0(model: Transformer, cfg: LMConfig, plan: AssemblyPlan, table: np.ndarray,
            cache: CacheRows):
    """-> (x after layer 0 (n_pad, D) on the device, layer-0 KV deviation
    (n,) host fp32)."""
    x, _, div, _, _ = ENG.plan_layer0(model, cfg, plan, table,
                                      np.arange(plan.n, dtype=np.int32), cache)
    return x, ENG._host(div)[:plan.n]


def _stats(plan: AssemblyPlan, recompute: np.ndarray) -> EngineStats:
    return EngineStats(
        n_tokens=plan.n, n_recomputed=int(recompute.sum()),
        n_reused_item=int(((plan.source == FROM_ITEM) & ~recompute).sum()),
        n_reused_semantic=int(((plan.source == FROM_SEMANTIC) & ~recompute).sum()),
        n_heavy_hitters=0, layer0_full=True, recompute_mask=recompute.copy())


def cacheblend_recompute(plan: AssemblyPlan, have: np.ndarray, dev: np.ndarray,
                         r: float) -> np.ndarray:
    """CacheBlend's recompute set: misses and the instruction, then the
    ceil(r * n) cached tokens of largest deviation `dev` (n,) (0 where
    nothing is cached), by numpy's default (unstable) argsort as in the
    reference.  -> (n,) bool."""
    recompute = ~have.copy()
    recompute |= plan.seg_kind == 0        # the true prefix is a real prefix hit
    cand = np.where(~recompute)[0]
    k_top = int(np.ceil(r * plan.n))
    top = cand[np.argsort(-dev[cand])[:min(k_top, len(cand))]]
    recompute[top] = True
    return recompute


def epic_recompute(plan: AssemblyPlan, have: np.ndarray, k_link: int = 2) -> np.ndarray:
    """EPIC's static recompute set: misses, the instruction, and the first
    `k_link` tokens of every reused block (AttnLink).  -> (n,) bool."""
    n = plan.n
    recompute = ~have.copy()
    recompute |= plan.seg_kind == 0
    starts = np.zeros(n, bool)
    prev_src, prev_item = RECOMPUTE, -2
    for i in range(n):
        if plan.source[i] == FROM_ITEM:
            if plan.block_item[i] != prev_item:
                starts[i] = True
        elif plan.source[i] == FROM_SEMANTIC and prev_src != FROM_SEMANTIC:
            starts[i] = True
        prev_src = plan.source[i]
        prev_item = plan.block_item[i] if plan.source[i] == FROM_ITEM else -2
    for i in np.where(starts)[0]:
        recompute[i:i + k_link] = True
    return recompute


def cacheblend_prefill_logits(model: Transformer, cfg: LMConfig, plan: AssemblyPlan,
                              table: np.ndarray, have: np.ndarray, cache: CacheRows,
                              r: float = 0.15) -> Tuple[np.ndarray, EngineStats]:
    """CacheBlend: one global budget, deviation-only selection, cached keys
    kept at the blocks' original positions (item blocks at their
    offset-0-based positions, prototypes at their canonical position).
    table/have: the plan's `assembly.plan_block_table`.  -> (logits (V,)
    host, EngineStats)."""
    x, dev = _layer0(model, cfg, plan, table, cache)
    recompute = cacheblend_recompute(plan, have, dev * have.astype(np.float32), r)
    n = plan.n
    original = np.where(plan.source == RECOMPUTE, np.arange(n),
                        np.arange(n) - plan.rope_delta).astype(np.int32)
    logits = ENG.run_selective_layers(model, cfg, plan, x, recompute, cache, table,
                                      original)
    return logits, _stats(plan, recompute)


def epic_prefill_logits(model: Transformer, cfg: LMConfig, plan: AssemblyPlan,
                        table: np.ndarray, have: np.ndarray, cache: CacheRows,
                        k_link: int = 2) -> Tuple[np.ndarray, EngineStats]:
    """EPIC: position-independent reuse (keys realigned to the request
    positions, its contribution), a static AttnLink recompute of the first
    `k_link` tokens of every reused block, no adaptive correction."""
    x, _ = _layer0(model, cfg, plan, table, cache)
    recompute = epic_recompute(plan, have, k_link)
    logits = ENG.run_selective_layers(model, cfg, plan, x, recompute, cache, table,
                                      np.arange(plan.n, dtype=np.int32))
    return logits, _stats(plan, recompute)
