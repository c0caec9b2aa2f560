"""Zero-copy KV assembly (§III-C2a + §III-C3).

A request's logical prompt is mapped onto scattered physical KV blocks:
instruction tokens are always recomputed; review tokens resolve to semantic
prototypes; item tokens resolve to item blocks (local / remote / miss).
Nothing is physically concatenated here — the plan is an index table
(logical position → block ref + offset + RoPE delta).  A numpy copy of the
JAX package's `core/assembly.py`, plus `plan_block_table`: the plan as a
block table into the device pool of cached rows (`core.cache_rows`), which
the block-gather kernel assembles and realigns on the device.
`gather_cached_kv` stays as the plain host assembly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.cache_rows import ZERO_ROW
from repro_torch.core.item_cache import ItemKVStore
from repro_torch.core.semantic_cache import (SemanticCache,
                                       embed_tokens_for_match)

# token sources
RECOMPUTE, FROM_ITEM, FROM_SEMANTIC = 0, 1, 2


@dataclass
class AssemblyPlan:
    tokens: np.ndarray                 # (n,) prompt token ids
    seg_kind: np.ndarray               # 0 instr / 1 history / 2 item
    source: np.ndarray                 # RECOMPUTE / FROM_ITEM / FROM_SEMANTIC
    block_item: np.ndarray             # item id for FROM_ITEM tokens, -1 else
    block_offset: np.ndarray           # offset inside the item block
    proto_id: np.ndarray               # prototype id for FROM_SEMANTIC, -1
    rope_delta: np.ndarray             # target_pos − cached_pos (realignment)
    n_local: int = 0
    n_remote: int = 0
    n_miss: int = 0

    @property
    def n(self) -> int:
        return len(self.tokens)

    def reuse_fraction(self) -> float:
        """The share of the prompt's tokens served from a cache (item
        blocks or semantic prototypes) rather than recomputed."""
        return float((self.source != RECOMPUTE).mean())


def build_plan(tokens: np.ndarray, seg_kind: np.ndarray, seg_id: np.ndarray,
               marker_mask: Optional[np.ndarray],
               item_store: Optional[ItemKVStore],
               semantic: Optional[SemanticCache],
               token_embed: Optional[np.ndarray],
               instance: int = 0,
               min_semantic_sim: float = 0.85) -> AssemblyPlan:
    """Decompose one prompt into its reuse plan (§III-C2a i–iii)."""
    n = len(tokens)
    source = np.zeros(n, np.int32)
    block_item = np.full(n, -1, np.int32)
    block_offset = np.zeros(n, np.int32)
    proto_id = np.full(n, -1, np.int32)
    rope_delta = np.zeros(n, np.int32)
    n_local = n_remote = n_miss = 0

    # --- candidate item tokens: exact blocks by item id ---
    if item_store is not None:
        item_positions: Dict[int, List[int]] = {}
        for i in np.where(seg_kind == 2)[0]:
            item_positions.setdefault(int(seg_id[i]), []).append(int(i))
        items = list(item_positions)
        local, remote, miss = item_store.lookup(items, instance)
        status = {it: "local" for it in local}
        status.update({it: "remote" for it in remote})
        status.update({it: "miss" for it in miss})
        for it, positions in item_positions.items():
            st = status[it]
            blk = item_store.get_block(it, instance)
            if st == "miss" or blk is None:
                n_miss += len(positions)
                continue                     # stays RECOMPUTE
            if st == "local":
                n_local += len(positions)
            else:
                n_remote += len(positions)
            for off, pos in enumerate(positions):
                if off >= len(blk.tokens):
                    continue
                source[pos] = FROM_ITEM
                block_item[pos] = it
                block_offset[pos] = off
                rope_delta[pos] = pos - off   # block cached at canonical 0

    # --- history/review tokens: nearest semantic prototype ---
    if semantic is not None and token_embed is not None:
        hist = np.where(seg_kind == 1)[0]
        if len(hist) > 0:
            # instance-specific fields (timestamps, separators) never reuse
            reusable = np.ones(len(hist), bool)
            if marker_mask is not None:
                reusable &= ~marker_mask[:len(hist)]
            # match at history-RELATIVE positions: the cache's
            # (pos_bucket, code) keys were built from review docs at
            # doc-relative positions, while the history sits behind the
            # instruction in the prompt — hashing with absolute prompt
            # positions lands every token in a position bucket the cache
            # never populated, silently disabling semantic reuse.  RoPE
            # realignment below still uses absolute positions.
            pos = (hist - hist[0]).astype(np.int64)
            emb = embed_tokens_for_match(tokens[hist], pos, token_embed)
            pid, sim = semantic.match(tokens[hist], pos, emb)
            ok = reusable & (pid >= 0) & (sim >= min_semantic_sim) \
                & (semantic.proto_k is not None)
            for j in np.where(ok)[0]:
                i = hist[j]
                source[i] = FROM_SEMANTIC
                proto_id[i] = pid[j]
                rope_delta[i] = i - semantic.proto_position[pid[j]]

    return AssemblyPlan(tokens=tokens, seg_kind=seg_kind, source=source,
                        block_item=block_item, block_offset=block_offset,
                        proto_id=proto_id, rope_delta=rope_delta,
                        n_local=n_local, n_remote=n_remote, n_miss=n_miss)


@dataclass(frozen=True)
class PlanSpan:
    """A maximal contiguous run of one physical KV block inside a plan."""
    start: int                         # logical token range [start, end)
    end: int
    source: int                        # RECOMPUTE / FROM_ITEM / FROM_SEMANTIC
    block_id: int                      # item id / prototype id / -1

    @property
    def n(self) -> int:
        return self.end - self.start


def plan_spans(plan: AssemblyPlan) -> List[PlanSpan]:
    """Decompose a plan into contiguous block spans.

    The paged serving pool consumes these for block-granular insertion:
    each FROM_ITEM / FROM_SEMANTIC span is one slice-copy out of a cached
    block, and RECOMPUTE spans are filled later by the selective engine.
    Spans partition [0, plan.n) exactly.
    """
    spans: List[PlanSpan] = []
    n = plan.n
    i = 0
    while i < n:
        src = int(plan.source[i])
        if src == FROM_ITEM:
            bid = int(plan.block_item[i])
        elif src == FROM_SEMANTIC:
            bid = int(plan.proto_id[i])
        else:
            bid = -1
        j = i + 1
        while j < n and int(plan.source[j]) == src:
            if src == FROM_ITEM and (int(plan.block_item[j]) != bid or
                                     int(plan.block_offset[j]) !=
                                     int(plan.block_offset[j - 1]) + 1):
                break
            if src == FROM_SEMANTIC and int(plan.proto_id[j]) != bid:
                break
            j += 1
        spans.append(PlanSpan(start=i, end=j, source=src, block_id=bid))
        i = j
    return spans


def gather_cached_kv(plan: AssemblyPlan, item_store: Optional[ItemKVStore],
                     semantic: Optional[SemanticCache], instance: int,
                     n_layers: int, n_kv: int, head_dim: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Materialize the assembled (pre-RoPE) cached KV for every reuse token.

    -> (k, v): (n, L, Hkv, Dh) float arrays (zeros where RECOMPUTE),
       have_cache: (n,) bool.  The plain host version of the device
       assembly (`plan_block_table` + the block-gather kernel).
    """
    n = plan.n
    k = np.zeros((n, n_layers, n_kv, head_dim), np.float32)
    v = np.zeros((n, n_layers, n_kv, head_dim), np.float32)
    have = np.zeros(n, bool)
    for i in range(n):
        if plan.source[i] == FROM_ITEM and item_store is not None:
            blk = item_store.get_block(int(plan.block_item[i]), instance)
            off = int(plan.block_offset[i])
            if blk is not None and off < blk.k.shape[0]:
                k[i] = blk.k[off]
                v[i] = blk.v[off]
                have[i] = True
        elif plan.source[i] == FROM_SEMANTIC and semantic is not None \
                and semantic.proto_k is not None:
            pid = int(plan.proto_id[i])
            k[i] = semantic.proto_k[pid]
            v[i] = semantic.proto_v[pid]
            have[i] = True
    return k, v, have


def plan_block_table(plan: AssemblyPlan, item_store: Optional[ItemKVStore],
                     semantic: Optional[SemanticCache], instance: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The plan as a block table into the device pool of cached rows.

    -> (block_table (n,) int32: the pool row of each prompt token, the
    zero row where `gather_cached_kv` gives zeros; positions (n,) int32:
    each token's target RoPE position, its prompt position; have (n,)
    bool, equal to `gather_cached_kv`'s).  Gathering the pool rows by the
    table reproduces `gather_cached_kv` bit for bit.
    """
    n = plan.n
    table = np.full(n, ZERO_ROW, np.int32)
    have = np.zeros(n, bool)
    for i in range(n):
        if plan.source[i] == FROM_ITEM and item_store is not None:
            blk = item_store.get_block(int(plan.block_item[i]), instance)
            off = int(plan.block_offset[i])
            if blk is not None and off < blk.k.shape[0]:
                if blk.row < 0:
                    raise ValueError(f"item {blk.item_id}: block not in the device pool")
                table[i] = blk.row + off
                have[i] = True
        elif plan.source[i] == FROM_SEMANTIC and semantic is not None \
                and semantic.proto_k is not None:
            if semantic.proto_row < 0:
                raise ValueError("semantic prototypes not in the device pool")
            table[i] = semantic.proto_row + int(plan.proto_id[i])
            have[i] = True
    return table, np.arange(n, dtype=np.int32), have
