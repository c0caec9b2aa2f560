"""Candidate-item KV pool (§III-B, second pool).

Per-item KV blocks are precomputed offline at canonical position 0 (keys
stored pre-RoPE so assembly can rotate them to any request position — the
group property of RoPE makes this exact, §III-C3 'Alignment') and sharded
across instances by the Algorithm-1 placement.  At terabyte catalog scale
only the per-instance shard (plus hot replicas) is resident — Fig. 9b's
per-replica footprint.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cache_rows import CacheRows
from repro_torch.core.placement import Placement


@dataclass
class ItemBlock:
    item_id: int
    tokens: np.ndarray                     # block token ids (SEP + item text)
    k: np.ndarray                          # (S, L, Hkv, Dh) pre-RoPE
    v: np.ndarray                          # (S, L, Hkv, Dh)
    row: int = -1                          # first row in the device pool

    def nbytes(self) -> int:
        return self.k.nbytes + self.v.nbytes


@dataclass
class ItemCacheShard:
    """The blocks resident on one instance (its partition + hot replicas)."""
    instance: int
    blocks: Dict[int, ItemBlock]

    def nbytes(self) -> int:
        return sum(b.nbytes() for b in self.blocks.values())

    def n_tokens(self) -> int:
        return sum(len(b.tokens) for b in self.blocks.values())


@dataclass
class ItemKVStore:
    placement: Placement
    shards: List[ItemCacheShard]
    token_count: np.ndarray                # per-item block length

    def lookup(self, items: Sequence[int], instance: int
               ) -> Tuple[List[int], List[int], List[int]]:
        """-> (local hits, remote hits, misses) by item id."""
        local, remote, miss = [], [], []
        shard = self.shards[instance]
        for it in items:
            it = int(it)
            if it in shard.blocks:
                local.append(it)
            else:
                holders = [h for h in self.placement.holders(it)
                           if it in self.shards[h].blocks]
                (remote if holders else miss).append(it)
        return local, remote, miss

    def get_block(self, item: int, instance: int) -> Optional[ItemBlock]:
        b = self.shards[instance].blocks.get(int(item))
        if b is not None:
            return b
        for h in self.placement.holders(int(item)):
            b = self.shards[h].blocks.get(int(item))
            if b is not None:
                return b
        return None


def build_item_store(
    item_tokens: List[np.ndarray],
    placement: Placement,
    kv_of_sequence: Optional[Callable] = None,
    kv_list: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None,
    coverage: float = 1.0,
    seed: int = 0,
    rows: Optional[CacheRows] = None,
) -> ItemKVStore:
    """Precompute KV blocks for (a subset of) the catalog and lay them out
    by the placement.  `coverage < 1` models a partially-warmed cache.
    With `rows`, every cached block (one object, whichever instances
    hold it) also registers its rows for the device pool."""
    rng = np.random.default_rng(seed)
    n = len(item_tokens)
    cached = np.ones(n, bool) if coverage >= 1.0 else \
        rng.random(n) < coverage
    shards = [ItemCacheShard(instance=i, blocks={})
              for i in range(placement.k)]
    token_count = np.zeros(n, np.int32)
    for it in range(n):
        token_count[it] = len(item_tokens[it])
        if not cached[it]:
            continue
        k, v = kv_list[it] if kv_list is not None \
            else kv_of_sequence(item_tokens[it])
        blk = ItemBlock(item_id=it, tokens=item_tokens[it], k=k, v=v)
        if rows is not None:
            blk.row = rows.add(k, v)
        for holder in placement.holders(it):
            shards[holder].blocks[it] = blk
    return ItemKVStore(placement=placement, shards=shards,
                       token_count=token_count)
