"""Candidate-item KV pool (§III-B, second pool).

Per-item KV blocks are precomputed offline at canonical position 0 (keys
stored pre-RoPE so assembly can rotate them to any request position — the
group property of RoPE makes this exact, §III-C3 'Alignment') and sharded
across instances by the Algorithm-1 placement.  At terabyte catalog scale
only the per-instance shard (plus hot replicas) is resident — Fig. 9b's
per-replica footprint.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.cache_rows import CacheRows
from repro_torch.core.placement import Placement
from repro_torch.sharding import ctx as CTX


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

    def footprint_tokens_per_replica(self) -> float:
        return float(np.mean([s.n_tokens() for s in self.shards]))

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


def measured_copy_s(tensors: Sequence[torch.Tensor], device) -> float:
    """Seconds a device copy of `tensors` onto `device` takes, measured:
    CUDA events around the copies on the current stream where either side
    is a CUDA device, the host clock around them on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" or any(t.is_cuda for t in tensors):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for t in tensors:
            t.to(device, copy=True)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for t in tensors:
        t.to(device, copy=True)
    return time.perf_counter() - t0


@dataclass(frozen=True)
class TransferRecord:
    """One explicit cross-shard block movement, the unit the cluster's
    transfer step is billed in.  ``measured_s`` is the measured time of
    the device copy when the client runs with per-instance home devices
    (`ShardClient(devices=)`), 0.0 on the ledger-only path (the cluster
    then bills the modelled `cost_model.fetch_time_s`)."""
    item_id: int
    src_instance: int
    n_tokens: int
    n_bytes: int
    measured_s: float = 0.0


class ShardClient:
    """Runtime-facing handle on one instance's resident item shard.

    `ItemKVStore.get_block` falls back to peer shards silently; a
    ShardClient makes residency explicit: `resident()` answers from this
    shard only, and every non-resident access goes through `pull()`,
    which finds the block on its holder and records a `TransferRecord`.
    Blocks no shard holds stay misses (the engine recomputes them).

    ``devices`` (a home device per instance, indexed by instance id
    modulo its length) makes the ledger physical: a pull stages the
    block's bytes on its holder's device (once per item, cached) and then
    copies them onto this instance's device, recording the measured
    seconds (`measured_copy_s`; rank 0's on every rank of a mesh,
    `sharding.ctx.decide`) in the `TransferRecord` and in the pending sum
    the cluster bills (`take_measured_s`).  The bytes are unchanged, so
    routing never changes what a request decodes.
    """

    def __init__(self, store: ItemKVStore, instance: int, devices=None):
        self.store = store
        self.instance = instance
        self.devices = list(devices) if devices else None
        self.transfers: List[TransferRecord] = []
        self.n_local_blocks = 0
        self.n_miss_blocks = 0
        # item -> (k, v) staged on its holder's device
        self._dev_blocks: Dict[int, tuple] = {}
        self._measured_pending = 0.0

    @property
    def measures(self) -> bool:
        """Does this client measure real device copies?"""
        return self.devices is not None

    def home_device(self, instance: int):
        return self.devices[instance % len(self.devices)]

    def _measured_copy(self, blk: ItemBlock, src_instance: int) -> float:
        staged = self._dev_blocks.get(blk.item_id)
        if staged is None:
            src = self.home_device(src_instance)
            staged = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(src)
                           for a in (blk.k, blk.v))
            self._dev_blocks[blk.item_id] = staged
        return measured_copy_s(staged, self.home_device(self.instance))

    def take_measured_s(self) -> float:
        """Measured seconds since the last take (the cluster drains this
        right after each `stage`, to bill the dispatch)."""
        s, self._measured_pending = self._measured_pending, 0.0
        return s

    def measured_seconds(self) -> float:
        """Every pull's measured seconds."""
        return sum(t.measured_s for t in self.transfers)

    def resident(self, item: int) -> bool:
        return int(item) in self.store.shards[self.instance].blocks

    def local_block(self, item: int) -> Optional[ItemBlock]:
        return self.store.shards[self.instance].blocks.get(int(item))

    def pull(self, item: int) -> Optional[ItemBlock]:
        """Cross-shard fetch of a non-resident block (recorded)."""
        it = int(item)
        for h in self.store.placement.holders(it):
            if h == self.instance:
                continue
            blk = self.store.shards[h].blocks.get(it)
            if blk is not None:
                measured = 0.0
                if self.devices is not None:
                    # rank 0's measurement on every rank of a mesh
                    measured = CTX.decide(self._measured_copy(blk, h))
                    self._measured_pending += measured
                self.transfers.append(TransferRecord(
                    item_id=it, src_instance=h, n_tokens=len(blk.tokens),
                    n_bytes=blk.nbytes(), measured_s=measured))
                return blk
        return None

    def stage(self, items: Sequence[int]) -> Tuple[Dict[int, ItemBlock], int]:
        """Resolve one request's unique item set against this shard:
        resident blocks come straight from it, the others through `pull()`.
        -> ({item: block}, tokens moved over the network)."""
        staged: Dict[int, ItemBlock] = {}
        moved_tokens = 0
        for it in items:
            it = int(it)
            if it in staged:
                continue
            blk = self.local_block(it)
            if blk is not None:
                self.n_local_blocks += 1
            else:
                blk = self.pull(it)
                if blk is None:
                    self.n_miss_blocks += 1
                    continue
                moved_tokens += len(blk.tokens)
            staged[it] = blk
        return staged, moved_tokens

    def transferred_bytes(self) -> int:
        return sum(t.n_bytes for t in self.transfers)

    def transferred_tokens(self) -> int:
        return sum(t.n_tokens for t in self.transfers)


class StagedBlocks:
    """A request's staged item blocks behind the `get_block` interface
    `assembly.plan_block_table` reads: only what `ShardClient.stage`
    resolved is visible, so nothing is reached silently."""

    def __init__(self, blocks: Dict[int, ItemBlock]):
        self.blocks = blocks

    def get_block(self, item: int, instance: int = 0) -> Optional[ItemBlock]:
        return self.blocks.get(int(item))


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
