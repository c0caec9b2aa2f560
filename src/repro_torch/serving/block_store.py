"""Cross-request beyond-prefix KV reuse: a shared block store over the
paged pool — the port of the JAX package's `serving/block_store.py`.

The serving-path realization of the paper's **stratified storage**
(§III-B): KV blocks are content-addressed (blake2b over the bytes that
determine them), held in pool pages owned by the store, and shared
across concurrent requests through refcounts.  Three tiers:

* **user tier** — one pinned block per (instruction + user history)
  prefix: the always-fresh layer-0 plane (a pure function of the token
  ids, `core.engine.layer0_kv`) plus the semantic-prototype deep layers
  at the user's semantic-reuse positions.
* **item tier** — one block per item description, holding the offline
  block bytes for every layer.  Unpinned: LRU-evicted when unreferenced
  and the pool is under pressure.
* **prefix tier** — the instruction's recomputed rows, keyed by content
  digest plus the (n_pad, r_pad) bucket they came out of; a hit feeds
  them back to the selective layers as cached KV, so the instruction
  drops out of the recompute set.

Every stored byte equals what the no-reuse path would have written for
the same position, so mapping a request's slot-table entries at shared
slots changes *where* decode reads, never *what*.

Optional tiers: int8 payloads (``kv_store_dtype="int8"``, symmetric
per-(row, kv-head) scales, `quantize_rows`; the arena holds the
dequantized bytes) and a capacity-bounded host-RAM spill tier for
evicted blocks (``spill_mb``), from which a returning key is promoted
back to the device, either when a request inserts it or ahead of its
admission through the cluster router's hints (`hint` / `prefetch`,
``prefetch_pages_per_tick`` pages a tick).  KV migration moves blocks
between workers' stores by content key (`export_payload` /
`import_payload`): a destination already holding the key moves no bytes.

Where the card changes the reference's design:

* **payloads are tensors** of the reference's shapes and dtypes.  A
  resident fp32 block keeps none: its bytes are its arena slots, read
  back when it is spilled.  A resident int8 block keeps its int8 payload
  and scales on the pool's device.  A spilled block's payload is on the
  host (`SpilledBlock`) until promotion.  `quantize_rows` runs in torch
  and equals the reference's numpy bitwise (IEEE division, round half
  to even).
* **item-tier misses never cross PCIe**: a `BlockRef` names the block's
  first row in the device pool of cached rows (`core.cache_rows`), and
  the insert is a copy on the device from those rows into store-owned
  arena slots.
* **migration payloads stay on the device**: all K workers of a
  one-card cluster share the card, so a `BlockPayload` holds fp32 tensors
  on the pool's device where the reference holds host bytes.
* **prefix-tier hits stay on the device**: the engine reads a hit's rows
  straight out of the store's arena slots through the block-gather
  kernel's second pool (`kv_pool.PagedKVPool.plane`), where the
  reference copies host bytes into the request's cached KV.
"""
from __future__ import annotations

import copy
import hashlib
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.assembly import FROM_SEMANTIC, AssemblyPlan
from repro_torch.core.cache_rows import CacheRows
from repro_torch.serving.kv_pool import PagedKVPool

USER_TIER = "user"
ITEM_TIER = "item"
PREFIX_TIER = "prefix"


def content_key(kind: str, *arrays) -> Tuple[str, str]:
    """Content address: blake2b over the arrays that determine the bytes."""
    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return (kind, h.hexdigest())


# --------------------------- quantized payloads ----------------------------
def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(row, kv-head) int8 quantization of KV bytes, on the
    tensor's device.

    ``x``: (t, L, Hkv, Dh) fp32.  The scale is the absmax over the head
    dimension divided by 127 (the largest element of every row maps to
    ±127), kept fp32 at shape (t, L, Hkv, 1); all-zero rows get scale 1.
    Bitwise the reference's numpy version: one IEEE fp32 division each,
    and `torch.round` rounds half to even as `np.rint` does.  Idempotent:
    quantizing `dequantize_rows(q, s)` gives (q, s) again.
    """
    x = x.float()
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of `quantize_rows`: (t, L, Hkv, Dh) fp32."""
    return q.float() * scale


def int8_roundtrip_rows(rows: CacheRows) -> CacheRows:
    """A copy of a device pool of cached rows whose every row went through
    the int8 codec (`quantize_rows` then `dequantize_rows`, scaled per
    (layer, row, kv head) as the store scales a block): the bytes an int8
    store holds for each item block and review prototype, the offline
    caches' int8 round trip of the reference's tiered-store benchmark.
    The zero row stays zero; `rows` is left as it is."""
    out = copy.copy(rows)
    out.k, out.v = (dequantize_rows(*quantize_rows(pool)) for pool in (rows.k, rows.v))
    return out


def _dequant(data: torch.Tensor, scale: Optional[torch.Tensor],
             store: Optional["SharedBlockStore"]) -> torch.Tensor:
    """A block's fp32 bytes, billing the dequantization's host time."""
    if scale is None:
        return data
    t0 = time.perf_counter()
    out = dequantize_rows(data, scale)
    if store is not None:
        store.dequant_s += time.perf_counter() - t0
    return out


def _nbytes(*ts: Optional[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


@dataclass
class BlockRef:
    """One reusable block inside a request's prompt, as the engine sees
    it: where it lands (`positions`), which block rows those map to
    (`offsets`), and where its bytes are for an insert on a store miss:
    `row`, the block's first row in the device pool of cached rows (its
    `len(tokens)` rows follow), or -1 for none."""

    key: Tuple[str, str]
    positions: np.ndarray
    offsets: np.ndarray
    row: int = -1
    tokens: Optional[np.ndarray] = None


@dataclass
class RequestReuse:
    """Per-request reuse metadata attached to a `BatchRequest`."""

    user_key: Optional[Tuple[str, str]] = None
    prefix_end: int = 0
    blocks: List[BlockRef] = field(default_factory=list)
    # instruction-prefix tier: content digest + how many leading tokens
    # it covers; the engine appends the (n_pad, r_pad) bucket at runtime
    prefix_key: Optional[Tuple[str, str]] = None
    prefix_len: int = 0


@dataclass(frozen=True)
class BlockPayload:
    """One store block as it rides a KV migration: the content key, what a
    destination-store miss re-inserts (`k`/`v`: the block's fp32 bytes,
    (t, L, Hkv, Dh), on the source pool's device; dequantized for an int8
    block, as the reference's host payload), and the SOURCE store's slot
    ids, through which the importer translates the migrating request's
    shared slot-table entries.  The key travels first: a destination that
    already holds it never moves the bytes."""

    key: Tuple[str, str]
    kind: str
    slots: np.ndarray  # (n_tokens,) SOURCE physical slot ids
    k: torch.Tensor
    v: torch.Tensor
    tokens: Optional[np.ndarray] = None
    positions: Optional[np.ndarray] = None
    pinned: bool = False

    @property
    def nbytes(self) -> int:
        return _nbytes(self.k, self.v)


@dataclass
class StoredBlock:
    """A device-tier block.  Quantized: ``data_k``/``data_v`` (t, L, Hkv,
    Dh) int8 with fp32 ``scale_k``/``scale_v`` (t, L, Hkv, 1) on the
    pool's device.  fp32: no payload (all four None), the arena slots are
    the bytes.  ``fp32_k``/``fp32_v`` give the fp32 view, the bytes the
    arena holds (for an fp32 block, read from the arena)."""

    key: Tuple[str, str]
    kind: str
    pages: List[int]
    slots: np.ndarray  # (n_tokens,) physical slot ids, block-row order
    data_k: Optional[torch.Tensor] = None  # None => fp32, in the arena
    data_v: Optional[torch.Tensor] = None
    scale_k: Optional[torch.Tensor] = None
    scale_v: Optional[torch.Tensor] = None
    tokens: Optional[np.ndarray] = None
    positions: Optional[np.ndarray] = None  # user tier: covered positions
    pinned: bool = False
    refcount: int = 0
    last_used: int = 0
    hits: int = 0
    store: Optional["SharedBlockStore"] = field(default=None, repr=False,
                                                compare=False)

    @property
    def n_tokens(self) -> int:
        return len(self.slots)

    @property
    def nbytes(self) -> int:
        """The payload's bytes: the int8 data and its scales, or for an
        fp32 block its arena rows."""
        if self.data_k is None:
            return self.n_tokens * self.store.pool.bytes_per_token
        return _nbytes(self.data_k, self.data_v, self.scale_k, self.scale_v)

    def _fp32(self, data, scale, arena) -> torch.Tensor:
        if scale is not None:
            return _dequant(data, scale, self.store)
        sl = torch.from_numpy(self.slots).to(arena.device)
        ps = self.store.pool.page_size
        return arena[sl // ps, sl % ps]

    @property
    def fp32_k(self) -> torch.Tensor:
        return self._fp32(self.data_k, self.scale_k, self.store.pool.arena_k)

    @property
    def fp32_v(self) -> torch.Tensor:
        return self._fp32(self.data_v, self.scale_v, self.store.pool.arena_v)


@dataclass
class SpilledBlock:
    """A block demoted to the host-RAM spill tier: the same (possibly
    quantized) payload as host tensors, no pool pages, no slots.
    ``last_used`` carries the device-tier LRU stamp across the hop."""

    key: Tuple[str, str]
    kind: str
    data_k: torch.Tensor
    data_v: torch.Tensor
    scale_k: Optional[torch.Tensor] = None
    scale_v: Optional[torch.Tensor] = None
    tokens: Optional[np.ndarray] = None
    positions: Optional[np.ndarray] = None
    last_used: int = 0
    hits: int = 0

    @property
    def n_tokens(self) -> int:
        return int(self.data_k.shape[0])

    @property
    def nbytes(self) -> int:
        return _nbytes(self.data_k, self.data_v, self.scale_k, self.scale_v)


def _to(t: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    return None if t is None else t.to(device)


def user_reuse_positions(plan: AssemblyPlan, have: np.ndarray,
                         prefix_end: int) -> np.ndarray:
    """Prefix positions whose bytes are deterministic per user: semantic
    reuse hits inside [0, prefix_end)."""
    pos = np.where((plan.source == FROM_SEMANTIC) & have)[0]
    return pos[pos < prefix_end]


class SharedBlockStore:
    """Content-addressed, ref-counted KV block sharing over a pool.

    Pages the store allocates (`pool.alloc_pages`) belong to the store
    until a block is evicted; requests reference them through slot-table
    entries and per-request refcounts (`acquire`/`release`).  Eviction
    only ever touches unpinned blocks with refcount 0, in LRU order.
    """

    def __init__(self, pool: PagedKVPool, max_pages: Optional[int] = None,
                 max_user_pages: Optional[int] = None, *,
                 kv_store_dtype: str = "fp32", spill_mb: int = 0,
                 prefetch_pages_per_tick: int = 0):
        if kv_store_dtype not in ("fp32", "int8"):
            raise ValueError(f"kv_store_dtype must be fp32|int8, got {kv_store_dtype}")
        self.pool = pool
        self.kv_store_dtype = kv_store_dtype
        self.spill_cap = int(spill_mb) * 2**20
        self.prefetch_pages_per_tick = int(prefetch_pages_per_tick)
        self.spill: Dict[Tuple[str, str], SpilledBlock] = {}
        self.spill_nbytes = 0
        # the router's prefetch hints, oldest first (bounded), and the keys
        # a dispatched but unadmitted request declared: evicting one of
        # those queues its hint
        self._hints: Deque[Tuple[str, str]] = deque(maxlen=512)
        self._interest: set = set()
        self.dequant_s = 0.0
        # the store never crowds requests out of their own pool: half the
        # pages in all, pinned pages (never reclaimable) at most a quarter
        self.max_pages = max_pages if max_pages is not None else max(pool.n_pages // 2, 1)
        self.max_pinned_pages = max(pool.n_pages // 4, 1)
        self.max_user_pages = (max_user_pages if max_user_pages is not None
                               else max(pool.n_pages // 4, 1))
        self.blocks: Dict[Tuple[str, str], StoredBlock] = {}
        self._pending_writes: List[tuple] = []
        self._tick = 0
        # bumped on every insert/eviction: admission accounting memoizes
        # per-request page bounds until the resident set changes
        self.version = 0
        self.counters = {
            "hits_user": 0, "hits_item": 0, "hits_prefix": 0,
            "misses_user": 0, "misses_item": 0, "misses_prefix": 0,
            "inserts": 0, "insert_skips": 0, "evictions": 0, "spills": 0,
            "insert_spills": 0, "spill_drops": 0, "spill_hits": 0,
            "prefetch_promotions": 0,
        }

    # ------------------------------- lookup --------------------------------
    def has(self, key) -> bool:
        """Device-tier membership only: a spilled block has no slots."""
        return key in self.blocks

    def in_spill(self, key) -> bool:
        return key in self.spill

    def resident(self, key) -> bool:
        """Held in either tier."""
        return key in self.blocks or key in self.spill

    def peek(self, key) -> Optional[StoredBlock]:
        """Lookup without touching LRU state or counters (admission)."""
        return self.blocks.get(key)

    def spill_peek(self, key) -> Optional[SpilledBlock]:
        return self.spill.get(key)

    def get(self, key) -> Optional[StoredBlock]:
        blk = self.blocks.get(key)
        if blk is not None:
            self._tick += 1
            blk.last_used = self._tick
        return blk

    def acquire(self, key) -> Optional[StoredBlock]:
        """Lookup + take a reference (protects the block from eviction for
        the holder's lifetime).  Counts a tier hit/miss."""
        blk = self.get(key)
        self._interest.discard(key)          # the demand arrived
        if blk is None:
            self.counters[f"misses_{key[0]}"] += 1
            return None
        blk.refcount += 1
        self.count_hit(blk)
        return blk

    def count_hit(self, blk: StoredBlock) -> None:
        """Record a tier hit on an already-referenced block (the engine
        takes references batch-wide before it resolves hits)."""
        self._tick += 1
        blk.last_used = self._tick
        blk.hits += 1
        self.counters[f"hits_{blk.kind}"] += 1

    def release(self, key) -> None:
        blk = self.blocks.get(key)
        if blk is not None and blk.refcount > 0:
            blk.refcount -= 1

    def release_all(self, keys: Sequence) -> None:
        for key in keys:
            self.release(key)

    # ------------------------------ capacity -------------------------------
    def pages_held(self, kind: Optional[str] = None) -> int:
        return sum(len(b.pages) for b in self.blocks.values()
                   if kind is None or b.kind == kind)

    def reclaimable_pages(self, exclude: Sequence = ()) -> int:
        """Pages eviction could free now: unpinned, unreferenced blocks
        whose key is not in `exclude`."""
        ex = set(exclude)
        return sum(len(b.pages) for b in self.blocks.values()
                   if not b.pinned and b.refcount == 0 and b.key not in ex)

    def _evict_lru(self) -> bool:
        """Evict the least-recently-used unpinned, unreferenced block; with
        a spill tier its payload goes to host RAM instead of away."""
        victims = [b for b in self.blocks.values() if not b.pinned and b.refcount == 0]
        if not victims:
            return False
        victim = min(victims, key=lambda b: b.last_used)
        # a deferred write of the victim must not land: its pages may be
        # handed out again before the flush, and one write holding both
        # would race on the card.  Its bytes are the victim's, unwritten
        i = next((i for i, w in enumerate(self._pending_writes) if w[0] is victim.slots),
                 None)
        pending = None if i is None else self._pending_writes.pop(i)
        if self.spill_cap > 0:
            # an fp32 block's payload is its arena slots (or the write still
            # pending for them): read them back before the pages go
            if victim.scale_k is not None:
                data_k, data_v = victim.data_k, victim.data_v
            elif pending is not None:
                data_k, data_v = pending[1], pending[2]
            else:
                data_k, data_v = victim.fp32_k, victim.fp32_v
            self._spill_put(SpilledBlock(
                key=victim.key, kind=victim.kind,
                data_k=data_k.cpu(), data_v=data_v.cpu(),
                scale_k=_to(victim.scale_k, "cpu"), scale_v=_to(victim.scale_v, "cpu"),
                tokens=victim.tokens, positions=victim.positions,
                last_used=victim.last_used, hits=victim.hits))
            if victim.key in self._interest:
                # a dispatched request needs it: queue its promotion now
                self._interest.discard(victim.key)
                self._hints.append(victim.key)
        del self.blocks[victim.key]
        self.pool.release_pages(victim.pages)
        self.counters["evictions"] += 1
        self.version += 1
        return True

    def _spill_put(self, sp: SpilledBlock) -> None:
        """Land one payload in the host tier (replacing a stale entry under
        the same key) and trim oldest-first back under capacity."""
        old = self.spill.pop(sp.key, None)
        if old is not None:
            self.spill_nbytes -= old.nbytes
        self.spill[sp.key] = sp
        self.spill_nbytes += sp.nbytes
        self.counters["spills"] += 1
        while self.spill_nbytes > self.spill_cap and self.spill:
            drop = min(self.spill.values(), key=lambda s: s.last_used)
            del self.spill[drop.key]
            self.spill_nbytes -= drop.nbytes
            self.counters["spill_drops"] += 1

    def evict_for(self, n_pages: int) -> bool:
        """LRU-evict until `n_pages` are free in the pool.  -> success."""
        while self.pool.free_pages < n_pages:
            if not self._evict_lru():
                return False
        return True

    # ------------------------------- insert --------------------------------
    def insert(self, key, kind: str, k: torch.Tensor, v: torch.Tensor,
               tokens: Optional[np.ndarray] = None,
               positions: Optional[np.ndarray] = None, pinned: bool = False,
               keep_free: int = 0, defer_write: bool = False
               ) -> Optional[StoredBlock]:
        """Insert a block's bytes into store-owned pages.

        Optional: returns None (and counts a skip) when the tier budget is
        exhausted or when taking the pages would leave fewer than
        `keep_free` free pages even after LRU eviction — the caller then
        writes privately.  k/v: (t, L, Hkv, Dh) pre-RoPE tensors, row order
        matching `BlockRef.offsets`, on the pool's device; the arena slots
        keep the bytes.  ``defer_write`` stages the arena write until
        `flush_writes`: k/v must then stay unchanged until that flush.
        """
        if key in self.blocks:
            return self.blocks[key]
        n = k.shape[0]
        if n == 0:
            return None
        if key in self.spill:
            # content addressing: same key = same bytes, so the spilled
            # payload is the block — promote it
            blk = self._promote(key, keep_free=keep_free, defer_write=defer_write)
            if blk is not None:
                self.counters["spill_hits"] += 1
                return blk
            self.counters["insert_skips"] += 1
            return None
        data_k, scale_k = self._quant(kind, k)
        data_v, scale_v = self._quant(kind, v)
        blk = self._admit(key, kind, data_k, data_v, scale_k, scale_v, tokens=tokens,
                          positions=positions, pinned=pinned, keep_free=keep_free,
                          defer_write=defer_write)
        if blk is None:
            if self.spill_cap > 0:
                # write-around: the device tier refused the bytes, the host
                # tier keeps the encoded payload for a revisit
                self._tick += 1
                self._spill_put(SpilledBlock(
                    key=key, kind=kind, data_k=data_k.cpu(), data_v=data_v.cpu(),
                    scale_k=_to(scale_k, "cpu"), scale_v=_to(scale_v, "cpu"),
                    tokens=tokens, positions=positions, last_used=self._tick))
                self.counters["insert_spills"] += 1
            self.counters["insert_skips"] += 1
            return None
        self.counters["inserts"] += 1
        return blk

    def _quant(self, kind: str, arr: torch.Tensor
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Store-tier representation of incoming bytes, on the pool's
        device (no copy of fp32 bytes already there).  Only the user and
        item tiers quantize: the prefix tier's shared content IS the
        recomputed content, so it stays fp32."""
        arr = arr.to(self.pool.device, torch.float32)
        if self.kv_store_dtype == "int8" and kind != PREFIX_TIER:
            return quantize_rows(arr)
        return arr, None

    def _admit(self, key, kind: str, data_k: torch.Tensor, data_v: torch.Tensor,
               scale_k: Optional[torch.Tensor], scale_v: Optional[torch.Tensor],
               tokens: Optional[np.ndarray], positions: Optional[np.ndarray],
               pinned: bool, keep_free: int, defer_write: bool, hits: int = 0
               ) -> Optional[StoredBlock]:
        """Budget gates + page allocation + arena write for an already
        store-encoded payload (fresh inserts and spill promotions).
        -> None on any budget refusal (the caller counts it)."""
        n = data_k.shape[0]
        need = self.pool.pages_for(n)
        if kind == USER_TIER and self.pages_held(USER_TIER) + need > self.max_user_pages:
            return None
        if pinned:
            held = sum(len(b.pages) for b in self.blocks.values() if b.pinned)
            if held + need > self.max_pinned_pages:
                return None
        while self.pages_held() + need > self.max_pages:
            if not self._evict_lru():
                return None
        if not self.evict_for(need + keep_free):
            return None
        pages = self.pool.alloc_pages(need)
        slots = self.pool.page_slots(pages)[:n]
        self._tick += 1
        dev = self.pool.device
        quant = scale_k is not None
        blk = StoredBlock(key=key, kind=kind, pages=pages, slots=slots,
                          data_k=_to(data_k, dev) if quant else None,
                          data_v=_to(data_v, dev) if quant else None,
                          scale_k=_to(scale_k, dev), scale_v=_to(scale_v, dev),
                          tokens=tokens, positions=positions, pinned=pinned,
                          last_used=self._tick, hits=hits, store=self)
        # the arena always holds the fp32 view the engine reads; under
        # int8 that is dequantize(quantize(x))
        k32, v32 = (blk.fp32_k, blk.fp32_v) if quant else (data_k, data_v)
        if defer_write:
            self._pending_writes.append((slots, k32, v32))
        else:
            self.pool.write_slots(slots, k32, v32)
        self.blocks[key] = blk
        self.version += 1
        return blk

    def _promote(self, key, keep_free: int = 0, defer_write: bool = True
                 ) -> Optional[StoredBlock]:
        """Re-stage a spilled block into device pages under its key.  The
        spill entry goes only on success (admission may itself spill and
        trim, so it is re-popped afterwards)."""
        sp = self.spill.get(key)
        if sp is None:
            return None
        blk = self._admit(key, sp.kind, sp.data_k, sp.data_v, sp.scale_k, sp.scale_v,
                          tokens=sp.tokens, positions=sp.positions, pinned=False,
                          keep_free=keep_free, defer_write=defer_write, hits=sp.hits)
        if blk is None:
            return None
        gone = self.spill.pop(key, None)
        if gone is not None:
            self.spill_nbytes -= gone.nbytes
        return blk

    # ------------------------------- prefetch -------------------------------
    def hint(self, keys: Sequence) -> None:
        """The router's prefetch hints: content keys a dispatched request
        will need on this worker.  A key in the spill tier queues for
        promotion; any other registers interest, so that an eviction
        before the request's admission queues the hint then."""
        for key in keys:
            if key in self.spill and key not in self.blocks:
                self._hints.append(key)
            else:
                self._interest.add(key)
                if len(self._interest) > 4 * self._hints.maxlen:
                    self._interest.clear()     # advisory: shed, don't grow

    def prefetch(self, budget_pages: Optional[int] = None) -> int:
        """Promote hinted spill blocks to the device, oldest hint first,
        within a page budget (default ``prefetch_pages_per_tick``).  A
        promotion may evict LRU blocks nobody references (to the spill
        tier); pinned and referenced pages are never touched.  A hint
        needing more than the whole budget is dropped, and so is one whose
        promotion is refused.  -> promotions."""
        budget = self.prefetch_pages_per_tick if budget_pages is None else budget_pages
        if budget <= 0:
            return 0
        promoted = 0
        remaining = int(budget)
        while self._hints and remaining > 0:
            key = self._hints[0]
            sp = self.spill.get(key)
            if sp is None or key in self.blocks:
                self._hints.popleft()
                continue
            need = self.pool.pages_for(sp.n_tokens)
            if need > budget:
                self._hints.popleft()
                continue
            if need > remaining:
                break
            if self._promote(key, defer_write=True) is None:
                self._hints.popleft()
                continue
            self._hints.popleft()
            self.counters["prefetch_promotions"] += 1
            promoted += 1
            remaining -= need
        return promoted

    # ------------------------------ migration ------------------------------
    def export_payload(self, key) -> Optional[BlockPayload]:
        """One device-tier block as a migration payload under its content
        key (read-only); None for a key this store does not hold there."""
        blk = self.blocks.get(key)
        if blk is None:
            return None
        self.flush_writes()      # an fp32 block's bytes are its arena slots
        return BlockPayload(key=blk.key, kind=blk.kind,
                            slots=np.asarray(blk.slots, np.int64),
                            k=blk.fp32_k, v=blk.fp32_v, tokens=blk.tokens,
                            positions=blk.positions, pinned=blk.pinned)

    def import_payload(self, payload: BlockPayload, keep_free: int = 0
                       ) -> Tuple[Optional[StoredBlock], bool]:
        """Resolve a migration payload against this store.  -> (the block
        holding the bytes, with one reference taken for the migrating
        request, digest hit).  A hit (the key held in either tier: a
        spilled one is promoted) moves no bytes.  A miss inserts the
        payload under its key, tier and pinning (deferred write: the
        importer flushes); a budget refusal gives (None, False), and the
        caller then writes those rows privately."""
        blk = self.get(payload.key)
        if blk is not None:
            blk.refcount += 1
            return blk, True
        if payload.key in self.spill:
            blk = self._promote(payload.key, keep_free=keep_free, defer_write=True)
            if blk is None:
                return None, False
            self.counters["spill_hits"] += 1
            blk.refcount += 1
            return blk, True
        blk = self.insert(payload.key, payload.kind, payload.k, payload.v,
                          tokens=payload.tokens, positions=payload.positions,
                          pinned=payload.pinned, keep_free=keep_free, defer_write=True)
        if blk is None:
            return None, False
        blk.refcount += 1
        return blk, False

    # ------------------------------ deferred ------------------------------
    def flush_writes(self) -> None:
        """Land every deferred insert's bytes in ONE arena write."""
        if self._pending_writes:
            self.pool.write_slots_batch(self._pending_writes)
            self._pending_writes = []

    # -------------------------------- stats --------------------------------
    def stats(self) -> dict:
        tiers = (USER_TIER, ITEM_TIER, PREFIX_TIER)
        hits = sum(self.counters[f"hits_{t}"] for t in tiers)
        misses = sum(self.counters[f"misses_{t}"] for t in tiers)
        return {
            "blocks": len(self.blocks),
            "device_blocks": len(self.blocks),
            "spill_blocks": len(self.spill),
            "spill_mbytes": self.spill_nbytes / 2**20,
            "dequant_s": self.dequant_s,
            "pages_user": self.pages_held(USER_TIER),
            "pages_item": self.pages_held(ITEM_TIER),
            "pages_prefix": self.pages_held(PREFIX_TIER),
            "hit_rate": hits / max(hits + misses, 1),
            **self.counters,
        }


def recompute_base_and_topk(plan: AssemblyPlan, have: np.ndarray, sel
                            ) -> Tuple[np.ndarray, int]:
    """The deterministic half of `engine.select_recompute`: the base
    recompute mask (misses + trailing window) plus the per-class top-k
    COUNT the Eq. 3 budgets add.  Admission accounting, the prefix-tier
    key and bucket pre-warming all build on it."""
    n = plan.n
    base = ~np.asarray(have, bool)
    base[max(0, n - sel.window):] = True
    k_top = 0
    for kind, budget in ((2, sel.r_item), (1, sel.r_rev)):
        cls = int(((plan.seg_kind == kind) & ~base).sum())
        if cls:
            k_top += int(np.ceil(budget * cls))
    return base, k_top


def shape_bucket(plan: AssemblyPlan, have: np.ndarray, sel, bucket: int = 64
                 ) -> Tuple[int, int]:
    """The (n_pad, r_pad) bucket one request's selective prefill lands in,
    known without running layer 0."""
    base, k_top = recompute_base_and_topk(plan, have, sel)
    r_count = int(base.sum()) + k_top
    n_pad = -(-plan.n // bucket) * bucket
    return n_pad, max(64, -(-r_count // 64) * 64)


def admission_pages(pool: PagedKVPool, store: Optional[SharedBlockStore],
                    plan: AssemblyPlan, have: np.ndarray, sel,
                    reuse: Optional[RequestReuse], n_reserve: int,
                    bucket: int = 64) -> Tuple[int, int]:
    """Upper bound on the private pages one request consumes at prefill.

    -> (private page bound, number of blocks it may insert).  Without a
    store this is the plain `pages_for` demand.  With one, positions
    mappable from resident blocks are credited, minus a worst-case
    allowance for the selective pass stealing mapped positions back to
    private, so admitted prefills never hit `PoolExhausted`.  Prefix-tier
    positions are credited without a steal allowance.
    """
    base_pages = pool.pages_for(plan.n + n_reserve)
    if store is None or reuse is None:
        return base_pages, 0
    n = plan.n
    mappable = np.zeros(n, bool)
    n_missing = 0
    for ref in reuse.blocks:
        if store.has(ref.key):
            mappable[ref.positions] = True
        elif ref.row >= 0:
            n_missing += 1
    if reuse.user_key is not None:
        u_pos = user_reuse_positions(plan, have, reuse.prefix_end)
        ublk = store.peek(reuse.user_key)
        if ublk is not None:
            mappable[u_pos[np.isin(u_pos, ublk.positions)]] = True
        elif len(u_pos):
            n_missing += 1
    base_rec, k_top = recompute_base_and_topk(plan, have, sel)
    steal = int(mappable[base_rec].sum())
    steal += min(k_top, int(mappable[~base_rec].sum()))
    n_shared_min = max(int(mappable.sum()) - steal, 0)
    if reuse.prefix_key is not None and reuse.prefix_len:
        full_key = reuse.prefix_key + shape_bucket(plan, have, sel, bucket)
        if store.has(full_key):
            n_shared_min += min(reuse.prefix_len, n)
        else:
            n_missing += 1
    priv_slots = base_pages * pool.page_size - n_shared_min
    return -(-priv_slots // pool.page_size), n_missing


def check_partition(pool: PagedKVPool, store: Optional[SharedBlockStore] = None) -> None:
    """Allocator + store invariant: every page but scratch page 0 is owned
    by exactly one of {free list, one request's page table, the store};
    slot-table entries only reference pages the request owns or the store
    holds; store blocks are internally consistent.  Raises AssertionError.
    """
    owner: Dict[int, str] = {}

    def claim(page: int, who: str) -> None:
        assert page != 0, f"{who} owns the scratch page"
        assert page not in owner, f"page {page}: {owner[page]} and {who}"
        owner[page] = who

    for page in pool._free:
        claim(page, "free-list")
    for rid, pages in pool.page_tables.items():
        for page in pages:
            claim(page, f"request {rid}")
    store_pages = set()
    if store is not None:
        both = set(store.blocks) & set(store.spill)
        assert not both, f"keys in both device and spill tiers: {both}"
        for blk in store.blocks.values():
            assert blk.refcount >= 0, f"{blk.key}: negative refcount"
            assert len(blk.pages) == pool.pages_for(blk.n_tokens)
            for page in blk.pages:
                claim(page, f"store block {blk.key}")
                store_pages.add(page)
            assert set(blk.slots // pool.page_size) <= set(blk.pages)
    assert set(owner) == set(range(1, pool.n_pages)), (
        "pages leaked or double-freed: "
        f"{set(range(1, pool.n_pages)) ^ set(owner)}")
    for rid, table in pool.slot_tables.items():
        own = set(pool.page_tables[rid])
        for page in np.unique(table // pool.page_size):
            assert int(page) in own or int(page) in store_pages, (
                f"request {rid} slot table references page {page} it "
                "neither owns nor shares")
