"""Paged KV cache pool for the batched serving path (vLLM-style) — the
port of the JAX package's `serving/kv_pool.py` (request slot tables, mapped
allocation and private remapping, the raw page and slot interface of
the shared block store, and a request's export / import for KV
migration between two pools).

One preallocated device arena holds every request's per-layer KV in
fixed-size pages; a free-list allocator hands pages to requests and a
per-request **slot table** maps logical token positions to physical
slots (page * page_size + in-page slot).  K and V are stored
**pre-RoPE**, so decode realigns keys to their request positions with
one rotation (inside the paged-decode kernel).

The arenas are torch tensors on the serving device and every write
lands **in place** (`index_put_`), where the JAX package rebuilds them
functionally; the rows written come from the device.  Slot tables, the
free list and the page views stay numpy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import LMConfig


class PoolExhausted(RuntimeError):
    """No free pages left — caller should defer admission (backpressure)."""


@dataclass(frozen=True)
class PoolStats:
    n_pages: int
    page_size: int
    pages_in_use: int
    n_requests: int
    tokens_resident: int

    @property
    def utilization(self) -> float:
        return self.pages_in_use / max(self.n_pages, 1)

    @property
    def internal_fragmentation(self) -> float:
        """Fraction of allocated slots holding no token."""
        cap = self.pages_in_use * self.page_size
        return 1.0 - self.tokens_resident / max(cap, 1)


@dataclass(frozen=True)
class KVExport:
    """One request's pool state as a self-contained record, the
    page-granular unit of KV migration between two pools.

    The slot table is stored page-relatively: a private entry is an
    (exported-page index, in-page offset) pair, rebound to whatever pages
    the destination hands out; a store-shared entry (`owner_page == -1`)
    keeps the SOURCE pool's slot id in `foreign_slots`, which the importer
    translates through a source-slot -> destination-slot map.
    `page_k`/`page_v` are the private pages' full bytes, (P, page_size, L,
    Hkv, Dh) pre-RoPE, on the source pool's device (unused slots ride
    along, so the import is one write and the round trip is bitwise)."""

    rid: int
    seq_len: int
    page_size: int
    owner_page: np.ndarray     # (n_slots,) exported-page index, -1 = shared
    owner_off: np.ndarray      # (n_slots,) in-page offset where owned
    foreign_slots: np.ndarray  # (n_slots,) source slot id where shared
    spare_page: np.ndarray     # (n_spare,) exported-page index
    spare_off: np.ndarray      # (n_spare,)
    page_k: torch.Tensor       # (P, page_size, L, Hkv, Dh)
    page_v: torch.Tensor

    @property
    def n_pages(self) -> int:
        return self.page_k.shape[0]

    @property
    def nbytes(self) -> int:
        """Private-page bytes (what a migration must move)."""
        return 2 * self.page_k.numel() * self.page_k.element_size()


class PagedKVPool:
    """Fixed-page KV arena + free-list allocator + per-request slot tables.

    Arena layout: (n_pages, page_size, n_layers, n_kv_heads, head_dim)
    for K and V separately, dtype float32 (pre-RoPE values).
    """

    def __init__(self, n_layers: int, n_kv_heads: int, head_dim: int,
                 page_size: int = 16, n_pages: int = 512,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        self.page_size = int(page_size)
        self.n_pages = int(n_pages)
        self.n_layers = n_layers
        shape = (self.n_pages, self.page_size, n_layers, n_kv_heads, head_dim)
        self.arena_k = torch.zeros(shape, dtype=dtype, device=device)
        self.arena_v = torch.zeros(shape, dtype=dtype, device=device)
        # page 0 is reserved as scratch: padded slot-table entries and
        # padded page-view columns point at it (every such slot is dead).
        # It is never allocated.
        self._free: List[int] = list(range(self.n_pages - 1, 0, -1))
        self.page_tables: Dict[int, List[int]] = {}
        self.slot_tables: Dict[int, np.ndarray] = {}
        self.seq_lens: Dict[int, int] = {}
        self._spare: Dict[int, List[int]] = {}
        self.peak_pages = 0

    @property
    def device(self) -> torch.device:
        return self.arena_k.device

    # ------------------------------ allocator ------------------------------
    @property
    def bytes_per_token(self) -> int:
        """K + V bytes one token row occupies across all layers: the unit
        the spill tier's capacity and transfer modelling price in."""
        return 2 * self.arena_k.element_size() * self.arena_k[0, 0].numel()

    def can_admit(self, n_tokens: int) -> bool:
        return self.free_pages >= self.pages_for(n_tokens)

    def seq_len(self, rid: int) -> int:
        return self.seq_lens[rid]

    def pages_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 1) // self.page_size)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def page_slots(self, pages: Sequence[int]) -> np.ndarray:
        """Physical slot ids covered by `pages`, in page order."""
        pages = np.asarray(pages, np.int64)
        return (pages[:, None] * self.page_size
                + np.arange(self.page_size)[None, :]).reshape(-1)

    def _bump_peak(self) -> None:
        self.peak_pages = max(self.peak_pages,
                              self.n_pages - 1 - len(self._free))

    def alloc_pages(self, n: int) -> List[int]:
        """Raw page grab with no request bookkeeping — the block store's
        allocation path.  The caller owns the pages until it hands them
        back through `release_pages`."""
        if n > len(self._free):
            raise PoolExhausted(f"need {n} pages, {len(self._free)} free")
        pages = [self._free.pop() for _ in range(n)]
        self._bump_peak()
        return pages

    def release_pages(self, pages: Sequence[int]) -> None:
        self._free.extend(pages)

    def alloc(self, rid: int, n_tokens: int) -> List[int]:
        """Reserve private pages for `n_tokens` slots; seq_len starts at 0."""
        if rid in self.page_tables:
            raise KeyError(f"request {rid} already allocated")
        need = self.pages_for(n_tokens)
        if need > len(self._free):
            raise PoolExhausted(
                f"need {need} pages, {len(self._free)} free")
        pages = [self._free.pop() for _ in range(need)]
        self.page_tables[rid] = pages
        self.slot_tables[rid] = self.page_slots(pages).astype(np.int64)
        self.seq_lens[rid] = 0
        self._bump_peak()
        return pages

    def alloc_mapped(self, rid: int, n_tokens: int,
                     mapped_positions: np.ndarray,
                     mapped_slots: np.ndarray,
                     extra_pages: int = 0) -> List[int]:
        """Reserve capacity for `n_tokens` slots with some logical
        positions pointing at *shared* physical slots.  Capacity is
        `pages_for(n_tokens) * page_size` slots — the same formula as
        `alloc` — but only the non-mapped slots consume private pages,
        packed densely; ``extra_pages`` claims spare private pages."""
        if rid in self.page_tables:
            raise KeyError(f"request {rid} already allocated")
        mapped_positions = np.asarray(mapped_positions, np.int64)
        mapped_slots = np.asarray(mapped_slots, np.int64)
        total_slots = self.pages_for(n_tokens) * self.page_size
        n_priv = total_slots - len(mapped_positions)
        need = -(-n_priv // self.page_size) if n_priv > 0 else 0
        need += max(int(extra_pages), 0)
        if need > len(self._free):
            raise PoolExhausted(
                f"need {need} pages, {len(self._free)} free")
        pages = [self._free.pop() for _ in range(need)]
        table = np.full(total_slots, -1, np.int64)
        table[mapped_positions] = mapped_slots
        all_slots = self.page_slots(pages)
        priv = all_slots[:max(n_priv, 0)]
        table[table < 0] = priv
        self.page_tables[rid] = pages
        self.slot_tables[rid] = table
        self._spare[rid] = list(all_slots[max(n_priv, 0):])
        self.seq_lens[rid] = (int(mapped_positions.max()) + 1
                              if len(mapped_positions) else 0)
        self._bump_peak()
        return pages

    def remap_private(self, rid: int, positions: np.ndarray) -> None:
        """Point mapped logical `positions` at this request's own private
        slots instead (the mid-prefill un-sharing of positions Eq. 3
        selects for recomputation: their fresh KV must land privately).
        Draws from the spare slots reserved at `alloc_mapped` first and
        only then claims new pages, so a request that reserved its bound
        as ``extra_pages`` never fails here."""
        positions = np.asarray(positions, np.int64)
        if len(positions) == 0:
            return
        spare = self._spare.setdefault(rid, [])
        short = len(positions) - len(spare)
        if short > 0:
            n_new = -(-short // self.page_size)
            if n_new > len(self._free):
                raise PoolExhausted(
                    f"remap needs {n_new} pages, {len(self._free)} free")
            pages = [self._free.pop() for _ in range(n_new)]
            self.page_tables[rid].extend(pages)
            spare.extend(self.page_slots(pages))
            self._bump_peak()
        table = self.slot_tables[rid]
        table[positions] = [spare.pop(0) for _ in range(len(positions))]

    def free(self, rid: int) -> None:
        """Release a request's private pages.  Idempotent."""
        pages = self.page_tables.pop(rid, None)
        if pages is None:
            return
        self._free.extend(pages)
        self.slot_tables.pop(rid, None)
        self.seq_lens.pop(rid, None)
        self._spare.pop(rid, None)

    def stats(self) -> PoolStats:
        in_use = sum(len(t) for t in self.page_tables.values())
        return PoolStats(n_pages=self.n_pages, page_size=self.page_size,
                         pages_in_use=in_use,
                         n_requests=len(self.page_tables),
                         tokens_resident=sum(self.seq_lens.values()))

    # ------------------------------- writes --------------------------------
    def _phys(self, rid: int, positions: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Logical token slots -> (page ids, in-page slots), growing the
        slot table by one private page if a position lands past current
        capacity."""
        table = self.slot_tables[rid]
        top = int(positions.max())
        while top >= len(table):
            if not self._free:
                raise PoolExhausted("decode append: no free pages")
            page = self._free.pop()
            self.page_tables[rid].append(page)
            table = np.concatenate([table, self.page_slots([page])])
            self.slot_tables[rid] = table
            self._bump_peak()
        slots = table[positions]
        return ((slots // self.page_size).astype(np.int64),
                (slots % self.page_size).astype(np.int64))

    def write_at(self, rid: int, positions: np.ndarray, k, v,
                 layer: Optional[int] = None) -> None:
        """Scatter pre-RoPE (k, v) into logical slots.  k/v: (t, L, Hkv,
        Dh), or (t, Hkv, Dh) when `layer` selects one layer plane."""
        self.write_at_batch([(rid, positions, k, v)], layer=layer)

    def write_at_batch(self, entries: Sequence[tuple],
                       layer: Optional[int] = None, deep: bool = False) -> None:
        """One in-place arena scatter for any number of requests' writes.

        entries: sequence of (rid, positions, k, v): host int positions and
        k/v rows as tensors on the arena's device (the serving path: no
        KV crosses PCIe) or host arrays.  ``deep`` writes only layer
        planes 1..L-1 from (t, L-1, Hkv, Dh) rows.  Positions are unique
        within an entry and entries name distinct requests, so no
        physical slot is written twice.  Entries with no positions are
        skipped.
        """
        pages_all, slots_all, ks, vs = [], [], [], []
        dev = self.device
        for rid, positions, k, v in entries:
            positions = np.asarray(positions, np.int64)
            if len(positions) == 0:
                continue
            pages, slots = self._phys(rid, positions)
            pages_all.append(pages)
            slots_all.append(slots)
            ks.append(torch.as_tensor(k, device=dev))
            vs.append(torch.as_tensor(v, device=dev))
            self.seq_lens[rid] = max(self.seq_lens[rid],
                                     int(positions.max()) + 1)
        if not pages_all:
            return
        pages = torch.from_numpy(np.concatenate(pages_all)).to(dev)
        slots = torch.from_numpy(np.concatenate(slots_all)).to(dev)
        k = torch.cat(ks).to(self.arena_k.dtype)
        v = torch.cat(vs).to(self.arena_v.dtype)
        if deep:
            self.arena_k[:, :, 1:].index_put_((pages, slots), k)
            self.arena_v[:, :, 1:].index_put_((pages, slots), v)
            return
        if layer is None:
            idx = (pages, slots)
        else:
            idx = (pages, slots, torch.full_like(pages, layer))
        self.arena_k.index_put_(idx, k)
        self.arena_v.index_put_(idx, v)

    def write_slots(self, slot_ids: np.ndarray, k, v) -> None:
        """Direct physical-slot write (no request bookkeeping) — the block
        store's insertion path.  k/v: (t, L, Hkv, Dh)."""
        self.write_slots_batch([(slot_ids, k, v)])

    def write_slots_batch(self, entries: Sequence[tuple]) -> None:
        """ONE in-place arena write for any number of (slot_ids, k, v)
        blocks: the store lands a whole prefill's inserts through here.
        k/v are tensors on the arena's device (or host arrays)."""
        entries = [e for e in entries if len(e[0])]
        if not entries:
            return
        dev = self.device
        slot_ids = torch.from_numpy(np.concatenate(
            [np.asarray(s, np.int64) for s, _, _ in entries])).to(dev)
        k = torch.cat([torch.as_tensor(k, device=dev) for _, k, _ in entries])
        v = torch.cat([torch.as_tensor(v, device=dev) for _, _, v in entries])
        idx = (slot_ids // self.page_size, slot_ids % self.page_size)
        self.arena_k.index_put_(idx, k.to(self.arena_k.dtype))
        self.arena_v.index_put_(idx, v.to(self.arena_v.dtype))

    def planes(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both arenas as stacks of layer planes of one-slot pages: (k, v)
        views of shape (L, n_pages * page_size, 1, Hkv, Dh), [l, i] being
        layer l of physical slot i.  Strided (a slot's layers are adjacent,
        slots L layers apart), not copied: the block-gather kernel's second
        pool, through which the selective layers read store-shared prefix
        rows."""
        n, ps, L = self.n_pages, self.page_size, self.n_layers
        tail = tuple(self.arena_k.shape[3:])
        return tuple(a.view(n * ps, 1, L, *tail).movedim(2, 0)
                     for a in (self.arena_k, self.arena_v))

    def write_prompt(self, rid: int, k, v) -> None:
        """Insert a full prompt cache (n, L, Hkv, Dh) starting at slot 0."""
        self.write_at(rid, np.arange(k.shape[0]), k, v)

    def append_slots(self, rids: Sequence[int]
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Claim the next physical slot for each request's new decode
        token, growing slot tables across page boundaries and bumping
        seq_lens; the decode step writes the KV.  -> (pages, slots) int32.

        Transactional: on `PoolExhausted` every mutation this call made
        is rolled back before the exception propagates."""
        pages = np.zeros(len(rids), np.int32)
        slots = np.zeros(len(rids), np.int32)
        done: List[tuple] = []          # (rid, n_pages_appended)
        try:
            for i, rid in enumerate(rids):
                before = len(self.page_tables[rid])
                pos = np.asarray([self.seq_lens[rid]])
                pg, sl = self._phys(rid, pos)
                pages[i], slots[i] = pg[0], sl[0]
                self.seq_lens[rid] += 1
                done.append((rid, len(self.page_tables[rid]) - before))
        except PoolExhausted:
            for rid, n_new in done:
                self.seq_lens[rid] -= 1
                for _ in range(n_new):
                    self._free.append(self.page_tables[rid].pop())
                    self.slot_tables[rid] = \
                        self.slot_tables[rid][:-self.page_size]
            raise
        return pages, slots

    # ------------------------------ migration ------------------------------
    def export_request(self, rid: int) -> KVExport:
        """Read-only snapshot of one request's pool state: its private
        pages gathered on the device (one `index_select` per arena), the
        slot table page-relative, the spare slots and seq_len.  The caller
        frees the source only after the destination's import succeeded."""
        pages = self.page_tables[rid]
        index = {p: i for i, p in enumerate(pages)}
        table = self.slot_tables[rid]
        owner_page = np.asarray([index.get(int(p), -1) for p in table // self.page_size],
                                np.int64)
        owner_off = np.where(owner_page >= 0, table % self.page_size, 0).astype(np.int64)
        foreign_slots = np.where(owner_page < 0, table, -1).astype(np.int64)
        spare = np.asarray(self._spare.get(rid, []), np.int64)
        spare_page = np.asarray([index[int(s) // self.page_size] for s in spare], np.int64)
        idx = torch.as_tensor(pages, dtype=torch.int64, device=self.device)
        return KVExport(rid=rid, seq_len=self.seq_lens[rid], page_size=self.page_size,
                        owner_page=owner_page, owner_off=owner_off,
                        foreign_slots=foreign_slots, spare_page=spare_page,
                        spare_off=spare % self.page_size,
                        page_k=self.arena_k.index_select(0, idx),
                        page_v=self.arena_v.index_select(0, idx))

    def import_request(self, export: KVExport,
                       foreign_slot_map: Optional[Dict[int, int]] = None) -> List[int]:
        """Materialize an exported request in this pool: fresh private
        pages for the exported ones, the slot table rewritten against them
        (shared entries through `foreign_slot_map`, source slot ->
        destination slot), the page bytes in one write, seq_len and spare
        slots restored.  Transactional: a duplicate rid, an unmapped shared
        slot or `PoolExhausted` is raised before the first mutation."""
        rid = export.rid
        if export.page_size != self.page_size:
            raise ValueError(f"page_size mismatch: export {export.page_size}, "
                             f"pool {self.page_size}")
        if rid in self.page_tables:
            raise KeyError(f"request {rid} already allocated")
        fmap = foreign_slot_map or {}
        shared = export.owner_page < 0
        missing = [int(s) for s in export.foreign_slots[shared] if int(s) not in fmap]
        if missing:
            raise KeyError(f"import of request {rid}: no destination mapping for "
                           f"shared slots {missing[:4]}")
        need = export.n_pages
        if need > len(self._free):
            raise PoolExhausted(f"import needs {need} pages, {len(self._free)} free")
        pages = [self._free.pop() for _ in range(need)]
        page_arr = np.asarray(pages, np.int64)
        table = np.empty(len(export.owner_page), np.int64)
        table[~shared] = (page_arr[export.owner_page[~shared]] * self.page_size
                          + export.owner_off[~shared])
        table[shared] = [fmap[int(s)] for s in export.foreign_slots[shared]]
        self.page_tables[rid] = pages
        self.slot_tables[rid] = table
        self.seq_lens[rid] = export.seq_len
        self._spare[rid] = list(page_arr[export.spare_page] * self.page_size
                                + export.spare_off)
        if need:
            tail = tuple(export.page_k.shape[2:])
            self.write_slots(self.page_slots(pages), export.page_k.reshape(-1, *tail),
                             export.page_v.reshape(-1, *tail))
        self._bump_peak()
        return pages

    # -------------------------------- reads --------------------------------
    def gather(self, rid: int) -> Tuple[np.ndarray, np.ndarray]:
        """Host-side readback of one request's (k, v): (S, L, Hkv, Dh)."""
        n = self.seq_lens[rid]
        sl = torch.from_numpy(self.slot_tables[rid][:n]).to(self.device)
        pages, slots = sl // self.page_size, sl % self.page_size
        return (self.arena_k[pages, slots].float().cpu().numpy(),
                self.arena_v[pages, slots].float().cpu().numpy())

    def batch_tables(self, rids: Sequence[int], pad_pages_to: int = 4
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Padded slot-table batch for the decode step.
        -> (tables (N, S) int32 physical slot ids, seq_lens (N,) int32);
        pad entries point at slot 0 (the scratch page)."""
        chunk = pad_pages_to * self.page_size
        max_s = max(len(self.slot_tables[r]) for r in rids)
        max_s = -(-max_s // chunk) * chunk
        tables = np.zeros((len(rids), max_s), np.int32)
        lens = np.zeros(len(rids), np.int32)
        for i, r in enumerate(rids):
            t = self.slot_tables[r]
            tables[i, :len(t)] = t
            lens[i] = self.seq_lens[r]
        return tables, lens


def page_views(tables: np.ndarray, lens: np.ndarray,
               new_pages: np.ndarray, new_slots: np.ndarray,
               page_size: int, pad_pages_to: int = 4
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Page-granular decode views for the paged-decode kernel (a numpy copy
    of the JAX package's `serving/kv_pool.py:page_views`).

    tables: (N, S) physical slot ids in logical order; lens: (N,) tokens
    resident before this step (= the new token's logical position);
    new_pages/new_slots: (N,) the slot claimed for this step's token —
    included in the view at position len, so the kernel reads the new
    token's KV from the arena the decode step just wrote.

    -> (page_ids (N, Pmax) int32, slot_pos (N, Pmax, page_size) int32):
    `page_ids[i, j]` is the j-th distinct physical page row i touches
    (first-appearance order); `slot_pos[i, j, t]` is the logical position
    slot t of that page serves for row i, or -1.  Pmax is padded to a
    `pad_pages_to` multiple; pad columns reference the scratch page 0
    with all-(-1) positions.
    """
    tables = np.asarray(tables)
    n = tables.shape[0]
    lens = np.asarray(lens, np.int64)
    new_slot_ids = (np.asarray(new_pages, np.int64) * page_size
                    + np.asarray(new_slots, np.int64))
    per_row = []
    for i in range(n):
        ln = int(lens[i])
        slots = np.empty(ln + 1, np.int64)
        slots[:ln] = tables[i, :ln]
        slots[ln] = new_slot_ids[i]
        pages = slots // page_size
        offs = slots % page_size
        uniq, first, inv = np.unique(pages, return_index=True,
                                     return_inverse=True)
        order = np.argsort(first, kind="stable")
        rank = np.empty(len(uniq), np.int64)
        rank[order] = np.arange(len(uniq))
        spos = np.full((len(uniq), page_size), -1, np.int32)
        # distinct logical positions live in distinct physical slots, so
        # the (page-rank, offset) pairs are unique — no write collides
        spos[rank[inv], offs] = np.arange(ln + 1)
        per_row.append((uniq[order].astype(np.int32), spos))
    pmax = max(len(p) for p, _ in per_row)
    pmax = max(-(-pmax // pad_pages_to) * pad_pages_to, pad_pages_to)
    page_ids = np.zeros((n, pmax), np.int32)
    slot_pos = np.full((n, pmax, page_size), -1, np.int32)
    for i, (p, sp) in enumerate(per_row):
        page_ids[i, :len(p)] = p
        slot_pos[i, :len(p)] = sp
    return page_ids, slot_pos


def pool_for(cfg: LMConfig, page_size: int = 16, n_pages: int = 512,
             device="cuda", mesh=None) -> PagedKVPool:
    """Pool sized from a model config (serving launcher convenience).
    With a `mesh`, one rank's arena: its ``n_kv_heads / tp`` kv heads
    (`sharding.specs.serving_arena_spec`), every page and slot of the
    whole pool, so the host page and slot tables are the same on every
    rank and one logical page id addresses every rank's slice."""
    tp = 1 if mesh is None else mesh.shape["model"]
    return PagedKVPool(cfg.n_layers, cfg.n_kv_heads // tp, cfg.resolved_head_dim,
                       page_size=page_size, n_pages=n_pages, device=device)
