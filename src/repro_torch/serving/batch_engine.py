"""Batched prefill / paged decode over the port's engine — the port of the
JAX package's `serving/batch_engine.py`, with the shared block store
(cross-request KV reuse) and KV migration between engines.

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

* **cross-request reuse** — with a `block_store.SharedBlockStore`, pool
  insertion maps store-resident blocks (user, item and prefix tiers) at
  the store's slots and writes only the private rest; a prefix-tier hit
  also drops the instruction from the recompute set, its rows read from
  the store's arena slots by the block-gather kernel.  No write of a
  request ever lands in a shared slot: mapped positions are skipped by
  the wave write, the chunk writes and the finalize writes, and a mapped
  position Eq. 3 selects for recompute is first moved to a private slot
  (`kv_pool.remap_private`).  Decoded tokens equal those without reuse.

* **migration** — `export_request_kv` snapshots one request (finished,
  or mid-prefill with its live `PrefillState`) as a `RequestKV`; another
  engine's `import_request_kv` installs it without recompute, its store
  blocks resolved by content key (a held key moves no bytes).  On one
  card the private pages move by one gather and one scatter on the device.

* **decode** — one token per running request, K/V read through the
  paged-decode kernel over per-request page views
  (`kv_pool.page_views`): keys are rotated to their positions inside the
  kernel and nothing is gathered.

* **tensor parallelism** — with a `mesh` the engine is one rank of the
  mesh's model axis: its model, cached rows and arena hold the rank's
  heads, and every kernel above runs on them at the shard's shapes
  (`core.engine`).  Page and slot tables are host numpy, alike on every
  rank, so every rank allocates, maps and writes the same slots.

The config's `attn_backend` picks the kernels of prefill (flash, block
gather, selective) or their plain PyTorch versions
(`core.engine.attn_uses_kernels`), and `decode_kernel` the paged-decode
kernel or its plain version, which gathers the pages
(`core.engine.decode_uses_paged`); both are resolved once, when the
engine is built.  ``batched_selective=False`` runs the rcllm prefill one
request at a time, the reference's per-request loop.
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
from repro_torch.kernels.paged_attention.ref import paged_decode_ref
from repro_torch.models import layers as L
from repro_torch.models.transformer import Transformer
from repro_torch.serving import block_store as BS
from repro_torch.serving.kv_pool import (KVExport, PagedKVPool, PoolExhausted, page_views,
                                         pool_for)


@dataclass
class BatchRequest:
    """One prompt for the batched engine.  `plan` and its block table into
    the engine's cached-row pool (`block_table`, `positions`, `have`, see
    `assembly.plan_block_table`) are required for the selective (rcllm)
    path and ignored for full prefill.  `n_reserve` pre-reserves page
    capacity for that many decode tokens.  `reuse` names the request's
    shareable blocks for a store-backed engine; without it the request
    stays fully private."""

    rid: int
    tokens: np.ndarray
    plan: Optional[AssemblyPlan] = None
    block_table: Optional[np.ndarray] = None
    positions: Optional[np.ndarray] = None
    have: Optional[np.ndarray] = None
    n_reserve: int = 0
    reuse: Optional[BS.RequestReuse] = None


@dataclass
class PrefillState:
    """One request's chunk-resumable prefill, engine-side: the request, its
    `engine.ChunkedPrefill`, which logical positions were mapped at store
    slots at admission (`mapped_mask`: skipped by every write, un-shared
    at finalize where Eq. 3 recomputes them), and the store inserts still
    owed once its fresh bytes exist (prefix and user tiers need computed
    KV, so their misses insert at finalize)."""

    req: BatchRequest
    cp: ENG.ChunkedPrefill
    mapped_mask: np.ndarray
    pending_prefix: Optional[tuple] = None
    pending_user: Optional[tuple] = None  # (key, u_pos)
    started: bool = False                 # a chunk has run


@dataclass
class RequestKV:
    """One request's engine-side state as a handoff record, the unit a KV
    migration moves between engines: the pool snapshot (`export`), the
    store blocks the request references (`payloads`, under their content
    keys, so a destination holding a key moves nothing for it), the
    engine stats and, for a chunk-partial handoff, the live
    `PrefillState`.  The serving layer adds the sampling state
    (`session`).  The model is shared by every engine of a cluster."""

    rid: int
    export: KVExport
    held: List[tuple] = field(default_factory=list)  # store keys, with repeats
    payloads: Dict[tuple, BS.BlockPayload] = field(default_factory=dict)
    stats: Optional[ENG.EngineStats] = None
    prefill: Optional[PrefillState] = None
    session: Optional[dict] = None

    @property
    def nbytes(self) -> int:
        """Worst case: the private pages and every store block."""
        return self.export.nbytes + sum(p.nbytes for p in self.payloads.values())


def migration_bytes(rec: RequestKV, store: Optional[BS.SharedBlockStore]) -> int:
    """Bytes an engine holding `store` would move to import `rec`: the
    private pages always, a store payload only when its key misses."""
    moved = rec.export.nbytes
    for key, payload in rec.payloads.items():
        if store is None or not store.resident(key):
            moved += payload.nbytes
    return moved


@dataclass
class StepReport:
    """What one unified `BatchEngine.step` tick executed and charged."""

    decode_logits: Optional[np.ndarray] = None
    finalized: Dict[int, np.ndarray] = field(default_factory=dict)
    chunked: List[int] = field(default_factory=list)
    started: List[int] = field(default_factory=list)  # first chunk this tick
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
                pool: PagedKVPool, paged: bool = True) -> np.ndarray:
    """One decode token per request through the paged arena.

    toks: (N,) last sampled token ids; seq_lens: (N,) tokens resident
    before this step (= the new token's position); new_pages/new_slots:
    (N,) the slot claimed for the new token; page_ids/slot_pos: the page
    view (`kv_pool.page_views`) including that slot; `paged` False runs
    the paged-decode kernel's plain version on any device.  -> logits
    (N, V).

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
    attend = paged_decode_mha if paged else paged_decode_ref
    for layer, lp in enumerate(model.layers):
        h = L.rms_norm(x, lp.attn_norm, cfg.norm_eps)
        q = torch.einsum("nd,dhe->nhe", h, lp.wq)
        k_new = torch.einsum("nd,dhe->nhe", h, lp.wk)             # pre-RoPE
        v_new = torch.einsum("nd,dhe->nhe", h, lp.wv)
        lidx = torch.full_like(pages, layer)
        pool.arena_k.index_put_((pages, slots, lidx), k_new.to(pool.arena_k.dtype))
        pool.arena_v.index_put_((pages, slots, lidx), v_new.to(pool.arena_v.dtype))
        q = L.apply_rope(q[:, None], pos_new[:, None], cfg.rope_theta)[:, 0]
        o = attend(q, pool.arena_k, pool.arena_v, pg_ids, sl_pos, layer=layer,
                   rope_theta=cfg.rope_theta)
        x = ENG._layer_step(x, lp, cfg, o)
    xf = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return model.logits(xf).float().cpu().numpy()


class BatchEngine:
    """Multi-request prefill + paged continuous decode on one device.

    `cache` is the device pool of cached rows that rcllm requests' block
    tables index (`RcLLMSystem.rows`); full prefill needs none.  `store`
    (a `block_store.SharedBlockStore` over this engine's pool) turns on
    cross-request KV reuse for the rcllm path.  `cfg.attn_backend` and
    `cfg.decode_kernel` are resolved here against the model's device
    (`attn_kernels`, `paged`; an invalid pair raises).
    `batched_selective=False` runs the rcllm prefill one request at a
    time (the reference's per-request loop; the same function).  `mesh`:
    the `launch.mesh.Mesh` this engine is a rank of (None: one device);
    the model, `cache` and pool must then hold the rank's kv heads."""

    def __init__(self, model: Transformer, cfg: LMConfig,
                 pool: Optional[PagedKVPool] = None,
                 sel: Optional[ENG.SelectiveConfig] = None,
                 bucket: int = 64, cache: Optional[CacheRows] = None,
                 chunk_tokens: int = 128,
                 store: Optional[BS.SharedBlockStore] = None,
                 batched_selective: bool = True, mesh=None):
        self.model = model
        self.cfg = cfg
        self.mesh = mesh
        self.attn_kernels = ENG.attn_uses_kernels(cfg, model.device)
        self.paged = ENG.decode_uses_paged(cfg, model.device)
        self.batched_selective = batched_selective
        self.pool = pool if pool is not None else pool_for(cfg, device=model.device,
                                                           mesh=mesh)
        tp = 1 if mesh is None else mesh.shape["model"]
        if model.tp != tp:
            raise ValueError(f"the model is split over {model.tp} ranks, the mesh's model "
                             f"axis has {tp}")
        heads = model.layers[0].wk.shape[1]
        for name, got in (("pool", self.pool.arena_k.shape[3]),
                          ("cache", None if cache is None else cache.row_shape[1])):
            if got is not None and got != heads:
                raise ValueError(f"the {name} holds {got} kv heads, the model {heads}: "
                                 "a rank's pool and cached rows hold its own heads "
                                 "(kv_pool.pool_for(mesh=), core.rcllm.make_system(mesh=))")
        self.sel = sel or ENG.SelectiveConfig()
        self.bucket = bucket
        self.cache = cache
        self.chunk_tokens = chunk_tokens
        self.store = store
        self.store_refs: Dict[int, list] = {}
        self.last_stats: Dict[int, ENG.EngineStats] = {}
        self.prefill_states: Dict[int, PrefillState] = {}

    # ------------------------------ prefill --------------------------------
    def prefill(self, reqs: Sequence[BatchRequest], mode: str = "full") -> np.ndarray:
        """Prefill a batch; KV lands in the pool.  -> logits (N, V)."""
        if mode == "full":
            return self._prefill_full(reqs)
        if mode == "rcllm":
            if self.store is not None:
                return self._prefill_selective_shared(reqs)
            return self._prefill_selective_batch(reqs)
        raise ValueError(mode)

    def admission_pages(self, r: BatchRequest) -> tuple:
        """(private-page bound, possible inserts) for one request — the
        batcher's admission accounting under cross-request reuse."""
        return BS.admission_pages(self.pool, self.store, r.plan, r.have, self.sel,
                                  r.reuse, r.n_reserve, bucket=self.bucket)

    def _prefill_full(self, reqs: Sequence[BatchRequest]) -> np.ndarray:
        lens = [len(r.tokens) for r in reqs]
        S = max(self.bucket, -(-max(lens) // self.bucket) * self.bucket)
        toks = np.zeros((len(reqs), S), np.int32)
        for i, r in enumerate(reqs):
            toks[i, : lens[i]] = r.tokens
        last = np.asarray([n - 1 for n in lens], np.int64)
        logits, k, v = ENG.batched_prefill(self.model, toks, last, self.attn_kernels)
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

    def _selective(self, items: Sequence[tuple], shared=None) -> list:
        """`engine.selective_prefill_batch` over `items`: batched, or one
        request at a time without `batched_selective`."""
        run = lambda its: ENG.selective_prefill_batch(
            self.model, self.cfg, its, self.sel, self.cache, bucket=self.bucket,
            shared=shared)
        if self.batched_selective:
            return run(items)
        return [run([it])[0] for it in items]

    def _prefill_selective_batch(self, reqs: Sequence[BatchRequest]) -> np.ndarray:
        """Batched rcllm prefill, then one arena scatter of the merged
        rows for the whole batch."""
        for r in reqs:
            self._check_plan(r)
        results = self._selective([self._item(r) for r in reqs])
        out, entries = [], []
        for r, (logits, stats, k_all, v_all) in zip(reqs, results):
            self.last_stats[r.rid] = stats
            n = r.plan.n
            self.pool.alloc(r.rid, n + r.n_reserve)
            entries.append((r.rid, np.arange(n), k_all, v_all))
            out.append(logits)
        self.pool.write_at_batch(entries)
        return np.stack(out)

    # --------------------------- shared insertion ---------------------------
    def _index(self, positions: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(positions, np.int64)).to(self.pool.device)

    def _rows_at(self, positions: np.ndarray, *rows: torch.Tensor):
        """`rows` at host `positions`: the tensors themselves when the
        positions are all of them in order, else one device gather each."""
        n = rows[0].shape[0]
        if len(positions) == n and np.array_equal(positions, np.arange(n)):
            return rows
        idx = self._index(positions)
        return tuple(t[idx] for t in rows)

    def _item_rows(self, ref: BS.BlockRef):
        """An item block's bytes (t, L, Hkv, Dh) on the device: its rows of
        the pool of cached rows, as views the store's insert copies."""
        rows = slice(ref.row, ref.row + len(ref.tokens))
        return (self.cache.k[:, rows, 0].transpose(0, 1),
                self.cache.v[:, rows, 0].transpose(0, 1))

    def _user_rows(self, r: BatchRequest, u_pos: np.ndarray, k0: torch.Tensor,
                   v0: torch.Tensor):
        """A user block's bytes (u, L, Hkv, Dh) on the device: the fresh
        layer-0 plane at `u_pos` (k0/v0: (n, Hkv, Dh)) and the deep layers
        of the cached rows there (the semantic prototypes)."""
        idx = self._index(u_pos)
        rows = self._index(r.block_table[u_pos])
        return tuple(torch.cat([l0[idx, None].float(), pool[1:, rows, 0].transpose(0, 1)],
                               dim=1)
                     for l0, pool in ((k0, self.cache.k), (v0, self.cache.v)))

    def _prefix_full_key(self, r: BatchRequest):
        """The prefix tier's content key for one request: instruction
        digest + the (n_pad, r_pad) bucket of its original plan shape, so
        hit and miss requests derive the same key."""
        reuse = r.reuse
        if reuse is None or reuse.prefix_key is None or not reuse.prefix_len:
            return None
        return reuse.prefix_key + BS.shape_bucket(r.plan, r.have, self.sel, self.bucket)

    def _inject_prefix(self, r: BatchRequest, blk: BS.StoredBlock):
        """(block table, have) with a prefix-tier hit injected: the first
        positions read the block's arena slots (table entries past the
        cached rows, `engine.cache_gather`) and count as cached, so Eq. 3
        drops them from the recompute set."""
        npfx = min(blk.n_tokens, r.plan.n)
        table, have = r.block_table.copy(), r.have.copy()
        table[:npfx] = self.cache.n_rows + blk.slots[:npfx]
        have[:npfx] = True
        return table, have

    def _prefill_selective_shared(self, reqs: Sequence[BatchRequest]) -> np.ndarray:
        """rcllm prefill against the shared block store.  A prefix-tier
        hit is injected before compute (`_inject_prefix`); every other
        tier leaves the compute as it is, and pool insertion maps
        store-resident blocks instead of writing their bytes."""
        for r in reqs:
            self._check_plan(r)
        store = self.store
        prefix_hits: Dict[int, tuple] = {}
        items_in = []
        for r in reqs:
            table, have = r.block_table, r.have
            key = self._prefix_full_key(r)
            blk = store.get(key) if key is not None else None
            if blk is not None:
                # held until release(rid), recorded through prefix_hits
                blk.refcount += 1
                prefix_hits[r.rid] = (key, blk)
                table, have = self._inject_prefix(r, blk)
            items_in.append((r.plan, table, r.positions, have))
        results = self._selective(items_in, shared=self.pool if prefix_hits else None)
        return self._insert_batch_shared(reqs, results, prefix_hits)

    def _insert_batch_shared(self, reqs, results, prefix_hits) -> np.ndarray:
        """Map store hits, insert missing blocks, write the private rest.

        Phase A takes a reference on every resident block any request of
        the batch will map, before any insert can trigger LRU eviction;
        phase B then, per request, inserts missing blocks (optional, gated
        so the batch's remaining mandatory private pages stay free), maps
        the hit positions that survived recompute selection, allocates the
        private remainder and stages its rows for one write.
        """
        store = self.store
        held: Dict[int, list] = {r.rid: [] for r in reqs}
        blocks: Dict[int, dict] = {r.rid: {} for r in reqs}
        for rid, (key, blk) in prefix_hits.items():
            held[rid].append(key)
            blocks[rid][key] = blk
        # phase A: silent references, batch-wide, before any insert evicts
        for r in reqs:
            reuse = r.reuse if r.reuse is not None else BS.RequestReuse()
            keys = [ref.key for ref in reuse.blocks]
            if reuse.user_key is not None and len(
                    BS.user_reuse_positions(r.plan, r.have, reuse.prefix_end)):
                keys.append(reuse.user_key)
            for key in keys:
                blk = store.get(key)
                if blk is not None:
                    blk.refcount += 1
                    held[r.rid].append(key)
                    blocks[r.rid][key] = blk
        # private pages still owed to unprocessed batch members: optional
        # inserts must never eat into them
        bounds = {r.rid: self.admission_pages(r)[0] for r in reqs}
        remaining = sum(bounds.values())
        out, entries = [], []
        for r, (logits, stats, k_all, v_all) in zip(reqs, results):
            self.last_stats[r.rid] = stats
            n = r.plan.n
            rec = stats.recompute_mask
            reuse = r.reuse if r.reuse is not None else BS.RequestReuse()
            pos_parts, slot_parts = [], []
            # --- prefix tier: the instruction's recomputed rows, pinned ---
            key = self._prefix_full_key(r)
            if key is not None:
                if r.rid in prefix_hits:
                    pblk = prefix_hits[r.rid][1]
                    store.count_hit(pblk)
                else:
                    pblk = store.acquire(key)
                    if pblk is not None:
                        held[r.rid].append(key)
                    else:
                        # this request recomputed the rows: they become the
                        # shared block
                        npfx = min(reuse.prefix_len, n)
                        pblk = store.insert(key, BS.PREFIX_TIER, k_all[:npfx],
                                            v_all[:npfx], pinned=True,
                                            keep_free=remaining, defer_write=True)
                        if pblk is not None:
                            pblk.refcount += 1
                            held[r.rid].append(key)
                if pblk is not None:
                    npfx = min(pblk.n_tokens, n)
                    pos_parts.append(np.arange(npfx))
                    slot_parts.append(pblk.slots[:npfx])
            # --- item tier: offline block bytes, LRU-evictable ---
            for ref in reuse.blocks:
                blk = blocks[r.rid].get(ref.key)
                if blk is not None:
                    store.count_hit(blk)
                else:
                    # an earlier request of this batch may have inserted it
                    blk = store.acquire(ref.key)
                    if blk is not None:
                        held[r.rid].append(ref.key)
                    elif ref.row >= 0:
                        blk = store.insert(ref.key, BS.ITEM_TIER, *self._item_rows(ref),
                                           tokens=ref.tokens, keep_free=remaining,
                                           defer_write=True)
                        if blk is not None:
                            blk.refcount += 1
                            held[r.rid].append(ref.key)
                if blk is None:
                    continue
                use = ~rec[ref.positions]
                pos_parts.append(ref.positions[use])
                slot_parts.append(blk.slots[ref.offsets[use]])
            # --- user tier: fresh layer-0 + semantic deep layers, pinned ---
            u_pos = None
            if reuse.user_key is not None:
                u_pos = BS.user_reuse_positions(r.plan, r.have, reuse.prefix_end)
            if u_pos is not None and len(u_pos):
                ublk = blocks[r.rid].get(reuse.user_key)
                if ublk is not None:
                    store.count_hit(ublk)
                else:
                    ublk = store.acquire(reuse.user_key)
                    if ublk is not None:
                        held[r.rid].append(reuse.user_key)
                    else:
                        ublk = store.insert(
                            reuse.user_key, BS.USER_TIER,
                            *self._user_rows(r, u_pos, k_all[:, 0], v_all[:, 0]),
                            positions=u_pos, pinned=True, keep_free=remaining,
                            defer_write=True)
                        if ublk is not None:
                            ublk.refcount += 1
                            held[r.rid].append(reuse.user_key)
                if ublk is not None:
                    common = np.intersect1d(u_pos, ublk.positions)
                    common = common[~rec[common]]
                    pos_parts.append(common)
                    slot_parts.append(ublk.slots[np.searchsorted(ublk.positions, common)])
            mapped_pos, mapped_slots = _concat(pos_parts), _concat(slot_parts)
            cap = self.pool.pages_for(n + r.n_reserve) * self.pool.page_size
            need = -(-(cap - len(mapped_pos)) // self.pool.page_size)
            if self.pool.free_pages < need:
                store.evict_for(need)
            self.pool.alloc_mapped(r.rid, n + r.n_reserve, mapped_pos, mapped_slots)
            remaining -= bounds[r.rid]
            self.store_refs[r.rid] = held[r.rid]
            mapped = np.zeros(n, bool)
            mapped[mapped_pos] = True
            keep = np.where(~mapped)[0]
            entries.append((r.rid, keep, *self._rows_at(keep, k_all, v_all)))
            out.append(logits)
        store.flush_writes()
        self.pool.write_at_batch(entries)
        return np.stack(out)

    # ------------------------ chunk-resumable prefill ------------------------
    def begin_prefill(self, r: BatchRequest) -> None:
        """Admit one request into chunk-resumable prefill.

        Resolves the shared block store now (a prefix-tier hit is injected
        before any compute, as on the wave path; item and user hits map
        their positions at store slots) and claims the request's full
        admission-bound private pages up front, so neither the chunk
        writes nor the finalize remap can hit `PoolExhausted` mid-prefill.
        """
        self._check_plan(r)
        if r.rid in self.prefill_states:
            raise KeyError(f"request {r.rid} already prefilling")
        n = r.plan.n
        table, have = r.block_table, r.have
        store = self.store
        held: List = []
        pos_parts, slot_parts = [], []
        pending_prefix = pending_user = None
        shared = None
        if store is not None:
            reuse = r.reuse if r.reuse is not None else BS.RequestReuse()
            # --- prefix tier: inject a hit before compute ---
            key = self._prefix_full_key(r)
            if key is not None:
                pblk = store.acquire(key)
                if pblk is not None:
                    held.append(key)
                    table, have = self._inject_prefix(r, pblk)
                    shared = self.pool
                    npfx = min(pblk.n_tokens, n)
                    pos_parts.append(np.arange(npfx))
                    slot_parts.append(pblk.slots[:npfx])
                else:
                    pending_prefix = key
            # --- item tier: the offline bytes exist now, so misses insert
            # at admission and later arrivals hit them
            for ref in reuse.blocks:
                blk = store.acquire(ref.key)
                if blk is None and ref.row >= 0:
                    blk = store.insert(ref.key, BS.ITEM_TIER, *self._item_rows(ref),
                                       tokens=ref.tokens, defer_write=True)
                    if blk is not None:
                        blk.refcount += 1
                if blk is not None:
                    held.append(ref.key)
                    pos_parts.append(ref.positions)
                    slot_parts.append(blk.slots[ref.offsets])
            # --- user tier (fresh bytes needed: a miss inserts at finalize)
            if reuse.user_key is not None:
                u_pos = BS.user_reuse_positions(r.plan, r.have, reuse.prefix_end)
                if len(u_pos):
                    ublk = store.acquire(reuse.user_key)
                    if ublk is not None:
                        held.append(reuse.user_key)
                        common = np.intersect1d(u_pos, ublk.positions)
                        pos_parts.append(common)
                        slot_parts.append(
                            ublk.slots[np.searchsorted(ublk.positions, common)])
                    else:
                        pending_user = (reuse.user_key, u_pos)
        mapped_pos, mapped_slots = _concat(pos_parts), _concat(slot_parts)
        # claim the full admission bound: the pages needed now plus spare
        # headroom covering the worst-case finalize remap
        bound, _ = self.admission_pages(r)
        total_slots = self.pool.pages_for(n + r.n_reserve) * self.pool.page_size
        begin_need = -(-max(total_slots - len(mapped_pos), 0) // self.pool.page_size)
        extra = max(bound - begin_need, 0)
        if store is not None and self.pool.free_pages < begin_need + extra:
            store.evict_for(begin_need + extra)
        try:
            self.pool.alloc_mapped(r.rid, n + r.n_reserve, mapped_pos, mapped_slots,
                                   extra_pages=extra)
        except PoolExhausted:
            if store is not None:
                store.release_all(held)
            raise
        if store is not None:
            self.store_refs[r.rid] = held
        mapped_mask = np.zeros(n, bool)
        mapped_mask[mapped_pos[mapped_pos < n]] = True
        cp = ENG.ChunkedPrefill(
            self.model, self.cfg, r.plan, table, r.positions, have, self.cache,
            self.sel, chunk_tokens=self.chunk_tokens, bucket=self.bucket, shared=shared)
        self.prefill_states[r.rid] = PrefillState(
            req=r, cp=cp, mapped_mask=mapped_mask, pending_prefix=pending_prefix,
            pending_user=pending_user)

    def abort_prefill(self, rid: int) -> None:
        """Roll back a mid-prefill preemption: drop the chunk state and
        release the pages and store references.  The caller keeps the
        plan, so the victim can re-prefill from scratch (greedy decode
        regenerates the same tokens)."""
        self.prefill_states.pop(rid, None)
        self.release(rid)

    # ------------------------------ migration ------------------------------
    def export_request_kv(self, rid: int) -> RequestKV:
        """Snapshot one request (finished or mid-prefill) as a `RequestKV`.
        Read-only: the caller evacuates the request here only after the
        destination's import succeeded."""
        held = list(self.store_refs.get(rid, []))
        payloads: Dict[tuple, BS.BlockPayload] = {}
        if self.store is not None:
            for key in held:
                if key not in payloads:
                    payload = self.store.export_payload(key)
                    if payload is not None:
                        payloads[key] = payload
        return RequestKV(rid=rid, export=self.pool.export_request(rid), held=held,
                         payloads=payloads, stats=self.last_stats.get(rid),
                         prefill=self.prefill_states.get(rid))

    def import_request_kv(self, rec: RequestKV) -> Dict[str, int]:
        """Install a migrated request in this engine without recompute.

        Store payloads resolve first: a held key is a digest hit (no bytes
        move), a miss inserts under the original key, a budget refusal
        writes the rows the request references into fresh private pages.
        That builds the source-slot -> destination-slot map the pool import
        needs.  Transactional: `PoolExhausted` anywhere releases every page
        and store reference this call took.  A chunk-partial handoff's
        prefill state is rebound to this engine's arena.
        -> counters: pages and bytes moved, digest hits."""
        rid, export = rec.rid, rec.export
        store = self.store
        fmap: Dict[int, int] = {}
        held_new: List[tuple] = []
        raw_pages: List[int] = []
        refused: Dict[tuple, BS.BlockPayload] = {}
        counters = {"pages": export.n_pages, "bytes": export.nbytes, "digest_hits": 0}
        foreign = set(int(s) for s in export.foreign_slots[export.owner_page < 0])
        priv_old: set = set()
        try:
            if store is not None:
                seen: set = set()
                for key in rec.held:
                    payload = rec.payloads.get(key)
                    if payload is None or key in refused:
                        continue
                    blk, hit = store.import_payload(payload, keep_free=export.n_pages)
                    if blk is None:
                        refused[key] = payload
                        continue
                    held_new.append(key)
                    if key in seen:
                        continue
                    seen.add(key)
                    if hit:
                        counters["digest_hits"] += 1
                    else:
                        counters["bytes"] += payload.nbytes
                    fmap.update(zip(payload.slots.tolist(), blk.slots.tolist()))
                # refused payloads: the rows the slot table references go to
                # fresh pages the request owns (their bytes travel as a miss)
                for payload in refused.values():
                    rows = [i for i, sl in enumerate(payload.slots.tolist())
                            if sl in foreign and sl not in fmap]
                    if not rows:
                        continue
                    pages = self.pool.alloc_pages(self.pool.pages_for(len(rows)))
                    raw_pages.extend(pages)
                    slots = self.pool.page_slots(pages)[:len(rows)]
                    for i, sl in zip(rows, slots.tolist()):
                        fmap[int(payload.slots[i])] = sl
                        priv_old.add(int(payload.slots[i]))
                    idx = torch.as_tensor(rows, device=payload.k.device)
                    k, v = payload.k[idx], payload.v[idx]
                    self.pool.write_slots(slots, k, v)
                    counters["bytes"] += BS._nbytes(k, v)
                    counters["pages"] += len(pages)
            self.pool.import_request(export, fmap)
        except PoolExhausted:
            if raw_pages:
                self.pool.release_pages(raw_pages)
            if store is not None:
                store.release_all(held_new)
            raise
        if raw_pages:
            self.pool.page_tables[rid].extend(raw_pages)
        if store is not None:
            self.store_refs[rid] = held_new
            store.flush_writes()
        if rec.stats is not None:
            self.last_stats[rid] = rec.stats
        if rec.prefill is not None:
            st = rec.prefill
            if priv_old:
                # privatized positions are no longer store-mapped: finalize
                # writes them instead of remapping
                for pos in np.where(export.owner_page < 0)[0]:
                    if int(export.foreign_slots[pos]) in priv_old and pos < len(st.mapped_mask):
                        st.mapped_mask[pos] = False
            if st.cp.shared is not None:
                # a prefix hit read the source's arena slots: read the
                # same bytes at their slots here
                table = st.cp.table.copy()
                n_rows = self.cache.n_rows
                sh = np.where(table >= n_rows)[0]
                table[sh] = [n_rows + fmap[int(t) - n_rows] for t in table[sh]]
                st.cp.rebind(table, self.pool)
            self.prefill_states[rid] = st
        return counters

    def _finalize_store(self, st: PrefillState, k0, v0, k_rest, v_rest,
                        rec: np.ndarray) -> np.ndarray:
        """Store bookkeeping for one finalizing request: insert the tiers
        whose keys missed at admission, then un-share every mapped position
        Eq. 3 selected for recompute (its fresh KV must land privately:
        writing through the shared slot would corrupt the store's block).
        k0/v0: (n, Hkv, Dh) fresh layer 0; k_rest/v_rest: (n_pad, L-1,
        Hkv, Dh).  -> remapped positions."""
        store, r = self.store, st.req
        n = st.cp.n
        reuse = r.reuse if r.reuse is not None else BS.RequestReuse()
        held = self.store_refs.setdefault(r.rid, [])
        if st.pending_prefix is not None:
            npfx = min(reuse.prefix_len, n)
            rows = [torch.cat([l0[:npfx, None].float(), deep[:npfx]], dim=1)
                    for l0, deep in ((k0, k_rest), (v0, v_rest))]
            pblk = store.insert(st.pending_prefix, BS.PREFIX_TIER, *rows, pinned=True,
                                defer_write=True)
            if pblk is not None:
                pblk.refcount += 1
                held.append(st.pending_prefix)
        if st.pending_user is not None:
            ukey, u_pos = st.pending_user
            ublk = store.insert(ukey, BS.USER_TIER, *self._user_rows(r, u_pos, k0, v0),
                                positions=u_pos, pinned=True, defer_write=True)
            if ublk is not None:
                ublk.refcount += 1
                held.append(ukey)
        remap = np.where(st.mapped_mask & rec)[0]
        self.pool.remap_private(r.rid, remap)
        st.mapped_mask[remap] = False
        return remap

    def finalize_prefill(self, rids: Sequence[int]) -> Dict[int, np.ndarray]:
        """Selective layers + pool insertion for fully-scanned requests:
        one bucketed dispatch (`engine.selective_layers_batch`, as the
        wave path), then one deep-layer pool write for the whole batch;
        the layer-0 plane already landed as chunks completed (positions
        un-shared here get theirs now)."""
        states = [self.prefill_states[rid] for rid in rids]
        shared = self.pool if any(st.cp.shared is not None for st in states) else None
        sel_out = ENG.selective_layers_batch(
            self.model, self.cfg, [st.cp.sel_item() for st in states], self.cache,
            shared=shared)
        out: Dict[int, np.ndarray] = {}
        entries_deep, entries_l0 = [], []
        for st, (logits, k_rest, v_rest) in zip(states, sel_out):
            r, cp = st.req, st.cp
            self.last_stats[r.rid] = cp.stats
            if self.store is not None:
                k0, v0 = cp.k0_full(), cp.v0_full()
                remap = self._finalize_store(st, k0, v0, k_rest, v_rest,
                                             cp.stats.recompute_mask)
                if len(remap):
                    entries_l0.append((r.rid, remap, *self._rows_at(remap, k0, v0)))
            keep = np.where(~st.mapped_mask)[0]
            entries_deep.append((r.rid, keep,
                                 *self._rows_at(keep, k_rest[:cp.n], v_rest[:cp.n])))
            out[r.rid] = logits
            del self.prefill_states[r.rid]
        if self.store is not None:
            self.store.flush_writes()
        self.pool.write_at_batch(entries_deep, deep=True)
        self.pool.write_at_batch(entries_l0, layer=0)
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
        if self.store is not None:
            # promote the router's hinted spill blocks (a no-op unless
            # prefetch_pages_per_tick > 0), then land every deferred insert
            self.store.prefetch()
            self.store.flush_writes()
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
                keep = ~st.mapped_mask[positions]
                if not keep.all():    # never write into a store-shared slot
                    positions, (k0, v0) = positions[keep], self._rows_at(
                        np.where(keep)[0], k0, v0)
                l0_entries.append((rid, positions, k0, v0))
                rep.charge_chunks += c
                left -= c
                packed = True
                progress = True
                if not st.started:
                    st.started = True
                    rep.started.append(rid)
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
                           pages, slots, pg_ids, sl_pos, self.pool, self.paged)

    def release(self, rid: int) -> None:
        """Free a request's private pages and drop its shared-block
        references.  Idempotent."""
        self.pool.free(rid)
        if self.store is not None:
            self.store.release_all(self.store_refs.pop(rid, []))
        self.last_stats.pop(rid, None)


def _concat(parts: List[np.ndarray]) -> np.ndarray:
    return (np.concatenate(parts).astype(np.int64) if parts
            else np.zeros(0, np.int64))
