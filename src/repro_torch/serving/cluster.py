"""Multi-instance serving: K engine workers over sharded item caches on
one card — the port of the JAX package's `serving/cluster.py`.

`ClusterEngine` builds K `serving.batch_engine.BatchEngine` workers, each
with its own paged pool, block store, continuous-batching queue and
clock, and its own Algorithm-1 item-cache shard (hot items replicated
everywhere, long-tail items on their shard only), behind the Eq. 2
affinity scheduler, which dispatches every arrival on the placement map
and the workers' live backlog.

Residency is enforced through `core.item_cache.ShardClient`: a request
routed to a worker whose shard lacks one of its item blocks pulls the
block from its holder, which records a `TransferRecord`, and the worker's
clock is billed the modelled network time (`cost_model.fetch_time_s`
over the configured `Hardware`, the paper's 100 Gbps interconnect).  All
workers share one card and one pool of cached rows, so without a mesh a
pull copies nothing: the billing is modelled, never measured.  Routing changes
*where* a request runs and what it is billed, never *what* it decodes.

With ``config.disagg`` the workers are typed prefill or decode: a prefill
worker hands each finished (or, under pool pressure, chunk-partial)
prefill to a decode worker, and the request's KV migrates between the
two pools (`BatchEngine.export_request_kv` / `import_request_kv`), its
store blocks by content key.  The migration is billed like a pull.

Every worker serves the same `Transformer` object and reads the same
cached rows; the workers step in turn on the default stream, and each
worker's clock adds only its own step seconds, so the cluster models K
instances running side by side.

With ``config.mesh`` each rank of the mesh runs this cluster over its
shard of the system (`core.rcllm.make_system(mesh=)`): every worker is a
tensor-parallel engine on the rank's heads, and the workers get home devices
(`worker_devices`: the rank's device, which they share).  A cross-shard
pull then stages the block on its holder's home device and copies it to
the worker's, and a migration copies what travels between the two home
devices: both are billed at their MEASURED seconds
(`core.item_cache.measured_copy_s`) instead of the modelled network time,
as the reference bills them.  A rank's workers share its one device, so
these copies stay within one device's memory and cross no link: their
microseconds are not the paper's 100 Gbps transfers, and a TTFT billed
so is not comparable with the modelled one.  The report says where the
copies ran (`transfer_copies`).
Dispatch runs on the host, and every host value that could differ
between the ranks (a measured step or copy) is rank 0's
(`sharding.ctx.decide`), so every rank dispatches, batches and migrates
alike.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import assembly as ASM
from repro_torch.core import cost_model as CM
from repro_torch.core import engine as ENG
from repro_torch.core import item_cache as IC
from repro_torch.core import scheduler as SCH
from repro_torch.data import synth as SY
from repro_torch.serving import api as API
from repro_torch.serving import workload as WL
from repro_torch.serving.batch_engine import migration_bytes
from repro_torch.serving.batching import (ClusterBatcher, Completion, DecodeEntry,
                                          PendingRequest, TorchEngineBackend, WorkerState)
from repro_torch.serving.block_store import dequantize_rows, quantize_rows
from repro_torch.serving.kv_pool import PoolExhausted
from repro_torch.sharding import ctx as CTX


class ClusterWorkerBackend(TorchEngineBackend):
    """`TorchEngineBackend` plus the item-block transfer step and the
    migration ledger.  A request whose plan needs blocks this worker's
    shard lacks owes their modelled transfer time, billed in the step
    its prefill starts."""

    def __init__(self, engine, shard: Optional[IC.ShardClient] = None,
                 mode: str = "rcllm", hw: CM.Hardware = CM.H100_SXM):
        super().__init__(engine, mode=mode, plans={})
        self.shard = shard
        self.hw = hw
        self.pending_transfer_s: Dict[int, float] = {}  # rid -> seconds owed
        self.transfer_seconds = 0.0
        # cross-shard pulls skipped because this worker's block store
        # already held the item's bytes
        self.transfers_avoided = 0
        # migrations this worker received, what moved and what was billed
        self.migrations_in = 0
        self.migrated_pages = 0
        self.migration_bytes = 0
        self.migration_seconds = 0.0
        self.migration_digest_hits = 0

    def prefill(self, batch: Sequence[PendingRequest]) -> float:
        dt = super().prefill(batch)
        moved = sum(self.pending_transfer_s.pop(r.rid, 0.0) for r in batch)
        self.transfer_seconds += moved
        return dt + moved

    def step(self, budget, decode_batch, prefill_queue):
        """Chunked discipline: a request's owed transfer is billed in the
        tick its first chunk runs (the bytes must be there before layer 0
        reads them)."""
        rep, dt = super().step(budget, decode_batch, prefill_queue)
        moved = sum(self.pending_transfer_s.pop(rid, 0.0) for rid in rep.started)
        self.transfer_seconds += moved
        return rep, dt + moved

    def finish(self, req: PendingRequest) -> None:
        # the cluster binds each plan once, at dispatch: drop it with the
        # request, or a long run keeps every request's tables alive
        super().finish(req)
        self.plans.pop(req.rid, None)
        self.reuse.pop(req.rid, None)
        self.pending_transfer_s.pop(req.rid, None)

    def evacuate(self, rid: int) -> None:
        super().evacuate(rid)
        self.pending_transfer_s.pop(rid, None)


@dataclass
class WorkerReport:
    worker: int
    n_requests: int
    mean_hit_rate: Optional[float]   # None when no request ran here
    transfer_blocks: int
    transfer_tokens: int
    transfer_bytes: int
    transfer_seconds: float
    pool_peak_pages: int
    busy_seconds: float
    preempted: int = 0
    # block-store stats with the tier hit rates and transfers avoided
    # (None without kv_reuse)
    kv_reuse: Optional[dict] = None
    # disaggregation: migrations received (decode role) / handed off
    # (prefill role), and what they moved and were billed
    migrations: int = 0
    migrated_out: int = 0
    migrated_pages: int = 0
    migration_bytes: int = 0
    migration_s: float = 0.0
    migration_digest_hits: int = 0
    # tiered store occupancy and traffic (zero without kv_reuse)
    device_blocks: int = 0
    spill_blocks: int = 0
    spill_hits: int = 0
    prefetch_promotions: int = 0
    dequant_s: float = 0.0


@dataclass
class ClusterReport:
    """What one cluster run produced, per request and per worker."""

    completions: List[Completion]
    assigned: Dict[int, int]         # rid -> worker
    hit_rate: Dict[int, float]       # rid -> item-cache hit rate on its worker
    generated: Dict[int, List[int]]  # rid -> decoded tokens
    workers: List[WorkerReport]
    policy: str

    def ttft(self) -> np.ndarray:
        done = sorted(self.completions, key=lambda c: c.rid)
        return np.asarray([c.first_token_s - c.arrival_s for c in done])

    def mean_hit_rate(self) -> float:
        return float(np.mean(list(self.hit_rate.values())))

    def summary(self) -> dict:
        """The run in the reference's summary keys: policy, requests, mean
        hit rate, TTFT p50 / p90 / mean, and the cross-shard transfers
        summed over workers (blocks, MB, billed seconds)."""
        ttft = self.ttft()
        return {
            "policy": self.policy,
            "requests": len(self.completions),
            "mean_hit_rate": round(self.mean_hit_rate(), 4),
            "ttft_p50_s": float(np.percentile(ttft, 50)),
            "ttft_p90_s": float(np.percentile(ttft, 90)),
            "ttft_mean_s": float(ttft.mean()),
            "transfer_blocks": sum(w.transfer_blocks for w in self.workers),
            "transfer_mbytes": round(sum(w.transfer_bytes for w in self.workers) / 1e6, 3),
            "transfer_seconds": round(sum(w.transfer_seconds for w in self.workers), 6),
        }


def dequantized_item_rows(system):
    """The system's cached rows with, appended, the int8 round trip
    (`quantize_rows` then `dequantize_rows`) of every item block's rows:
    the bytes an int8 block store holds for an item.  -> (rows, {item:
    first row of its round-tripped copy})."""
    blocks = {}
    for shard in system.item_store.shards:
        blocks.update(shard.blocks)
    rows = system.rows
    first, idx, n = {}, [], rows.n_rows
    for it in sorted(blocks):
        blk = blocks[it]
        first[it] = n
        idx.append(np.arange(blk.row, blk.row + len(blk.tokens)))
        n += len(blk.tokens)
    sel = torch.from_numpy(np.concatenate(idx)).to(rows.k.device)
    mk, mv = (dequantize_rows(*quantize_rows(pool.index_select(1, sel)))
              for pool in (rows.k, rows.v))
    return rows.with_rows(mk, mv), first


class ClusterEngine:
    """K engine workers behind the Eq. 2 affinity dispatcher.

    `system` is an `RcLLMSystem` whose placement was built with
    ``k_instances == config.k``; worker w serves placement shard w.
    ``config.mode`` picks the prefill path ("rcllm" beyond-prefix
    selective, or "full" recompute, which never reads the item cache).
    `hw` prices the transfers and migrations that one card does not make
    (default: the H100's published rates)."""

    def __init__(self, system, config: API.ServeConfig, *,
                 sel: Optional[ENG.SelectiveConfig] = None,
                 hw: CM.Hardware = CM.H100_SXM, seed: int = 0,
                 alpha: float = 0.7, beta: float = 0.3):
        k, mode = config.k, config.mode
        if system.placement.k != k:
            raise ValueError(f"placement has {system.placement.k} shards, cluster wants "
                             f"{k} workers: rebuild the system with k_instances={k}")
        if mode == "rcllm" and system.item_store is None:
            raise ValueError("mode='rcllm' needs the system's item store (the sharded "
                             "item-KV pool); build the system with one, or use mode='full'")
        self.system = system
        self.config = config
        self.k = k
        self.mode = mode
        self.hw = hw
        self._item_keys: Dict[int, tuple] = {}
        # an int8 store holds an item's round-tripped bytes, and a request
        # staged from the store computes on those (as the reference does)
        self.cache, self._dequant_row = system.rows, {}
        if config.kv_reuse and config.store.kv_store_dtype == "int8":
            self.cache, self._dequant_row = dequantized_item_rows(system)
        # under a mesh each worker has a home device (the rank's: its
        # workers share it): pulls and migrations are measured copies
        self.worker_devices = ([system.model.device] * k if config.mesh.enabled
                               else None)
        self.transfer_copies = (None if self.worker_devices is None else
                                "same device" if len(set(self.worker_devices)) == 1
                                else "across devices")
        self.backends: List[ClusterWorkerBackend] = []
        for w in range(k):
            engine = API.build_engine(system.model, system.cfg, config, sel=sel,
                                      cache=self.cache)
            shard = (IC.ShardClient(system.item_store, w, devices=self.worker_devices)
                     if system.item_store is not None else None)
            self.backends.append(ClusterWorkerBackend(engine, shard, mode=mode, hw=hw))
        self.scheduler = SCH.ClusterScheduler(system.placement, policy=config.policy,
                                              alpha=alpha, beta=beta, seed=seed)
        self.batcher = ClusterBatcher(
            self.backends, dispatch=self._dispatch,
            max_batch_tokens=config.max_batch_tokens,
            max_decode_batch=config.max_decode_batch, sched=config.sched,
            chunk_tokens=config.chunk_tokens, step_tokens=config.step_tokens)
        # disaggregation: type the workers, admit on the prefill side and
        # hook migration into the prefill workers
        self.disagg = config.disagg
        self._prefill_ids = list(range(k))
        self._decode_ids: List[int] = []
        if self.disagg.enabled:
            self._prefill_ids = [w for w in range(k) if self.disagg.role_of(w) == "prefill"]
            self._decode_ids = [w for w in range(k) if self.disagg.role_of(w) == "decode"]
            for w, worker in enumerate(self.batcher.workers):
                worker.role = self.disagg.role_of(w)
                if worker.role == "prefill":
                    worker.migrate = self._migrate
        self._trace_by_rid: Dict[int, object] = {}
        self.assigned: Dict[int, int] = {}
        self.hit_rate: Dict[int, float] = {}

    # ------------------------------ dispatch ------------------------------
    def _dispatch(self, req: PendingRequest, t: float, workers: List[WorkerState]) -> int:
        rq = self._trace_by_rid[req.rid]
        if self.disagg.enabled:
            wid = self._dispatch_prefill(rq, t, workers)
        else:
            wid = self.scheduler.dispatch(rq.candidate_items,
                                          [w.backlog_seconds(t) for w in workers])
        CTX.check("dispatch", (req.rid, t, wid))
        self._bind(req, rq, wid)
        return wid

    def _score(self, rq, depths: np.ndarray, inds: List[int]) -> np.ndarray:
        """Eq. 2 (or the configured single objective) over `inds`."""
        sch = self.scheduler
        hi = depths.max()
        load = depths / hi if hi > 0 else np.zeros_like(depths)
        hits = SCH.hit_vector(np.asarray(rq.candidate_items), self.system.placement)[inds]
        if sch.policy == "hit_only":
            return hits - 1e-9 * load
        if sch.policy == "load_only":
            return -load
        return sch.alpha * hits + sch.beta * (1.0 - load)

    def _dispatch_prefill(self, rq, t: float, workers: List[WorkerState]) -> int:
        """Admission under disaggregation: the policy over the prefill
        workers only (decode workers take requests through migration)."""
        inds = self._prefill_ids
        sch = self.scheduler
        if sch.policy == "round_robin":
            wid = inds[sch.state.rr_next % len(inds)]
            sch.state.rr_next += 1
            return wid
        if sch.policy == "random":
            return int(sch.rng.choice(inds))
        depths = np.asarray([workers[w].backlog_seconds(t) for w in inds], float)
        if sch.policy == "least_loaded":
            return inds[int(np.argmin(depths))]
        return inds[int(np.argmax(self._score(rq, depths, inds)))]

    # ------------------------------ migration ------------------------------
    def _migrate(self, src: WorkerState, entry: DecodeEntry, admitted_s: float) -> bool:
        """Hand one prefill from `src` to a decode worker.

        The destination's score is Eq. 2 plus a migration-byte term,
        ``mig_gamma * (1 - bytes / max bytes)``, where bytes are what each
        candidate would really move (`batch_engine.migration_bytes`: a
        store already holding a payload's key moves nothing for it).
        Candidates are tried best first; `PoolExhausted` on import rolls
        back and falls through to the next.  False when none can take the
        request: it then decodes where it was prefilled."""
        rid = entry.req.rid
        src_backend = self.backends[src.wid]
        rec = src_backend.export_request_kv(rid)
        rq = self._trace_by_rid[rid]
        inds = self._decode_ids
        depths = np.asarray([self.batcher.workers[w].backlog_seconds(src.clock)
                             for w in inds], float)
        nbytes = np.asarray([float(migration_bytes(rec, self.backends[w].engine.store))
                             for w in inds])
        bmax = nbytes.max()
        bnorm = nbytes / bmax if bmax > 0 else np.zeros_like(nbytes)
        sch = self.scheduler
        hi = depths.max()
        load = depths / hi if hi > 0 else np.zeros_like(depths)
        hits = SCH.hit_vector(np.asarray(rq.candidate_items), self.system.placement)[inds]
        score = (sch.alpha * hits + sch.beta * (1.0 - load)
                 + self.disagg.mig_gamma * (1.0 - bnorm))
        for i in sorted(range(len(inds)), key=lambda i: (-score[i], inds[i])):
            wid = inds[i]
            dst = self.backends[wid]
            # what would travel, snapshotted BEFORE the import inserts the
            # missed payloads into the destination store
            store_d = dst.engine.store
            moved = [rec.export.page_k, rec.export.page_v]
            for key, payload in rec.payloads.items():
                if store_d is None or not store_d.resident(key):
                    moved += [payload.k, payload.v]
            try:
                counters = dst.import_request_kv(rec)
            except PoolExhausted:
                continue
            mig_s = self._migration_seconds(moved, wid, counters)
            dst.migrations_in += 1
            dst.migrated_pages += counters["pages"]
            dst.migration_bytes += counters["bytes"]
            dst.migration_seconds += mig_s
            dst.migration_digest_hits += counters["digest_hits"]
            self.batcher.workers[wid].receive_migration(
                entry, src.clock + mig_s, admitted_s, prefilling=rec.prefill is not None)
            src_backend.evacuate(rid)
            return True
        return False

    def _migration_seconds(self, moved: List[torch.Tensor], dst_wid: int,
                           counters: Dict) -> float:
        """One migration's billed seconds: under a mesh, the measured copy
        of what travels (`moved`) onto the destination worker's home
        device (rank 0's measurement); otherwise the modelled network time
        of the bytes it moved.  Digest-hit payloads never travel."""
        if counters["bytes"] == 0:
            return 0.0
        if self.worker_devices is not None:
            return CTX.decide(IC.measured_copy_s([t for t in moved if t.numel()],
                                                 self.worker_devices[dst_wid]))
        cfg = self.system.cfg
        row_bytes = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.resolved_head_dim * 4
        moved_tokens = int(np.ceil(counters["bytes"] / row_bytes))
        return CM.fetch_time_s(cfg, self.hw, 0, moved_tokens)

    def _item_key(self, item: int) -> tuple:
        """Memoized content key of one catalog item's block (SEP + item
        text, as the offline build derives it)."""
        it = int(item)
        key = self._item_keys.get(it)
        if key is None:
            doc = np.concatenate([[SY.ITEM_SEP], self.system.catalog.item_tokens[it]])
            key = WL.item_block_key(doc.astype(np.int64))
            self._item_keys[it] = key
        return key

    def _bind(self, req: PendingRequest, rq, wid: int) -> None:
        """Build the request's plan for its worker, stage its item blocks
        against that worker's shard (recording transfers) and hand plan,
        block table and reuse metadata to the worker's backend.

        With kv_reuse on, staging asks the worker's block store first: an
        item the store holds (either tier) is staged from the store's bytes
        and, if not resident on the shard, its pull is skipped (it was paid
        when the block first entered the store).  With a spill tier, the
        request's item keys are hinted to the store now."""
        system = self.system
        backend = self.backends[wid]
        plan = system.plan_for(rq, wid)
        req.tokens = plan.tokens
        req.n_tokens = plan.n
        self.assigned[req.rid] = wid
        n_item = plan.n_local + plan.n_remote + plan.n_miss
        self.hit_rate[req.rid] = plan.n_local / max(n_item, 1)
        if self.mode != "rcllm":
            return
        items = np.unique(plan.block_item[plan.source == ASM.FROM_ITEM])
        store = backend.engine.store
        staged: Dict[int, IC.ItemBlock] = {}
        to_stage, hint_keys = [], []
        for it in items:
            it = int(it)
            stored = None     # the item's block, when the store holds its bytes
            if store is not None:
                key = self._item_key(it)
                if store.spill_cap > 0:
                    hint_keys.append(key)
                if store.peek(key) is not None or store.spill_peek(key) is not None:
                    stored = system.item_store.get_block(it, wid)
            if stored is not None:
                # the store's bytes: the rows themselves (fp32), or their
                # int8 round trip
                row = self._dequant_row.get(it, stored.row)
                staged[it] = dataclasses.replace(stored, row=row)
                if not backend.shard.resident(it):
                    backend.transfers_avoided += 1
            else:
                to_stage.append(it)
        if hint_keys:
            store.hint(hint_keys)
        pulled, moved_tokens = backend.shard.stage(to_stage)
        staged.update(pulled)
        table, positions, have = ASM.plan_block_table(plan, IC.StagedBlocks(staged),
                                                      system.semantic, wid)
        backend.plans[req.rid] = (plan, table, positions, have)
        if store is not None:
            backend.reuse[req.rid] = WL.build_request_reuse(
                plan, have, staged, WL.user_prefix_key(system.instruction, rq),
                len(system.instruction) + len(rq.history_tokens),
                item_keys=self._item_keys, instr_len=len(system.instruction))
        if moved_tokens:
            if backend.shard.measures:
                # real copies: bill what they measured
                backend.pending_transfer_s[req.rid] = backend.shard.take_measured_s()
            else:
                backend.pending_transfer_s[req.rid] = CM.fetch_time_s(
                    system.cfg, self.hw, 0, moved_tokens)

    # -------------------------------- run ---------------------------------
    def run(self, trace: Sequence, decode_steps: int = 4) -> ClusterReport:
        """Serve a synthetic request trace end to end."""
        pend = []
        for rid, rq in enumerate(trace):
            self._trace_by_rid[rid] = rq
            pend.append(PendingRequest(arrival_s=float(rq.arrival_s), rid=rid,
                                       n_tokens=0,  # set at dispatch, with the plan
                                       decode_steps=decode_steps))
        completions = self.batcher.run(pend)
        generated, workers = {}, []
        for w, backend in enumerate(self.backends):
            generated.update(backend.generated)
            rids = [r for r, i in self.assigned.items() if i == w]
            shard = backend.shard
            store = backend.engine.store
            st = None
            if store is not None:
                st = dict(store.stats())
                st["transfers_avoided"] = backend.transfers_avoided
                for tier in ("user", "item", "prefix"):
                    h, m = st[f"hits_{tier}"], st[f"misses_{tier}"]
                    st[f"{tier}_hit_rate"] = h / max(h + m, 1)
            worker = self.batcher.workers[w]
            workers.append(WorkerReport(
                worker=w, n_requests=len(rids),
                mean_hit_rate=(float(np.mean([self.hit_rate[r] for r in rids]))
                               if rids else None),
                transfer_blocks=len(shard.transfers) if shard else 0,
                transfer_tokens=shard.transferred_tokens() if shard else 0,
                transfer_bytes=shard.transferred_bytes() if shard else 0,
                transfer_seconds=backend.transfer_seconds,
                pool_peak_pages=backend.engine.pool.peak_pages,
                busy_seconds=worker.busy_seconds, preempted=worker.preempted,
                kv_reuse=st, migrations=backend.migrations_in,
                migrated_out=worker.migrated_out, migrated_pages=backend.migrated_pages,
                migration_bytes=backend.migration_bytes,
                migration_s=backend.migration_seconds,
                migration_digest_hits=backend.migration_digest_hits,
                device_blocks=st["device_blocks"] if st else 0,
                spill_blocks=st["spill_blocks"] if st else 0,
                spill_hits=st["spill_hits"] if st else 0,
                prefetch_promotions=st["prefetch_promotions"] if st else 0,
                dequant_s=st["dequant_s"] if st else 0.0))
        return ClusterReport(completions=completions, assigned=dict(self.assigned),
                             hit_rate=dict(self.hit_rate), generated=generated,
                             workers=workers, policy=self.scheduler.policy)
