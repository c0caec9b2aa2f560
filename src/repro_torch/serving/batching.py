"""Continuous batching for the port's serving path — the wave and chunked
disciplines of the JAX package's `serving/batching.py`, on one instance
or on K workers sharing one arrival stream (`ClusterBatcher`), with the
block store's admission accounting and prefill/decode disaggregation
(role-typed workers handing requests over through a migration hook).
The same loop drives the port's engine (`TorchEngineBackend`) or the
analytic cost model as a virtual clock (`SimBackend`, wave only).

* ``sched="wave"``: each step runs either one whole-prefill batch under a
  token budget or one decode iteration (prefill-prioritized, vLLM's
  default shape).
* ``sched="chunked"``: each step is one unified tick under
  `step_tokens`: decode for every running request plus layer-0 chunks
  and selective finalizes of the admitted prompts (`BatchEngine.step`),
  so a long prompt never stalls the decode set for its whole scan.

The backend returns the seconds each step took; the loop adds them to a
clock that also jumps to the next arrival when idle, so TTFT and
time-between-tokens are measured on the wall clock of the steps.  Each
worker's clock adds only its own steps: K workers stepped in turn on one
host and one card model K instances running side by side.

Under tensor parallelism every rank of the mesh's model axis runs this
loop over its own engine, and every rank must issue the same device
calls in the same order.  The loop's decisions are a pure function of
its state and its clock, and the clock's only input that differs
between processes, a step's measured seconds, is rank 0's, broadcast at
the step boundary (`sharding.ctx.decide`): rank 0 decides each step's
plan for all.  With the mesh's check on, each step's plan (worker,
clock, kind and request ids) is compared by digest across the ranks
before it runs (`sharding.ctx.check`), and the first difference fails
the run.
"""
from __future__ import annotations

import bisect
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.api import GREEDY, SamplingParams, match_stop, sample_token
from repro_torch.serving.kv_pool import PoolExhausted
from repro_torch.sharding import ctx as CTX


@dataclass(order=True)
class PendingRequest:
    arrival_s: float
    rid: int = field(compare=False)
    n_tokens: int = field(compare=False)
    decode_steps: int = field(compare=False, default=4)
    tokens: Optional[np.ndarray] = field(compare=False, default=None)


@dataclass(frozen=True)
class TickRecord:
    """One scheduling tick's token accounting (chunked sched)."""

    t: float  # clock when the tick completed
    seconds: float  # backend-reported step time
    decode_tokens: int
    chunk_tokens: int
    finalize_tokens: int
    oversized: bool  # a single indivisible item exceeded the budget


@dataclass
class DecodeEntry:
    """One running request in the decode set (rid-keyed)."""

    req: PendingRequest
    ttft_s: float
    steps_left: int


@dataclass
class Completion:
    rid: int
    arrival_s: float
    first_token_s: float  # TTFT
    done_s: float
    worker: int = 0
    admitted_s: float = 0.0
    reason: str = "length"

    @property
    def queue_wait_s(self) -> float:
        return self.admitted_s - self.arrival_s

    @property
    def prefill_s(self) -> float:
        return self.first_token_s - self.admitted_s

    @property
    def decode_s(self) -> float:
        return self.done_s - self.first_token_s


class SimBackend:
    """Virtual clock: analytic prefill / decode time functions (seconds
    for a batch's prompt tokens, and for one decode iteration of a batch
    size), behind the same seam as the engine.  Wave only."""

    def __init__(self, prefill_time_fn: Callable[[int], float],
                 decode_time_fn: Callable[[int], float]):
        self.prefill_time_fn = prefill_time_fn
        self.decode_time_fn = decode_time_fn

    def prefill(self, batch: Sequence[PendingRequest]) -> float:
        return self.prefill_time_fn(sum(r.n_tokens for r in batch))

    def decode(self, batch: Sequence[PendingRequest]) -> float:
        return self.decode_time_fn(len(batch))

    def can_admit(self, req: PendingRequest,
                  batch: Sequence[PendingRequest] = ()) -> bool:
        return True

    def early_stop(self, rid: int) -> bool:
        return False

    def finish(self, req: PendingRequest) -> None:
        pass

    def preempt(self, req: PendingRequest) -> None:
        pass


class TorchEngineBackend:
    """The port's batched engine behind the batching loop's seam (the
    counterpart of the JAX package's `JaxEngineBackend`).

    `mode="full"` prefills every prompt exactly; `mode="rcllm"` runs the
    beyond-prefix selective path and needs `plans` ({rid: (plan,
    block_table, positions, have)}, `serving.workload.rcllm_workload`)
    and, for a store-backed engine, `reuse` ({rid:
    `block_store.RequestReuse`}, `workload.rcllm_reuse_info`).  Token
    selection is greedy unless a request registered `SamplingParams` via
    `set_session`."""

    def __init__(self, engine, mode: str = "full", plans: Optional[Dict] = None,
                 reuse: Optional[Dict] = None):
        self.engine = engine
        self.mode = mode
        self.plans = plans if plans is not None else {}
        self.reuse = reuse if reuse is not None else {}
        # rid -> (store.version, bound): admission bounds hold until the
        # store's resident set changes
        self._admit_cache: Dict[int, tuple] = {}
        self.last_token: Dict[int, int] = {}
        self.generated: Dict[int, List[int]] = {}
        self.sampling: Dict[int, SamplingParams] = {}
        self.stop_seqs: Dict[int, tuple] = {}
        self._rngs: Dict[int, np.random.Generator] = {}
        self.finish_reason: Dict[int, str] = {}

    def set_session(self, rid: int, sampling: SamplingParams = GREEDY,
                    stop: Sequence[Sequence[int]] = ()) -> None:
        """Register sampling and stop sequences before a request is served."""
        if not sampling.greedy:
            self.sampling[rid] = sampling
        if stop:
            self.stop_seqs[rid] = tuple(tuple(s) for s in stop)

    @property
    def attn_backend(self) -> str:
        """The attention route the wrapped engine resolved: "cuda" (the
        kernels) or "plain" (their plain versions)."""
        return "cuda" if self.engine.attn_kernels else "plain"

    @property
    def decode_kernel(self) -> str:
        """The decode route the wrapped engine resolved: "paged" (the
        paged-decode kernel) or "gather" (its plain version)."""
        return "paged" if self.engine.paged else "gather"

    def _pick(self, rid: int, lg) -> int:
        params = self.sampling.get(rid, GREEDY)
        if params.greedy:
            return int(np.argmax(lg))
        rng = self._rngs.get(rid)
        if rng is None:
            rng = np.random.default_rng((params.seed, rid))
            self._rngs[rid] = rng
        return sample_token(np.asarray(lg), params, rng)

    def _append(self, rid: int, tok: int, first: bool = False) -> None:
        self.last_token[rid] = tok
        if first:
            self.generated[rid] = [tok]
        else:
            self.generated[rid].append(tok)
        stops = self.stop_seqs.get(rid)
        if stops and match_stop(self.generated[rid], stops):
            self.finish_reason[rid] = "stop"

    def early_stop(self, rid: int) -> bool:
        """Did this request hit a stop sequence (retire it now)?"""
        return rid in self.finish_reason

    def _batch_requests(self, batch: Sequence[PendingRequest]):
        from repro_torch.serving.batch_engine import BatchRequest

        out = []
        for r in batch:
            if r.tokens is None:
                raise ValueError(f"request {r.rid}: the engine needs tokens")
            # decode appends decode_steps-1 KV slots: the first output
            # token comes from prefill and the last sampled token is
            # never written back
            br = BatchRequest(rid=r.rid, tokens=r.tokens,
                              n_reserve=max(r.decode_steps - 1, 0))
            if self.mode == "rcllm":
                br.plan, br.block_table, br.positions, br.have = self.plans[r.rid]
                br.reuse = self.reuse.get(r.rid)
            out.append(br)
        return out

    def prefill(self, batch: Sequence[PendingRequest]) -> float:
        t0 = time.perf_counter()
        logits = self.engine.prefill(self._batch_requests(batch), self.mode)
        for r, lg in zip(batch, logits):
            self._append(r.rid, self._pick(r.rid, lg), first=True)
        return time.perf_counter() - t0

    def can_admit(self, req: PendingRequest,
                  batch: Sequence[PendingRequest] = ()) -> bool:
        """Pages for the prompt + its decode tokens, on top of what the
        rest of the forming batch will claim.  Under cross-request reuse
        only private pages count, against the free pages plus what LRU
        eviction could reclaim (not counting the blocks these very
        requests will map); store inserts are optional and not charged."""
        pool = self.engine.pool
        store = getattr(self.engine, "store", None)
        if store is None or self.mode != "rcllm":
            need = sum(pool.pages_for(r.n_tokens + max(r.decode_steps - 1, 0))
                       for r in (*batch, req))
            return need <= pool.free_pages
        from repro_torch.serving import block_store as BS

        need = 0
        hit_keys = set()
        for r in (*batch, req):
            reuse = self.reuse.get(r.rid)
            entry = self._admit_cache.get(r.rid)
            if entry is not None and entry[0] == store.version:
                bound = entry[1]
            else:
                plan, _, _, have = self.plans[r.rid]
                bound, _ = BS.admission_pages(pool, store, plan, have, self.engine.sel,
                                              reuse, max(r.decode_steps - 1, 0),
                                              bucket=self.engine.bucket)
                self._admit_cache[r.rid] = (store.version, bound)
            need += bound
            if reuse is not None:
                hit_keys.update(ref.key for ref in reuse.blocks if store.has(ref.key))
                if reuse.user_key is not None and store.has(reuse.user_key):
                    hit_keys.add(reuse.user_key)
        return need <= pool.free_pages + store.reclaimable_pages(exclude=hit_keys)

    def decode(self, batch: Sequence[PendingRequest]) -> float:
        t0 = time.perf_counter()
        rids = [r.rid for r in batch]
        logits = self.engine.decode(rids, [self.last_token[r] for r in rids])
        for rid, lg in zip(rids, logits):
            self._append(rid, self._pick(rid, lg))
        return time.perf_counter() - t0

    def finish(self, req: PendingRequest) -> None:
        self.engine.release(req.rid)
        self.last_token.pop(req.rid, None)
        self._admit_cache.pop(req.rid, None)
        self.sampling.pop(req.rid, None)
        self.stop_seqs.pop(req.rid, None)
        self._rngs.pop(req.rid, None)

    def preempt(self, req: PendingRequest) -> None:
        """Release a mid-decode victim's pages, keeping it re-runnable
        (plans and sampling kept; the PRNG restarts from its seed)."""
        self.engine.release(req.rid)
        self.last_token.pop(req.rid, None)
        self._admit_cache.pop(req.rid, None)
        self._rngs.pop(req.rid, None)
        self.finish_reason.pop(req.rid, None)

    # ----------------------------- migration ------------------------------
    _SESSION = ("last_token", "generated", "sampling", "stop_seqs", "_rngs",
                "finish_reason", "plans", "reuse")

    def export_request_kv(self, rid: int):
        """One request as the engine's `RequestKV` with this backend's
        session state attached (generated stream, PRNG, stop sequences,
        plan and reuse metadata): what another backend needs to continue
        it.  Read-only; `evacuate` only after the import succeeded."""
        rec = self.engine.export_request_kv(rid)
        rec.session = {name: getattr(self, name).get(rid) for name in self._SESSION}
        return rec

    def import_request_kv(self, rec) -> Dict[str, int]:
        """Install a migrated request: the engine's pages and store
        references, then the session state.  -> the engine's migration
        counters.  Transactional through the engine."""
        counters = self.engine.import_request_kv(rec)
        for name, val in (rec.session or {}).items():
            if val is not None:
                getattr(self, name)[rec.rid] = (list(val) if name == "generated"
                                                else val)
        return counters

    def evacuate(self, rid: int) -> None:
        """Drop every trace of a request migrated away: pages, store
        references, chunk state and session state."""
        self.engine.abort_prefill(rid)
        self._admit_cache.pop(rid, None)
        for name in self._SESSION:
            getattr(self, name).pop(rid, None)

    # ------------------------- chunked discipline -------------------------
    def begin_prefill(self, req: PendingRequest) -> None:
        """Admit one request into chunk-resumable prefill (claims its pool
        pages, see `BatchEngine.begin_prefill`)."""
        if self.mode != "rcllm":
            raise ValueError("sched='chunked' drives the beyond-prefix selective "
                             "prefill; mode='full' has no chunk-resumable path")
        self.engine.begin_prefill(self._batch_requests([req])[0])

    def step(self, budget: int, decode_batch: Sequence[PendingRequest],
             prefill_queue: Sequence[PendingRequest]):
        """One unified engine tick.  -> (StepReport, seconds).  Picks tokens
        for whatever the tick produced: decode logits of the running set,
        first tokens of the finalized prefills."""
        t0 = time.perf_counter()
        rids = [r.rid for r in decode_batch]
        rep = self.engine.step(budget, rids, [self.last_token[r] for r in rids],
                               [r.rid for r in prefill_queue])
        if rep.decode_logits is not None:
            for rid, lg in zip(rids, rep.decode_logits):
                self._append(rid, self._pick(rid, lg))
        for rid, lg in rep.finalized.items():
            self._append(rid, self._pick(rid, lg), first=True)
        return rep, time.perf_counter() - t0

    def preempt_prefill(self, req: PendingRequest) -> None:
        """Roll back a mid-prefill victim: the engine drops its chunk state
        and pages; the plan is kept for the re-prefill."""
        self.engine.abort_prefill(req.rid)
        self.last_token.pop(req.rid, None)
        self._admit_cache.pop(req.rid, None)
        self._rngs.pop(req.rid, None)
        self.finish_reason.pop(req.rid, None)


class WorkerState:
    """One serving instance inside a (possibly multi-worker) batching loop:
    its backend, clock, FIFO admission queue, prefilling set (chunked
    sched) and decode set.  Backpressure is per worker: a full pool stalls
    this worker's admissions and nobody else's.

    ``role`` types the worker for disaggregation: a ``prefill`` worker
    admits and prefills, then hands each request to `migrate` (set by the
    cluster) instead of decoding it; a ``decode`` worker never admits and
    takes requests through `receive_migration`; ``unified`` does both."""

    def __init__(self, backend, wid: int = 0,
                 max_batch_tokens: int = 8192, max_decode_batch: int = 64,
                 sched: str = "wave", chunk_tokens: int = 128,
                 step_tokens: Optional[int] = None, role: str = "unified"):
        if sched not in ("wave", "chunked"):
            raise ValueError(f"unknown sched {sched!r}")
        if role not in ("unified", "prefill", "decode"):
            raise ValueError(f"unknown worker role {role!r}")
        if sched == "chunked" and not hasattr(backend, "begin_prefill"):
            raise ValueError("sched='chunked' needs a chunk-capable backend "
                             "(TorchEngineBackend); the simulator is wave-only")
        self.backend = backend
        self.wid = wid
        self.role = role
        # (worker, entry, admitted_s) -> True when a decode worker took it
        self.migrate: Optional[Callable] = None
        # migrations awaiting their transfer: (available_t, DecodeEntry,
        # admitted_s, prefilling)
        self.inbound: List[tuple] = []
        self.migrated_out = 0
        # rids a decode worker preempted itself and may re-admit
        self._preempt_ok: set = set()
        self.max_batch_tokens = max_batch_tokens
        self.max_decode_batch = max_decode_batch
        self.sched = sched
        # the per-tick token budget: room for one chunk per default decode
        # batch plus slack, so decode alone cannot starve prefill
        self.step_tokens = (step_tokens if step_tokens is not None
                            else max(4 * chunk_tokens, 512))
        self.clock = 0.0
        self.busy_seconds = 0.0
        self.preempted = 0
        self._preempt_counts: Dict[int, int] = {}
        self.waiting: List[PendingRequest] = []
        self.prefilling: List[PendingRequest] = []  # chunked sched only
        self.decoding: Dict[int, DecodeEntry] = {}
        self.done: List[Completion] = []
        self.ticks: List[TickRecord] = []
        self.tbt: List[float] = []  # time-between-tokens samples
        self._admit_t: Dict[int, float] = {}
        self._last_tok_t: Dict[int, float] = {}
        # measured service rates (EWMA over observed steps): the router's
        # live queue-depth estimate prices queued work at what this worker
        # actually costs
        self._prefill_s_per_tok = 0.0
        self._decode_s_per_step = 0.0

    def has_work(self) -> bool:
        return bool(self.waiting or self.prefilling or self.decoding or self.inbound)

    def ready_time(self) -> float:
        """Earliest instant this worker can take its next step."""
        if self.decoding or self.prefilling:
            return self.clock
        due = []
        if self.waiting:
            due.append(self.waiting[0].arrival_s)
        if self.inbound:
            due.append(min(x[0] for x in self.inbound))
        return max(self.clock, min(due)) if due else self.clock

    def receive_migration(self, entry: DecodeEntry, available_t: float,
                          admitted_s: float, prefilling: bool = False) -> None:
        """Accept a migrated request: it joins the decode set at
        `available_t` (the source's handoff time plus the billed transfer)
        with its first token sampled, or, for a chunk-partial handoff
        (`prefilling`), the prefilling set, to resume its scan here."""
        self.inbound.append((available_t, entry, admitted_s, prefilling))

    def _accept_inbound(self) -> None:
        """Move migrations whose transfer has completed into the decode
        (or prefilling) set."""
        due = [x for x in self.inbound if x[0] <= self.clock]
        if not due:
            return
        self.inbound = [x for x in self.inbound if x[0] > self.clock]
        for t, entry, admitted_s, prefilling in due:
            rid = entry.req.rid
            self._admit_t[rid] = admitted_s
            if prefilling:
                self.prefilling.append(entry.req)
                continue
            self._last_tok_t[rid] = t
            self.decoding[rid] = entry

    def _check_role_waiting(self) -> None:
        """A decode worker takes no dispatched admission, only a migrated
        request it preempted itself (it re-prefills from the plan the
        import installed)."""
        if self.role != "decode":
            return
        bad = [r for r in self.waiting if r.rid not in self._preempt_ok]
        if bad:
            raise RuntimeError(f"decode-role worker {self.wid} was dispatched request "
                               f"{bad[0].rid}: admissions must route to prefill workers")

    def backlog_seconds(self, t: float) -> float:
        """Estimated seconds of outstanding work as seen at time `t`: busy
        time already on the clock plus queued work at the measured service
        rates (0 until a step has been observed)."""
        est = max(self.clock - t, 0.0)
        est += sum(r.n_tokens for r in self.waiting) * self._prefill_s_per_tok
        est += sum(r.n_tokens for r in self.prefilling) * self._prefill_s_per_tok
        if self.decoding:
            est += (max(e.steps_left for e in self.decoding.values())
                    * self._decode_s_per_step)
        return est

    @staticmethod
    def _ewma(old: float, new: float) -> float:
        return new if old == 0.0 else 0.5 * old + 0.5 * new

    def _handoff(self, entry: DecodeEntry, admitted: float) -> bool:
        """A prefill worker's handoff of `entry` to a decode worker."""
        if self.role == "prefill" and self.migrate is not None \
                and self.migrate(self, entry, admitted):
            self.migrated_out += 1
            return True
        return False

    def step(self) -> None:
        if self.sched == "chunked":
            self._step_chunked()
        else:
            self._step_wave()

    # ------------------------------ wave sched ------------------------------
    def _step_wave(self) -> None:
        """A prefill batch if one can form under the token budget and pool
        capacity, else one decode iteration."""
        self.clock = self.ready_time()
        self._accept_inbound()
        self._check_role_waiting()
        batch: List[PendingRequest] = []
        tok = 0
        for r in self.waiting:
            if r.arrival_s > self.clock:
                break
            if tok + r.n_tokens > self.max_batch_tokens and batch:
                break
            if not self.backend.can_admit(r, batch):
                break  # strict FCFS under backpressure
            batch.append(r)
            tok += r.n_tokens
        if not batch and not self.decoding:
            if not self.waiting:
                return  # only future inbound migrations
            raise RuntimeError(
                f"request {self.waiting[0].rid} ({self.waiting[0].n_tokens} "
                "tokens) can never be admitted: KV pool too small "
                "even with no other request running")
        if batch:
            self._prefill(batch, tok)
        else:
            self._decode()

    def _plan(self, kind: str, *rids) -> None:
        """The step about to run, compared across the ranks of a mesh."""
        CTX.check("step plan", (self.wid, self.clock, kind, *rids))

    def _prefill(self, batch: List[PendingRequest], tok: int) -> None:
        admitted = self.clock
        picked = {r.rid for r in batch}
        self.waiting = [r for r in self.waiting if r.rid not in picked]
        self._plan("prefill", [r.rid for r in batch])
        dt = CTX.decide(self.backend.prefill(batch))
        self.clock += dt
        self.busy_seconds += dt
        self._prefill_s_per_tok = self._ewma(self._prefill_s_per_tok, dt / max(tok, 1))
        for r in batch:
            self._admit_t[r.rid] = admitted
            self._first_token(r)

    def _first_token(self, r: PendingRequest) -> None:
        """A prefill produced `r`'s first token at `self.clock`: retire it
        if that was its whole output, hand it to a decode worker, or move
        it into the decode set."""
        admitted = self._admit_t.get(r.rid, r.arrival_s)
        stopped = self.backend.early_stop(r.rid)
        if r.decode_steps <= 1 or stopped:  # the TTFT token was the output
            self._admit_t.pop(r.rid, None)
            self.done.append(Completion(
                r.rid, r.arrival_s, self.clock, self.clock, self.wid,
                admitted_s=admitted, reason="stop" if stopped else "length"))
            self.backend.finish(r)
            return
        entry = DecodeEntry(r, self.clock - r.arrival_s, r.decode_steps - 1)
        if self._handoff(entry, admitted):
            self._admit_t.pop(r.rid, None)
            return
        self._last_tok_t[r.rid] = self.clock
        self.decoding[r.rid] = entry

    def _decode(self) -> None:
        while True:
            db = list(self.decoding.values())[: self.max_decode_batch]
            self._plan("decode", [e.req.rid for e in db])
            try:
                dt = CTX.decide(self.backend.decode([e.req for e in db]))
                break
            except PoolExhausted:
                # no KV slot for every running request: preempt the
                # youngest (it re-prefills later) and retry
                self._preempt_youngest()
                if not self.decoding:
                    return
        self.clock += dt
        self.busy_seconds += dt
        self._decode_s_per_step = self._ewma(self._decode_s_per_step, dt)
        self._decoded(db)

    def _decoded(self, db: List[DecodeEntry]) -> None:
        """Book one decode token for every entry of `db` and retire the
        requests whose output is complete."""
        for e in db:
            e.steps_left -= 1
            if self.backend.early_stop(e.req.rid):
                e.steps_left = 0
            last = self._last_tok_t.get(e.req.rid)
            if last is not None:
                self.tbt.append(self.clock - last)
            self._last_tok_t[e.req.rid] = self.clock
        for rid in [rid for rid, e in self.decoding.items() if e.steps_left <= 0]:
            e = self.decoding.pop(rid)
            req = e.req
            self.done.append(Completion(
                req.rid, req.arrival_s, req.arrival_s + e.ttft_s, self.clock, self.wid,
                admitted_s=self._admit_t.pop(rid, req.arrival_s),
                reason="stop" if self.backend.early_stop(rid) else "length"))
            self._last_tok_t.pop(rid, None)
            self.backend.finish(req)

    # ---------------------------- chunked sched ----------------------------
    def _step_chunked(self) -> None:
        """One unified tick: admit what fits, then one budgeted engine step
        packing decode tokens for every running request plus prefill
        chunks and finalizes for the admitted set."""
        self.clock = self.ready_time()
        self._accept_inbound()
        self._admit_chunked()
        if not self.decoding and not self.prefilling:
            return  # only future inbound migrations
        while True:
            db = list(self.decoding.values())[: self.max_decode_batch]
            self._plan("tick", [e.req.rid for e in db], [r.rid for r in self.prefilling])
            try:
                rep, dt = self.backend.step(self.step_tokens, [e.req for e in db],
                                            self.prefilling)
                dt = CTX.decide(dt)
                break
            except PoolExhausted:
                # the wave loop's retry contract, per tick: evict the
                # youngest request (a mid-prefill victim rolls its chunk
                # state back, or is handed off) and retry before any
                # prefill work runs
                self._preempt_youngest()
                if not self.decoding and not self.prefilling:
                    return
        self.clock += dt
        self.busy_seconds += dt
        # the tick's seconds split by token charge, so the router prices
        # queued prompt tokens and decode steps apart
        charge = max(rep.charged, 1)
        if rep.charge_chunks + rep.charge_finalize:
            self._prefill_s_per_tok = self._ewma(self._prefill_s_per_tok, dt / charge)
        if rep.charge_decode:
            self._decode_s_per_step = self._ewma(self._decode_s_per_step,
                                                 dt * rep.charge_decode / charge)
        self.ticks.append(TickRecord(
            t=self.clock, seconds=dt, decode_tokens=rep.charge_decode,
            chunk_tokens=rep.charge_chunks, finalize_tokens=rep.charge_finalize,
            oversized=rep.oversized))
        if rep.decode_logits is not None:
            self._decoded(db)
        finalized = [r for r in self.prefilling if r.rid in rep.finalized]
        self.prefilling = [r for r in self.prefilling if r.rid not in rep.finalized]
        for r in finalized:
            self._first_token(r)

    def _admit_chunked(self) -> None:
        """Move due arrivals into the prefilling set, FIFO, while pool
        capacity allows: an admitted request competes for the step budget
        from this tick on."""
        self._check_role_waiting()
        while self.waiting:
            r = self.waiting[0]
            if r.arrival_s > self.clock or not self.backend.can_admit(r):
                break
            try:
                self.backend.begin_prefill(r)
            except PoolExhausted:
                break
            self.waiting.pop(0)
            self.prefilling.append(r)
            self._admit_t[r.rid] = self.clock
        if not self.decoding and not self.prefilling and self.waiting:
            raise RuntimeError(
                f"request {self.waiting[0].rid} ({self.waiting[0].n_tokens} "
                "tokens) can never be admitted: KV pool too small "
                "even with no other request running")

    def _preempt_youngest(self) -> None:
        """Evict the youngest running request under pool pressure and
        requeue it: a mid-decode victim frees its pages, a mid-prefill one
        also drops its chunk state (a prefill worker hands it to a decode
        worker instead, scan progress and all); the plan is kept, and
        greedy decode regenerates the same tokens."""
        cands = [e.req for e in self.decoding.values()] + list(self.prefilling)
        req = max(cands, key=lambda r: (r.arrival_s, r.rid))
        self._preempt_counts[req.rid] = self._preempt_counts.get(req.rid, 0) + 1
        if self._preempt_counts[req.rid] > 8:
            raise RuntimeError(
                f"request {req.rid} preempted {self._preempt_counts[req.rid]}"
                " times: the pool cannot hold its decode tokens even alone")
        if any(r.rid == req.rid for r in self.prefilling):
            self.prefilling = [r for r in self.prefilling if r.rid != req.rid]
            admitted = self._admit_t.pop(req.rid, req.arrival_s)
            if self._handoff(DecodeEntry(req, 0.0, req.decode_steps), admitted):
                return   # the live chunk state rode the handoff
            self.backend.preempt_prefill(req)
        else:
            self.decoding.pop(req.rid)
            self._last_tok_t.pop(req.rid, None)
            self._admit_t.pop(req.rid, None)
            self.backend.preempt(req)
        self.preempted += 1
        if self.role == "decode":
            self._preempt_ok.add(req.rid)
        bisect.insort(self.waiting, req)

    def cancel(self, rid: int) -> Optional[str]:
        """Cancel a request wherever it lives, through the seams preemption
        uses: a waiting request is dequeued; a mid-prefill one drops its
        chunk state, pages and store references (`preempt_prefill`), then
        its session state (`finish`); a mid-decode one releases through
        `finish`.  -> the stage it was cancelled in ("waiting",
        "prefilling", "decoding"), or None when this worker does not hold
        it (already completed, or never here).  Call only between steps."""
        for i, r in enumerate(self.waiting):
            if r.rid == rid:
                del self.waiting[i]
                return "waiting"
        for i, r in enumerate(self.prefilling):
            if r.rid == rid:
                del self.prefilling[i]
                self._admit_t.pop(rid, None)
                self.backend.preempt_prefill(r)
                self.backend.finish(r)   # release is idempotent
                return "prefilling"
        e = self.decoding.pop(rid, None)
        if e is not None:
            self._admit_t.pop(rid, None)
            self._last_tok_t.pop(rid, None)
            self.backend.finish(e.req)
            return "decoding"
        return None


# dispatch hook: (request, arrival time, workers) -> worker index
DispatchFn = Callable[[PendingRequest, float, List[WorkerState]], int]


def least_backlog_dispatch(req: PendingRequest, t: float,
                           workers: List[WorkerState]) -> int:
    """Default dispatch: the worker with the least estimated backlog."""
    return min(range(len(workers)), key=lambda i: (workers[i].backlog_seconds(t), i))


class ClusterBatcher:
    """Continuous batching across K workers sharing one arrival stream.

    Each worker is a `WorkerState` over its own backend (own pool, clock
    and backpressure); `dispatch` assigns every arrival to a worker at its
    arrival time, seeing live worker state (the Eq. 2 router of
    `serving.cluster` plugs in here).  Events go in global time order: an
    arrival is dispatched once every busy worker's next step lies at or
    after it, so the router sees the queues a global scheduler would."""

    def __init__(self, backends: Sequence[TorchEngineBackend],
                 dispatch: Optional[DispatchFn] = None, max_batch_tokens: int = 8192,
                 max_decode_batch: int = 64, sched: str = "wave",
                 chunk_tokens: int = 128, step_tokens: Optional[int] = None):
        self.workers = [
            WorkerState(b, wid=i, max_batch_tokens=max_batch_tokens,
                        max_decode_batch=max_decode_batch, sched=sched,
                        chunk_tokens=chunk_tokens, step_tokens=step_tokens)
            for i, b in enumerate(backends)]
        self.dispatch = dispatch or least_backlog_dispatch

    def run(self, requests: Sequence[PendingRequest]) -> List[Completion]:
        seen: set = set()
        for r in requests:
            if r.rid in seen:
                raise ValueError(f"duplicate request rid {r.rid}")
            seen.add(r.rid)
        pending = sorted(requests)
        i = 0
        while i < len(pending) or any(w.has_work() for w in self.workers):
            busy = [w for w in self.workers if w.has_work()]
            t_work = min((w.ready_time() for w in busy), default=math.inf)
            t_arr = pending[i].arrival_s if i < len(pending) else math.inf
            if t_arr <= t_work:
                req = pending[i]
                i += 1
                self.workers[int(self.dispatch(req, t_arr, self.workers))].waiting.append(req)
            else:
                min(busy, key=lambda w: (w.ready_time(), w.wid)).step()
        done = [c for w in self.workers for c in w.done]
        done.sort(key=lambda c: c.done_s)  # stable: in-step order kept
        return done


class ContinuousBatcher:
    """Single-instance continuous batching over a `TorchEngineBackend`,
    under the wave or the chunked (unified-step) discipline: a one-worker
    `ClusterBatcher`."""

    def __init__(self, backend: TorchEngineBackend, max_batch_tokens: int = 8192,
                 max_decode_batch: int = 64, sched: str = "wave",
                 chunk_tokens: int = 128, step_tokens: Optional[int] = None):
        self.backend = backend
        self.max_batch_tokens = max_batch_tokens
        self.max_decode_batch = max_decode_batch
        self.sched = sched
        self.chunk_tokens = chunk_tokens
        self.step_tokens = step_tokens
        self.workers: List[WorkerState] = []

    def run(self, requests: Sequence[PendingRequest]) -> List[Completion]:
        cb = ClusterBatcher([self.backend], dispatch=lambda req, t, ws: 0,
                            max_batch_tokens=self.max_batch_tokens,
                            max_decode_batch=self.max_decode_batch, sched=self.sched,
                            chunk_tokens=self.chunk_tokens, step_tokens=self.step_tokens)
        self.workers = cb.workers
        return cb.run(requests)
