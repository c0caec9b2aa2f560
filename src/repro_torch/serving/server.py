"""Asyncio session server of the port: the serving loop fronted by live
sessions (the JAX package's `serving/server.py`).

Clients `AsyncSessionServer.submit` requests whenever they like and
consume an async iterator of `api.StreamEvent` per session, while one
background scheduler task drives `batching.WorkerState.step`, the same
wave or chunked tick the closed-loop runner uses.  One tick:

    client --submit()--> arrival queue --+          (asyncio side)
    client --cancel()--> cancel set -----+
                                         v          (tick boundary)
        drain arrivals -> worker.waiting (kept in arrival order)
        apply cancels  -> worker.cancel(rid) (preempt_prefill / finish)
        worker.step()  -> one wave batch or one budgeted chunked tick,
                          in a pool thread (`asyncio.to_thread`)
        publish: new tokens of backend.generated -> per-session queues;
                 new worker.done entries -> api.Completion;
                 metrics: rolling TTFT / TBT percentiles, queue depth,
                 pool occupancy, store hit rates

The worker is touched only between steps, by the scheduler task:
`submit` and `cancel` only enqueue, and one step runs at a time.  The
step's kernels launch on the pool thread's current stream, which is the
device's default stream as on the caller's thread; `start` builds the
kernels first, so no build starts inside the step.

Scheduling depends only on the order and stamped arrival times of the
requests and on the worker's clock, which adds measured step seconds.
`replay(..., speed=0)` stages a whole trace with its arrival stamps and
decodes the closed-loop `ContinuousBatcher.run`'s tokens; with
``speed > 0`` the trace becomes open-loop wall-clock traffic.

Under tensor parallelism (the server built inside ``sharding.ctx.axes
(mesh)`` of a mesh whose model axis has more than one rank) the model
axis's first rank runs this asyncio server and every other rank runs
`follow`, a plain loop over its own `WorkerState` on the same shard of
the system.  At each tick boundary the server decides the tick: the
arrivals it admitted (their `SubmitRequest`s and stamped arrival times),
the sessions whose cancels it applied, in that order, and whether it
stops.  The tick is broadcast (`sharding.ctx.decide`) inside the same
pool-thread call that runs the step, so each rank issues all its
collectives from one thread in one order; a follower applies the tick to
its worker and steps as the server did.  The step's measured seconds are
the server's (`WorkerState.step` decides them), so every rank schedules
alike.  While idle the server sends an empty tick every `HEARTBEAT_S`,
inside the collectives' time limit; shutdown is a tick that stops.
"""
from __future__ import annotations

import asyncio
import bisect
import time
from collections import deque
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.api import Completion, ServeConfig, StreamEvent, SubmitRequest
from repro_torch.serving.batching import PendingRequest, WorkerState
from repro_torch.sharding import ctx as CTX

# the kernels the engine's steps launch (`kernels._build.SOURCES` names)
SERVING_KERNELS = ("flash", "selective", "paged_decode", "block_gather")
# an idle server's empty tick, well inside the collectives' time limit
# (`launch.mesh.COLLECTIVE_TIMEOUT_S`)
HEARTBEAT_S = 60.0


def make_worker(backend, config: ServeConfig) -> WorkerState:
    """The one worker a server (or a follower rank) drives."""
    return WorkerState(
        backend, wid=0, max_batch_tokens=config.max_batch_tokens,
        max_decode_batch=config.max_decode_batch, sched=config.sched,
        chunk_tokens=config.chunk_tokens, step_tokens=config.step_tokens)


def admit(worker: WorkerState, arrival_s: float, req: SubmitRequest) -> None:
    """One request into the worker's queue, with its rcllm context, reuse
    metadata and sampling, kept in arrival order (wall-clock submissions
    are monotone, replayed stamps need not be)."""
    backend = worker.backend
    if req.context is not None:
        backend.plans[req.rid] = req.context
    if req.reuse is not None:
        backend.reuse[req.rid] = req.reuse
    backend.set_session(req.rid, req.sampling, req.stop)
    bisect.insort(worker.waiting, PendingRequest(
        arrival_s=arrival_s, rid=req.rid, n_tokens=len(req.tokens),
        decode_steps=req.max_tokens, tokens=req.tokens))


def step_or_reject(worker: WorkerState) -> bool:
    """One step; a queue head that can never be admitted (the pool is too
    small even empty) is dropped instead.  -> whether it was."""
    try:
        worker.step()
    except RuntimeError as e:
        if "never be admitted" not in str(e):
            raise
        return True
    return False


def follow(backend, config: ServeConfig) -> WorkerState:
    """A non-serving rank's loop under tensor parallelism (the module
    docstring): receive each tick from the server's rank, apply its
    arrivals and cancels to this rank's worker and step as the server
    did, until a tick stops.  -> the worker (its `done` is the run's)."""
    worker = make_worker(backend, config)
    while True:
        tick = CTX.decide(None)
        for arrival_s, req in tick["arrivals"]:
            admit(worker, arrival_s, req)
        for rid in tick["cancels"]:
            worker.cancel(rid)
        if tick["stop"]:
            return worker
        if worker.has_work() and step_or_reject(worker):
            worker.waiting.pop(0)


class Session:
    """One submitted request's client handle: an async iterator of
    `StreamEvent`s (exactly one has ``finished=True``), `result()` for the
    terminal `api.Completion`, and `cancel()`."""

    def __init__(self, server: "AsyncSessionServer", request: SubmitRequest):
        self.request = request
        self.rid = request.rid
        self._server = server
        self._queue: asyncio.Queue = asyncio.Queue()
        self._done = asyncio.Event()
        self._exhausted = False
        self.completion: Optional[Completion] = None
        # server-side bookkeeping (scheduler task only)
        self.state = "queued"  # queued | running | done
        self.submitted_s = 0.0
        self.first_token_s: Optional[float] = None

    def __aiter__(self) -> "Session":
        return self

    async def __anext__(self) -> StreamEvent:
        if self._exhausted:
            raise StopAsyncIteration
        ev = await self._queue.get()
        if ev.finished:
            self._exhausted = True
        return ev

    async def result(self) -> Completion:
        """Wait for the session to finish.  -> its `api.Completion`."""
        await self._done.wait()
        return self.completion

    def cancel(self) -> str:
        """Cancel this session at the next tick boundary (see
        `AsyncSessionServer.cancel`)."""
        return self._server.cancel(self.rid)

    def _emit(self, ev: StreamEvent) -> None:
        self._queue.put_nowait(ev)
        if ev.finished:
            self._done.set()


class OnlineMetrics:
    """Rolling serving metrics over the last `window` observations."""

    def __init__(self, window: int = 512):
        self.ttft_s: deque = deque(maxlen=window)
        self.tbt_s: deque = deque(maxlen=window)
        self.completed = 0
        self.cancelled = 0
        self.rejected = 0

    @staticmethod
    def _pcts(xs: deque) -> Tuple[Optional[float], Optional[float]]:
        if not xs:
            return None, None
        arr = np.asarray(xs)
        return float(np.percentile(arr, 50)), float(np.percentile(arr, 99))

    def snapshot(self, server: "AsyncSessionServer") -> dict:
        """One point-in-time view (JSON-ready), with the JAX server's keys."""
        worker = server.worker
        ttft_p50, ttft_p99 = self._pcts(self.ttft_s)
        tbt_p50, tbt_p99 = self._pcts(self.tbt_s)
        snap = {
            "t_s": round(server.now(), 6),
            "queue_depth": len(worker.waiting),
            "prefilling": len(worker.prefilling),
            "decoding": len(worker.decoding),
            "completed": self.completed,
            "cancelled": self.cancelled,
            "rejected": self.rejected,
            "preempted": worker.preempted,
            "ttft_p50_s": ttft_p50,
            "ttft_p99_s": ttft_p99,
            "tbt_p50_s": tbt_p50,
            "tbt_p99_s": tbt_p99,
        }
        engine = server.backend.engine
        used = engine.pool.n_pages - engine.pool.free_pages
        snap["pool_pages_in_use"] = used
        snap["pool_occupancy"] = round(used / engine.pool.n_pages, 4)
        if engine.store is not None:
            stats = engine.store.stats()
            for tier in ("prefix", "user", "item"):
                h = stats.get(f"hits_{tier}", 0)
                m = stats.get(f"misses_{tier}", 0)
                snap[f"store_{tier}_hit_rate"] = round(h / max(h + m, 1), 4)
            snap["store_device_blocks"] = stats["device_blocks"]
            snap["store_spill_blocks"] = stats["spill_blocks"]
            snap["store_spill_hits"] = stats["spill_hits"]
            snap["store_prefetch_promotions"] = stats["prefetch_promotions"]
            snap["store_dequant_s"] = round(stats["dequant_s"], 6)
        return snap


class AsyncSessionServer:
    """The serving loop as a long-lived asyncio service over ONE worker
    (one engine, one KV pool): ``config.k`` must be 1, multi-worker
    serving is the closed-loop `cluster.ClusterEngine`.

    Construction takes a `TorchEngineBackend` and the `api.ServeConfig`
    that built it; `start` spawns the scheduler task and `submit` returns
    a `Session`.  Use as an async context manager to guarantee shutdown.

    Under ``config.mesh.tp > 1`` it is built inside ``sharding.ctx.axes
    (mesh)`` on the model axis's first rank, the other ranks running
    `follow` (the module docstring).
    """

    def __init__(self, backend, config: ServeConfig):
        if config.k != 1:
            raise ValueError(
                f"AsyncSessionServer drives one worker (config.k={config.k}); "
                "multi-worker serving is the closed-loop ClusterEngine")
        self.split = CTX.tp_size() > 1
        if self.split != (config.mesh.tp > 1):
            raise ValueError(f"a server of mesh.tp={config.mesh.tp} runs inside a mesh whose "
                             f"model axis has {config.mesh.tp} ranks, not {CTX.tp_size()} "
                             "(sharding.ctx.axes)")
        if self.split and CTX.current().coords["model"] != 0:
            raise ValueError("the server runs on the model axis's first rank; the others "
                             "run serving.server.follow")
        self.config = config
        self.worker = make_worker(backend, config)
        self.backend = backend
        self.metrics = OnlineMetrics()
        self.metrics_log: deque = deque(maxlen=4096)
        self._sessions: Dict[int, Session] = {}
        self._arrivals: deque = deque()  # sessions awaiting admission
        self._cancels: set = set()
        self._kick = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._running = False
        self._t0 = time.perf_counter()
        self._emitted: Dict[int, int] = {}  # rid -> tokens streamed
        self._last_emit: Dict[int, float] = {}
        self._n_done_seen = 0
        # the tick being decided: what this boundary applied to the worker
        self._tick = {"arrivals": [], "cancels": [], "stop": False}
        self.ticks = 0

    def now(self) -> float:
        """Server wall clock (seconds since construction)."""
        return time.perf_counter() - self._t0

    # ----------------------------- client API -----------------------------
    def submit(self, request: SubmitRequest,
               arrival_s: Optional[float] = None) -> Session:
        """Register a session; its request joins the worker's queue at the
        next tick boundary.  ``arrival_s`` overrides the arrival stamp
        (trace replay); by default the request arrives now.  Callable
        before `start`: replay stages a whole trace, then starts."""
        rid = request.rid
        if rid in self._sessions:
            raise ValueError(f"duplicate session rid {rid}")
        sess = Session(self, request)
        sess.submitted_s = self.now() if arrival_s is None else arrival_s
        self._sessions[rid] = sess
        self._arrivals.append(sess)
        self._kick.set()
        return sess

    def cancel(self, rid: int) -> str:
        """Ask for one session's cancellation.  A no-op on a session the
        server does not know ("unknown") or one already finished ("done"):
        neither enqueues anything, so a stale cancel never reaches a later
        session.  -> "unknown" | "done" | "cancelling"."""
        sess = self._sessions.get(rid)
        if sess is None:
            return "unknown"
        if sess.state == "done":
            return "done"
        self._cancels.add(rid)
        self._kick.set()
        return "cancelling"

    async def start(self) -> "AsyncSessionServer":
        if self._task is not None:
            raise RuntimeError("server already started")
        engine = self.backend.engine
        if engine.attn_kernels or engine.paged:
            from repro_torch.kernels import _build

            _build.build(SERVING_KERNELS)
        self._running = True
        self._task = asyncio.create_task(self._loop(), name="session-server")
        return self

    async def stop(self) -> None:
        self._running = False
        self._kick.set()
        if self._task is not None:
            await self._task
            self._task = None

    async def __aenter__(self) -> "AsyncSessionServer":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    async def drain(self) -> None:
        """Wait until every submitted session has finished."""
        for sess in list(self._sessions.values()):
            await sess._done.wait()

    def metrics_snapshot(self) -> dict:
        return self.metrics.snapshot(self)

    # --------------------------- scheduler task ---------------------------
    async def _loop(self) -> None:
        worker = self.worker
        while self._running:
            self._admit_arrivals()
            self._apply_cancels()
            tick = self._take_tick()
            if not worker.has_work():
                if self.split and (tick["arrivals"] or tick["cancels"]):
                    await asyncio.to_thread(self._run_tick, tick, False)
                # idle: park until a submit or cancel kicks the loop (a
                # split server sends an empty tick every HEARTBEAT_S)
                self._kick.clear()
                if not self._arrivals and not self._cancels and self._running:
                    if not self.split:
                        await self._kick.wait()
                        continue
                    try:
                        await asyncio.wait_for(self._kick.wait(), HEARTBEAT_S)
                    except asyncio.TimeoutError:
                        await asyncio.to_thread(self._run_tick, self._take_tick(), False)
                continue
            if await asyncio.to_thread(self._run_tick, tick, True):
                # the head of the queue can never be admitted (the pool is
                # too small even empty): reject that session, keep serving
                self._reject_head()
            self._publish()
            self.metrics_log.append(self.metrics.snapshot(self))
        if self.split:
            tick = self._take_tick()
            tick["stop"] = True
            await asyncio.to_thread(self._run_tick, tick, False)

    def _take_tick(self) -> dict:
        tick, self._tick = self._tick, {"arrivals": [], "cancels": [], "stop": False}
        return tick

    def _run_tick(self, tick: dict, step: bool) -> bool:
        """In the pool thread: broadcast the tick to the follower ranks
        (split server), then step.  -> whether the queue head was
        rejected."""
        if self.split:
            CTX.decide(tick)
            self.ticks += 1
        return step and step_or_reject(self.worker)

    def _admit_arrivals(self) -> None:
        while self._arrivals:
            sess = self._arrivals.popleft()
            req = sess.request
            if req.rid in self._cancels:
                self._cancels.discard(req.rid)
                self._finish_session(sess, "cancelled")
                self.metrics.cancelled += 1
                continue
            admit(self.worker, sess.submitted_s, req)
            self._tick["arrivals"].append((sess.submitted_s, req))
            sess.state = "running"

    def _apply_cancels(self) -> None:
        for rid in sorted(self._cancels):
            self._cancels.discard(rid)
            sess = self._sessions.get(rid)
            if sess is None or sess.state == "done":
                continue
            self._tick["cancels"].append(rid)
            if self.worker.cancel(rid) is None and sess.state != "queued":
                continue  # finished in the same tick: the completion wins
            self._finish_session(sess, "cancelled")
            self.metrics.cancelled += 1

    def _reject_head(self) -> None:
        worker = self.worker
        if not worker.waiting:
            return
        pend = worker.waiting.pop(0)
        sess = self._sessions.get(pend.rid)
        if sess is not None:
            self._finish_session(sess, "rejected")
            self.metrics.rejected += 1

    def _publish(self) -> None:
        """Stream everything the last tick produced."""
        now = self.now()
        generated = self.backend.generated
        for rid, sess in self._sessions.items():
            if sess.state != "running":
                continue
            toks = generated.get(rid)
            if toks is None:
                continue
            emitted = self._emitted.get(rid, 0)
            # a preempted request regenerates its stream from the start
            # (deterministically): emit only past the watermark
            for i in range(emitted, len(toks)):
                if sess.first_token_s is None:
                    sess.first_token_s = now
                    self.metrics.ttft_s.append(now - sess.submitted_s)
                else:
                    self.metrics.tbt_s.append(now - self._last_emit[rid])
                self._last_emit[rid] = now
                sess._emit(StreamEvent(rid=rid, index=i, token=toks[i], t_s=now))
            if len(toks) > emitted:
                self._emitted[rid] = len(toks)
        done = self.worker.done
        for c in done[self._n_done_seen:]:
            sess = self._sessions.get(c.rid)
            if sess is not None and sess.state == "running":
                self._finish_session(sess, c.reason)
                self.metrics.completed += 1
        self._n_done_seen = len(done)

    def _finish_session(self, sess: Session, reason: str) -> None:
        sess.state = "done"
        toks = tuple(self.backend.generated.get(sess.rid, ()))
        now = self.now()
        sess.completion = Completion(rid=sess.rid, tokens=toks, reason=reason,
                                     submitted_s=sess.submitted_s,
                                     first_token_s=sess.first_token_s, done_s=now)
        self._emitted.pop(sess.rid, None)
        self._last_emit.pop(sess.rid, None)
        sess._emit(StreamEvent(rid=sess.rid, index=len(toks), token=None, t_s=now,
                               finished=True, reason=reason))


# ------------------------------ trace driving ------------------------------
async def replay(server: AsyncSessionServer,
                 submits: Sequence[Tuple[float, SubmitRequest]],
                 speed: float = 0.0) -> Dict[int, Completion]:
    """Drive ``(arrival_s, request)`` pairs through a server.

    ``speed == 0``: every request is staged before the loop starts,
    stamped with its trace arrival time, so scheduling and decoded tokens
    are the closed-loop runner's on the same trace.  ``speed > 0``:
    open loop, the trace's arrival gaps (divided by `speed`) are slept for
    real and submissions race the scheduler on the wall clock."""
    ordered = sorted(submits, key=lambda ar: (ar[0], ar[1].rid))
    if speed <= 0:
        for arrival_s, req in ordered:
            server.submit(req, arrival_s=arrival_s)
        async with server:
            await server.drain()
    else:
        async with server:
            t_start = server.now()
            base = ordered[0][0] if ordered else 0.0
            for arrival_s, req in ordered:
                delay = t_start + (arrival_s - base) / speed - server.now()
                if delay > 0:
                    await asyncio.sleep(delay)
                server.submit(req)
            await server.drain()
    return {rid: sess.completion for rid, sess in server._sessions.items()}


def serve_trace(backend, config: ServeConfig,
                submits: Sequence[Tuple[float, SubmitRequest]],
                speed: float = 0.0) -> Tuple[Dict[int, Completion], AsyncSessionServer]:
    """Build a server, replay a trace, stop.  -> (completions by rid, the
    stopped server: its `worker` and `metrics_log` hold the run's
    scheduling record)."""
    server = AsyncSessionServer(backend, config)
    completions = asyncio.run(replay(server, submits, speed=speed))
    return completions, server
