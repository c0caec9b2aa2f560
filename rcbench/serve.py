"""One run of a cell: build the port's RcLLM system and session server
from the run's inputs, drive it with the cell's traffic, and record what
the metrics and the correctness check read.

The system is built through the API the port's launcher uses
(`core.rcllm.RcLLMSystem.build`, `serving.api.build_engine` /
`build_backend`) and served by `serving.server.AsyncSessionServer`.  A
request is prepared when it is due, inside the timed traffic (routing,
`plan_for`, `cached_kv`: what a front end pays per request), then
submitted.  The same traffic runs for the traffic file's `warmup_s`
before the window, so the window opens on a server in its steady state
with every shape it will see already run once; that time counts as
set-up."""
from __future__ import annotations

import asyncio
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from rcbench import cell as C
from rcbench import gen
from rcbench import weights as W

def log(msg: str) -> None:
    """A progress line on standard error, stamped with the process clock."""
    print(f"rcbench [{time.perf_counter():9.2f}] {msg}", file=sys.stderr, flush=True)


DRAIN_S = 60.0     # how long past the window's close an answer may come


@dataclass
class Req:
    """One request's record, on the server's clock (seconds); `rid` is
    also its index in the world's stream of requests."""
    rid: int
    due: float
    prep_start: float = math.nan
    submit: float = math.nan
    n: int = 0
    times: List[float] = field(default_factory=list)
    tokens: List[int] = field(default_factory=list)
    reason: Optional[str] = None
    done: float = math.nan
    recompute: Optional[np.ndarray] = None   # the engine's recompute mask
    table: Optional[np.ndarray] = None       # the plan's cached rows
    have: Optional[np.ndarray] = None

    def finished(self, n_out: int) -> bool:
        return self.reason == "length" and len(self.tokens) == n_out


@dataclass
class Run:
    """What one run recorded: the readers of `rcbench/metrics` and the
    correctness check read it."""
    cell: C.Cell
    seed: int
    t0: float                      # window [t0, t1) on the server's clock
    t1: float
    reqs: List[Req]
    ticks: list                    # the worker's tick records in the window
    completions: Dict[int, object]  # rid -> the worker's batching.Completion
    spans: List[tuple]             # (name, start, end) of the harness's calls
    n_out: int
    setup_s: float = 0.0
    t0_perf: float = 0.0           # the window's start on the process clock
    trace: object = None           # trace.Window of a --trace 1 run
    world: object = None

    def in_window(self, t: float) -> bool:
        return self.t0 <= t < self.t1

    def window_reqs(self) -> List[Req]:
        """The requests the window is judged on: due in it (open loop) or
        sent in it (closed loop)."""
        return [r for r in self.reqs if self.in_window(r.due)]


def serve_config(cell: C.Cell):
    from repro_torch.serving.api import ServeConfig

    s, t = cell.config["serve"], cell.traffic["serve"]
    return ServeConfig(
        k=1, mode="rcllm", sched=t["sched"], chunk_tokens=t["chunk_tokens"],
        step_tokens=t["step_tokens"], kv_reuse=bool(t["kv_reuse"]),
        max_decode_batch=t["max_decode_batch"], page_size=s["page_size"],
        n_pages=s["n_pages"], decode_steps=cell.traffic["output_tokens"],
        r_item=t["r_item"], r_rev=t["r_rev"])


def n_requests_needed(traffic: dict, seconds: float) -> int:
    """Requests to draw: enough for the warm-up and the window at the
    most a loop can send."""
    span = traffic["warmup_s"] + seconds
    if traffic["loop"] == "open":
        return int(math.ceil(span * traffic["rate_per_s"])) + 1
    return int(math.ceil(span * traffic["max_rate_per_s"])) + traffic["clients"]


class System:
    """The port built over one run's inputs."""

    def __init__(self, cell: C.Cell, seed: int, seconds: float, device):
        import torch

        from repro_torch.core.rcllm import RcLLMSystem
        from repro_torch.serving.api import build_backend, build_engine

        self.cell = cell
        self.cfg = C.lm_config(cell.config)
        self.config = serve_config(cell)
        self.weights = W.draw(cell.config, seed, device)
        model = W.port_model(self.cfg, self.weights)
        log("weights drawn")
        self.world = gen.world(cell.traffic, seed, n_requests_needed(cell.traffic, seconds))
        log(f"world made: {len(self.world.requests)} requests, {len(self.world.corpus)} documents")
        with torch.no_grad():
            self.system = RcLLMSystem.build(
                model, self.cfg, self.world.catalog, self.world.corpus, self.world.history,
                k_instances=1, n_instruction=cell.traffic["world"]["instruction_tokens"],
                seed=self.world.lsh_seed)
        log(f"offline build done: {self.system.rows.n_rows} cached rows")
        if not np.array_equal(self.system.instruction, self.world.instruction):
            raise RuntimeError("the port's instruction differs from the benchmark's")
        self.engine = build_engine(model, self.cfg, self.config, cache=self.system.rows)
        self.backend = build_backend(self.engine, self.config)

    def prepare(self, rid: int):
        """Route request `rid` of the stream, build its plan and block
        table.  -> (SubmitRequest, table, have)."""
        from repro_torch.serving.api import SubmitRequest

        rq = self.world.requests[rid]
        inst = self.system.best_instance(rq)
        plan = self.system.plan_for(rq, inst)
        table, positions, have = self.system.cached_kv(plan, inst)
        sub = SubmitRequest(rid=rid, tokens=plan.tokens,
                            max_tokens=self.cell.traffic["output_tokens"],
                            context=(plan, table, positions, have))
        return sub, table, have

    def free(self) -> None:
        """Drop everything the port holds but the drawn weights."""
        self.backend = self.engine = self.system = None


async def _consume(sess, r: Req, stats: Dict) -> None:
    async for ev in sess:
        if ev.finished:
            r.reason, r.done = ev.reason, ev.t_s
            break
        if not r.times:
            st = stats.get(r.rid)
            if st is not None:
                r.recompute = st.recompute_mask
        r.times.append(ev.t_s)
        r.tokens.append(ev.token)


async def drive(sysm: System, seed: int, seconds: float, tracer=None) -> Run:
    """Serve the cell's traffic: `warmup_s` of it, then the window of
    `seconds`; wait for the window's answers; stop the server."""
    from repro_torch.serving.server import AsyncSessionServer

    traffic = sysm.cell.traffic
    n_out = traffic["output_tokens"]
    if tracer is not None:
        # the profiler starts while this thread alone drives the card: a
        # session started while the server's worker thread launches kernels
        # can lose every kernel record of that thread (`trace.Tracer`)
        tracer.start()
    server = AsyncSessionServer(sysm.backend, sysm.config)
    await server.start()
    log("server started")
    stats = sysm.engine.last_stats
    reqs: List[Req] = []
    spans: List[tuple] = []
    tasks: List[asyncio.Task] = []
    warm = float(traffic["warmup_s"])
    t_start = server.now() + 0.05
    t0 = t_start + warm
    t1 = t0 + seconds
    marks = {}

    def send(due: float):
        r = Req(rid=len(reqs), due=due)
        r.prep_start = server.now()
        sub, r.table, r.have = sysm.prepare(r.rid)
        r.n = len(sub.tokens)
        sess = server.submit(sub)
        r.submit = sess.submitted_s
        spans.append(("prepare", r.prep_start, r.submit))
        reqs.append(r)
        return r, sess

    async def window_marks():
        await asyncio.sleep(max(0.0, t0 - server.now()))
        marks["perf0"] = time.perf_counter()
        marks["ticks0"] = len(server.worker.ticks)
        if tracer is not None:
            tracer.mark(server.now())
        await asyncio.sleep(max(0.0, t1 - server.now()))
        marks["ticks1"] = len(server.worker.ticks)
        if tracer is not None:
            tracer.mark()

    marker = asyncio.create_task(window_marks())
    if traffic["loop"] == "open":
        dues = gen.due_times(warm + seconds, traffic["rate_per_s"],
                             traffic["arrival_seed"]) + t_start
        for due in dues:
            delay = due - server.now()
            if delay > 0:
                await asyncio.sleep(delay)
            r, sess = send(float(due))
            tasks.append(asyncio.create_task(_consume(sess, r, stats)))
    else:
        async def client():
            while server.now() < t1:
                r, sess = send(server.now())
                await _consume(sess, r, stats)

        await asyncio.sleep(max(0.0, t_start - server.now()))
        tasks = [asyncio.create_task(client()) for _ in range(traffic["clients"])]
    await marker
    log(f"window closed: {len(reqs)} requests sent")
    _, pending = await asyncio.wait(tasks, timeout=max(0.0, t1 + DRAIN_S - server.now()))
    for t in pending:
        t.cancel()
    for r in reqs:
        if r.reason is None:
            server.cancel(r.rid)
    await asyncio.gather(*pending, return_exceptions=True)
    await server.stop()
    log(f"drained: {sum(r.reason is not None for r in reqs)} of {len(reqs)} answered")
    worker = server.worker
    ticks = worker.ticks[marks["ticks0"]:marks["ticks1"]]
    # each tick's host interval: the server logs a snapshot after every
    # tick it publishes, and the worker records the tick's seconds
    logs = list(server.metrics_log)
    for snap, tk in zip(logs, worker.ticks[len(worker.ticks) - len(logs):]):
        spans.append(("tick", snap["t_s"] - tk.seconds, snap["t_s"]))
    done = {c.rid: c for c in worker.done}
    return Run(cell=sysm.cell, seed=seed, t0=t0, t1=t1, reqs=reqs, ticks=ticks,
               completions=done, spans=spans, n_out=n_out, world=sysm.world,
               t0_perf=marks["perf0"])
