"""Port parity for the asyncio session server (`serving/server.py`) and
the session protocol of `serving/api.py`: the JAX package's
`tests/test_server.py` on the port (its two tests of the per-knob shims
have no counterpart: the port never had them).

* The server is a front end, not a scheduler: a speed-0 replay decodes
  the port's closed-loop tokens and the JAX server's, under both
  schedulers with the block store off and on.  The trace arrives in two
  waves (t = 0 and t = 1000 s), so both packages form the same batches
  whatever their step times, and the second wave meets a warm store.
* Cancel rolls the pool back through the preemption seams (queued,
  mid-prefill, mid-decode): no page held, the store's references given
  back, the ownership partition intact, and every store block's arena
  slots still the bytes written at its admission.
* Stop sequences, ``max_tokens`` and seeded sampling bound and replay the
  stream; `ServeConfig` rejects the simulator's invalid combinations.
"""
import asyncio

import jax
import numpy as np
import pytest
import torch

from repro.serving import api as JAPI
from repro.serving import workload as JWL
from repro.serving.server import serve_trace as jax_serve_trace
from repro_torch.core.rcllm import make_tiny_system, tiny_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import api as API
from repro_torch.serving import workload as WL
from repro_torch.serving.batching import PendingRequest, WorkerState
from repro_torch.serving.block_store import (SharedBlockStore, check_partition,
                                             dequantize_rows)
from repro_torch.serving.server import AsyncSessionServer, replay, serve_trace

N_REQ, WAVE1, DECODE_STEPS = 6, 3, 3


@pytest.fixture(scope="module")
def systems():
    # the launcher's rcllm system, as `tests/test_torch_serving.py` builds it
    from repro.core.rcllm import make_tiny_system as jax_tiny
    jsys, pool_rv, prof, _ = jax_tiny(n_items=80, n_requests_hist=40, k_instances=1,
                                      n_layers=2, d_model=32)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jsys.params),
                              tiny_config(2, 32), device="cpu")
    tsys, _, _, _ = make_tiny_system(n_items=80, n_requests_hist=40, k_instances=1,
                                     n_layers=2, d_model=32, device="cpu", model=model)
    return jsys, tsys, pool_rv, prof


def _workload(wl, system, pool_rv, prof):
    """The reference test's heavy-tail trace (repeat users, long prompts),
    restamped into two arrival waves."""
    trace = wl.heavy_tail_trace(system.catalog, pool_rv, prof, N_REQ, qps=8.0, n_users=3,
                                long_prompt_frac=0.4, long_prompt_reviews=6, seed=5)
    pend, plans = wl.rcllm_workload(system, trace, decode_steps=DECODE_STEPS)
    pend = [type(p)(0.0 if p.rid < WAVE1 else 1e3, p.rid, p.n_tokens, p.decode_steps,
                    p.tokens) for p in pend]
    return pend, plans, wl.rcllm_reuse_info(system, trace, plans)


@pytest.fixture(scope="module")
def work(systems):
    jsys, tsys, pool_rv, prof = systems
    return _workload(JWL, jsys, pool_rv, prof), _workload(WL, tsys, pool_rv, prof)


@pytest.fixture
def admitted(monkeypatch):
    """key -> (k, v): the fp32 bytes the store wrote for that block at its
    latest admission (`tests/test_torch_block_store.py`'s tap)."""
    kept = {}
    admit = SharedBlockStore._admit

    def tap(store, key, kind, data_k, data_v, scale_k, scale_v, *a, **kw):
        blk = admit(store, key, kind, data_k, data_v, scale_k, scale_v, *a, **kw)
        if blk is not None:
            kept[key] = tuple(d.float().clone() if s is None else dequantize_rows(d, s)
                              for d, s in ((data_k, scale_k), (data_v, scale_v)))
        return blk

    monkeypatch.setattr(SharedBlockStore, "_admit", tap)
    return kept


def _build(tsys, scfg, plans=None, reuse=None):
    engine = API.build_engine(tsys.model, tsys.cfg, scfg, cache=tsys.rows)
    return engine, API.build_backend(engine, scfg, plans=plans, reuse=reuse)


def _submits(api, pend, plans, reuse=None, max_tokens=None, stop=None,
             sampling=None):
    return [(p.arrival_s, api.SubmitRequest(
        rid=p.rid, tokens=p.tokens,
        max_tokens=(max_tokens or {}).get(p.rid, p.decode_steps),
        stop=(stop or {}).get(p.rid, ()),
        sampling=sampling or api.GREEDY,
        context=plans.get(p.rid), reuse=(reuse or {}).get(p.rid))) for p in pend]


def _assert_clean(engine, admitted=None):
    assert engine.pool.stats().pages_in_use == 0
    assert not engine.prefill_states and not engine.store_refs
    check_partition(engine.pool, engine.store)
    if engine.store is None:
        assert engine.pool.free_pages == engine.pool.n_pages - 1
        return
    store_pages = sum(len(b.pages) for b in engine.store.blocks.values())
    assert engine.pool.free_pages == engine.pool.n_pages - 1 - store_pages
    for blk in engine.store.blocks.values():
        assert blk.refcount == 0
        if admitted is not None:
            sl = torch.from_numpy(blk.slots)
            pages, slots = sl // engine.pool.page_size, sl % engine.pool.page_size
            want_k, want_v = admitted[blk.key]
            assert torch.equal(engine.pool.arena_k[pages, slots], want_k), blk.key
            assert torch.equal(engine.pool.arena_v[pages, slots], want_v), blk.key


# ------------------------------------------- closed-loop token parity
@pytest.mark.parametrize("sched", ["wave", "chunked"])
@pytest.mark.parametrize("kv_reuse", [False, True])
def test_server_replay_matches_closed_loop_and_reference(systems, work, admitted,
                                                         sched, kv_reuse):
    """A speed-0 replay through the port's server decodes every session as
    the port's closed-loop batcher on the same trace, and as the JAX
    package's server."""
    jsys, tsys, _, _ = systems
    (pend_j, plans_j, reuse_j), (pend, plans, reuse) = work
    scfg = API.ServeConfig(sched=sched, kv_reuse=kv_reuse, n_pages=256, chunk_tokens=64)
    eng_ref, backend_ref = _build(tsys, scfg, plans=plans,
                                  reuse=reuse if kv_reuse else None)
    done_ref = API.build_batcher(backend_ref, scfg).run(list(pend))
    assert len(done_ref) == N_REQ
    closed = {rid: tuple(t) for rid, t in backend_ref.generated.items()}
    _assert_clean(eng_ref, admitted)

    engine, backend = _build(tsys, scfg)
    completions, server = serve_trace(
        backend, scfg, _submits(API, pend, plans, reuse if kv_reuse else None))
    assert {rid: c.tokens for rid, c in completions.items()} == closed
    for comp in completions.values():
        assert comp.reason == "length" and comp.ttft_s is not None
    assert server.metrics.completed == N_REQ == len(server.worker.done)
    for c in server.worker.done:
        assert c.arrival_s <= c.first_token_s <= c.done_s
    if kv_reuse:
        st = engine.store.stats()      # the second wave meets a warm store
        assert st["hits_user"] + st["hits_item"] + st["hits_prefix"] > 0
    _assert_clean(engine, admitted)

    jcfg = JAPI.ServeConfig(engine="jax", sched=sched, kv_reuse=kv_reuse, n_pages=256,
                            chunk_tokens=64)
    jeng = JAPI.build_engine(jsys.params, jsys.cfg, jcfg)
    jdone, _ = jax_serve_trace(JAPI.build_backend(jeng, jcfg), jcfg, _submits(
        JAPI, pend_j, plans_j, reuse_j if kv_reuse else None))
    assert {rid: c.tokens for rid, c in jdone.items()} == closed
    if kv_reuse:
        jst, st = jeng.store.stats(), engine.store.stats()
        for key in ("hits_user", "hits_item", "hits_prefix", "inserts"):
            assert st[key] == jst[key], key


def test_stream_events_well_formed(systems, work):
    """Each session's stream: one event per token with contiguous indices,
    then exactly one finished event carrying the reason."""
    _, tsys, _, _ = systems
    _, (pend, plans, _) = work
    scfg = API.ServeConfig(sched="chunked", n_pages=256, chunk_tokens=64)
    _, backend = _build(tsys, scfg)

    async def drive():
        server = AsyncSessionServer(backend, scfg)
        sessions = [server.submit(req, arrival_s=t) for t, req in _submits(API, pend, plans)]
        events = {s.rid: [] for s in sessions}
        async with server:
            for sess in sessions:
                async for ev in sess:
                    events[sess.rid].append(ev)
        return sessions, events

    sessions, events = asyncio.run(drive())
    for sess in sessions:
        evs = events[sess.rid]
        assert [e.finished for e in evs] == [False] * (len(evs) - 1) + [True]
        assert [e.index for e in evs[:-1]] == list(range(len(evs) - 1))
        assert evs[-1].reason == "length" and evs[-1].token is None
        assert tuple(e.token for e in evs[:-1]) == sess.completion.tokens
        assert len(sess.completion.tokens) == sess.request.max_tokens


# ------------------------------------------------------- cancellation
def test_cancel_queued_session(systems, work):
    """A cancel that lands before admission finishes the session as
    'cancelled' without the request ever touching the engine."""
    _, tsys, _, _ = systems
    _, (pend, plans, _) = work
    scfg = API.ServeConfig(sched="chunked", n_pages=256)
    engine, backend = _build(tsys, scfg)
    server = AsyncSessionServer(backend, scfg)
    sess = server.submit(API.SubmitRequest(rid=7, tokens=pend[0].tokens,
                                           context=plans[pend[0].rid]))
    assert sess.cancel() == "cancelling"

    async def drive():
        async with server:
            return await sess.result()

    comp = asyncio.run(drive())
    assert comp.reason == "cancelled" and comp.tokens == () and comp.ttft_s is None
    assert server.metrics.cancelled == 1 and 7 not in backend.generated
    _assert_clean(engine)


def test_cancel_waiting_and_mid_prefill_rolls_back(systems, work, admitted):
    """`WorkerState.cancel` between chunks (the store on): the chunk state,
    pages and store references go back (`preempt_prefill`, then `finish`)
    and the partition holds; a request still in the worker's queue is just
    dequeued; a second cancel is a no-op."""
    _, tsys, _, _ = systems
    _, (pend, plans, reuse) = work
    scfg = API.ServeConfig(sched="chunked", kv_reuse=True, n_pages=256, chunk_tokens=64)
    engine, backend = _build(tsys, scfg, plans=plans, reuse=reuse)
    worker = WorkerState(backend, sched="chunked", chunk_tokens=64)
    victim = max(pend, key=lambda p: p.n_tokens)
    late = next(p for p in pend if p.rid != victim.rid)
    worker.waiting += [PendingRequest(0.0, victim.rid, victim.n_tokens, victim.decode_steps,
                                      victim.tokens),
                       PendingRequest(5.0, late.rid, late.n_tokens, late.decode_steps,
                                      late.tokens)]
    worker.step()                      # admits the victim and runs its first chunks
    assert victim.rid in engine.prefill_states and engine.store_refs[victim.rid]
    assert not engine.prefill_states[victim.rid].cp.scan_done
    assert worker.cancel(late.rid) == "waiting"
    assert worker.cancel(victim.rid) == "prefilling"
    assert not worker.has_work() and victim.rid not in backend.last_token
    assert worker.cancel(victim.rid) is None
    _assert_clean(engine, admitted)


def test_cancel_mid_decode(systems, work, admitted):
    """Cancelling a decoding session through its client handle: its stream
    ends 'cancelled' after the tokens already sent, every other session
    completes, and the store-backed pool is clean."""
    _, tsys, _, _ = systems
    _, (pend, plans, reuse) = work
    scfg = API.ServeConfig(sched="chunked", kv_reuse=True, n_pages=256, chunk_tokens=64)
    engine, backend = _build(tsys, scfg)
    victim = pend[0].rid

    async def drive():
        server = AsyncSessionServer(backend, scfg)
        sessions = {}
        async with server:
            for t, req in _submits(API, pend, plans, reuse, max_tokens={victim: 64}):
                sessions[req.rid] = server.submit(req, arrival_s=t)
            got = 0
            async for ev in sessions[victim]:
                if ev.finished:
                    break
                got += 1
                if got == 2:
                    sessions[victim].cancel()
            await server.drain()
        return server, sessions

    server, sessions = asyncio.run(drive())
    comp = sessions[victim].completion
    assert comp.reason == "cancelled" and 2 <= len(comp.tokens) < 64
    for rid, sess in sessions.items():
        if rid != victim:
            assert sess.completion.reason == "length"
            assert len(sess.completion.tokens) == sess.request.max_tokens
    assert server.metrics.cancelled == 1
    _assert_clean(engine, admitted)


def test_cancel_after_completion_is_idempotent_noop(systems, work):
    """Cancelling a finished (or never-submitted) session reports
    'done' / 'unknown' and enqueues nothing."""
    _, tsys, _, _ = systems
    _, (pend, plans, _) = work
    scfg = API.ServeConfig(sched="chunked", n_pages=256, chunk_tokens=64)
    engine, backend = _build(tsys, scfg)
    completions, server = serve_trace(backend, scfg, _submits(API, pend, plans))
    assert len(completions) == N_REQ
    for rid in completions:
        assert server.cancel(rid) == "done"
        assert server.cancel(rid) == "done"
    assert server.cancel(10**9) == "unknown"
    assert not server._cancels and server.metrics.cancelled == 0
    assert all(c.reason == "length" for c in completions.values())
    _assert_clean(engine)


# --------------------------------------- stop sequences / max_tokens
@pytest.mark.parametrize("sched", ["wave", "chunked"])
def test_stop_sequence_ends_stream(systems, work, sched):
    """A stop sequence taken from the greedy stream ends generation the
    moment the stream ends with it (the matching token kept), reason
    'stop'; every other session is unchanged."""
    _, tsys, _, _ = systems
    _, (pend, plans, _) = work
    scfg = API.ServeConfig(sched=sched, n_pages=256, chunk_tokens=64)
    _, backend_ref = _build(tsys, scfg)
    ref, _ = serve_trace(backend_ref, scfg, _submits(API, pend, plans))
    rid = next(r for r in sorted(ref) if len(ref[r].tokens) >= 3)
    stop_seq = ref[rid].tokens[1:2]
    engine, backend = _build(tsys, scfg)
    completions, _ = serve_trace(backend, scfg,
                                 _submits(API, pend, plans, stop={rid: (stop_seq,)}))
    assert completions[rid].reason == "stop"
    assert completions[rid].tokens == ref[rid].tokens[:2]
    for other in ref:
        if other != rid:
            assert completions[other].tokens == ref[other].tokens
    _assert_clean(engine)


def test_max_tokens_bounds_stream(systems, work):
    """`max_tokens` is the whole generated budget: 1 is prefill's token
    only, N exactly N, reason 'length'."""
    _, tsys, _, _ = systems
    _, (pend, plans, _) = work
    scfg = API.ServeConfig(sched="chunked", n_pages=256, chunk_tokens=64)
    budgets = {p.rid: 1 + (i % 3) for i, p in enumerate(pend)}
    engine, backend = _build(tsys, scfg)
    completions, _ = serve_trace(backend, scfg, _submits(API, pend, plans,
                                                         max_tokens=budgets))
    for rid, comp in completions.items():
        assert len(comp.tokens) == budgets[rid] and comp.reason == "length"
    _assert_clean(engine)


# ------------------------------------------------------------ sampling
def test_sampling_replays_from_seed(systems, work):
    """temperature > 0: one seed replays the same streams on fresh engines;
    another seed changes at least one stream."""
    _, tsys, _, _ = systems
    _, (pend, plans, _) = work
    scfg = API.ServeConfig(sched="chunked", n_pages=256, chunk_tokens=64)

    def run(seed):
        engine, backend = _build(tsys, scfg)
        sp = API.SamplingParams(temperature=1.0, top_k=4, seed=seed)
        completions, _ = serve_trace(backend, scfg, _submits(API, pend, plans, sampling=sp))
        _assert_clean(engine)
        return {rid: c.tokens for rid, c in completions.items()}

    a, b, c = run(7), run(7), run(8)
    assert a == b and a != c


def test_sample_token_greedy_and_topk():
    logits = np.asarray([0.1, 3.0, -1.0, 2.9])
    assert API.sample_token(logits) == 1
    rng = np.random.default_rng(0)
    sp = API.SamplingParams(temperature=0.5, top_k=2, seed=0)
    assert {API.sample_token(logits, sp, rng) for _ in range(64)} <= {1, 3}
    assert API.match_stop([5, 6, 7], [(6, 7)])
    assert not API.match_stop([5, 6, 7], [(5, 6)])
    assert not API.match_stop([7], [(6, 7)])
    with pytest.raises(ValueError, match="max_tokens"):
        API.SubmitRequest(rid=0, tokens=np.zeros(3, np.int32), max_tokens=0)
    with pytest.raises(ValueError, match="empty stop"):
        API.SubmitRequest(rid=0, tokens=np.zeros(3, np.int32), stop=((),))


# ----------------------------------------------------- config surface
def test_serveconfig_rejects_invalid_combos():
    """The reference's rejections, with the port's engine name."""
    with pytest.raises(ValueError, match="kv_reuse"):
        API.ServeConfig(engine="sim", kv_reuse=True)
    with pytest.raises(ValueError, match="chunked"):
        API.ServeConfig(engine="sim", sched="chunked")
    with pytest.raises(ValueError, match="prefix"):
        API.ServeConfig(engine="torch", mode="prefix")
    with pytest.raises(ValueError, match="engine='torch'"):
        API.ServeConfig(engine="sim", k=2, disagg=API.DisaggConfig(1, 1))
    with pytest.raises(ValueError, match="engine='torch'"):
        API.ServeConfig(engine="sim", store=API.StoreConfig(kv_store_dtype="int8"))
    with pytest.raises(ValueError, match="kv_reuse"):
        API.ServeConfig(mode="full", kv_reuse=True)
    with pytest.raises(ValueError, match="not in"):
        API.ServeConfig(engine="jax")
    with pytest.raises(ValueError, match="k="):
        API.ServeConfig(k=0)
    assert API.ServeConfig(engine="sim", k=8, mode="prefix").mode == "prefix"
    cfg = API.ServeConfig(chunk_tokens=64)
    assert cfg.resolved_step_tokens == 512
    assert cfg.replace(step_tokens=192).resolved_step_tokens == 192


def test_config_parse_spec():
    cfg = API.ServeConfig.parse("sched=chunked,kv_reuse=on,n_pages=128")
    assert cfg.sched == "chunked" and cfg.kv_reuse and cfg.n_pages == 128
    sim = API.ServeConfig.parse("engine=sim,k=40,mode=prefix")
    assert (sim.engine, sim.k, sim.mode) == ("sim", 40, "prefix")
    assert API.ServeConfig.parse(sim.render()) == sim
    with pytest.raises(ValueError, match="not a ServeConfig field"):
        API.ServeConfig.parse("pages=128")
    with pytest.raises(ValueError, match="key=value"):
        API.ServeConfig.parse("chunked")


# --------------------------------------------------- server guardrails
def test_server_rejects_multiworker_and_duplicate_rid(systems, work):
    _, tsys, _, _ = systems
    _, (pend, _, _) = work
    scfg = API.ServeConfig(n_pages=256)
    _, backend = _build(tsys, scfg)
    with pytest.raises(ValueError, match="one worker"):
        AsyncSessionServer(backend, scfg.replace(k=2))
    server = AsyncSessionServer(backend, scfg)
    req = API.SubmitRequest(rid=1, tokens=pend[0].tokens)
    server.submit(req)
    with pytest.raises(ValueError, match="duplicate"):
        server.submit(req)


def test_replay_speed_gt0_preserves_tokens(systems, work):
    """Open-loop (wall-clock) submission changes when work is admitted,
    not what a request computes: the speed-0 tokens, and a clean pool."""
    _, tsys, _, _ = systems
    _, (pend, plans, _) = work
    scfg = API.ServeConfig(sched="chunked", n_pages=256, chunk_tokens=64)
    _, backend_ref = _build(tsys, scfg)
    ref, _ = serve_trace(backend_ref, scfg, _submits(API, pend, plans))
    engine, backend = _build(tsys, scfg)
    # the two waves 1000 s apart in trace time arrive 0.05 s apart here
    fast, server = serve_trace(backend, scfg, _submits(API, pend, plans), speed=2e4)
    assert {r: c.tokens for r, c in fast.items()} == {r: c.tokens for r, c in ref.items()}
    snap = server.metrics_snapshot()
    assert snap["completed"] == N_REQ and snap["ttft_p50_s"] is not None
    _assert_clean(engine)
    assert asyncio.run(replay(AsyncSessionServer(backend, scfg), [], speed=1.0)) == {}
