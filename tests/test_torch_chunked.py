"""Port parity for the chunked (unified-step) serving path: the
chunk-resumable selective prefill, the budgeted engine tick, the chunked
scheduler and the pool's private remapping, against the JAX package on
the same weights (its init converted through numpy) and the same traces.

Tolerances: the two packages' fp32 arithmetic differs in summation order,
so logits are held to 1e-4 and merged KV to 1e-5 (as in
`tests/test_torch_engine.py`); recompute masks and greedy tokens must be
equal.  Chunked against monolithic inside the port is held to the same
tolerances, not bitwise (ROADMAP queue C: the reference's own bitwise form
of that check fails)."""
import dataclasses
import json

import jax
import numpy as np
import pytest

from repro.core import engine as JENG
from repro.data import synth as JSY
from repro.serving import api as JAPI
from repro.serving.workload import rcllm_workload as jax_workload
from repro_torch.core import engine as TENG
from repro_torch.core.rcllm import make_tiny_system, tiny_config
from repro_torch.data import synth as TSY
from repro_torch.launch import serve as PS
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.api import ServeConfig
from repro_torch.serving.batch_engine import BatchEngine, BatchRequest
from repro_torch.serving.batching import (ContinuousBatcher, PendingRequest,
                                          TorchEngineBackend)
from repro_torch.serving.kv_pool import PagedKVPool, pool_for
from repro_torch.serving.workload import rcllm_workload

LOGIT_TOL = 1e-4
KV_TOL = 1e-5
DECODE_STEPS = 3


def _trace(SY, system, pool_rv, prof, n=6, seed=5):
    """The reference's heavy-tail trace (`workload.heavy_tail_trace`): some
    prompts several times the base length, so scans take many chunks."""
    return SY.make_trace(system.catalog, pool_rv, prof, n, qps=8.0, n_users=3,
                         n_candidates=8, reviews_per_user=1, seed=seed,
                         long_prompt_frac=0.4, long_prompt_reviews=6)


@pytest.fixture(scope="module")
def systems():
    from repro.core.rcllm import make_tiny_system as jax_tiny
    jsys, pool_rv, prof, _ = jax_tiny(n_items=60, n_requests_hist=30, k_instances=2,
                                      n_layers=2, d_model=32)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jsys.params),
                              tiny_config(2, 32), device="cpu")
    tsys, _, _, _ = make_tiny_system(n_items=60, n_requests_hist=30, k_instances=2,
                                     n_layers=2, d_model=32, device="cpu", model=model)
    reqs_j, plans_j = jax_workload(jsys, _trace(JSY, jsys, pool_rv, prof),
                                   decode_steps=DECODE_STEPS)
    reqs_t, plans_t = rcllm_workload(tsys, _trace(TSY, tsys, pool_rv, prof),
                                     decode_steps=DECODE_STEPS)
    return jsys, tsys, (reqs_j, plans_j), (reqs_t, plans_t)


def _scan(cp):
    n_chunks = 0
    while not cp.scan_done:
        cp.run_chunk()
        n_chunks += 1
    assert n_chunks == -(-cp.n_pad // cp.chunk)


@pytest.mark.parametrize("chunk", [64, 96])
def test_chunked_prefill_matches_reference(systems, chunk):
    """The port's ChunkedPrefill against the reference's on the same
    plans: Eq. 3 masks equal, logits and merged KV allclose."""
    jsys, tsys, (_, plans_j), (_, plans_t) = systems
    sel_j, sel_t = JENG.SelectiveConfig(), TENG.SelectiveConfig()
    for rid in sorted(plans_t)[:3]:
        cj = JENG.ChunkedPrefill(jsys.params, jsys.cfg, *plans_j[rid], sel_j,
                                 chunk_tokens=chunk, bucket=64)
        ct = TENG.ChunkedPrefill(tsys.model, tsys.cfg, *plans_t[rid], tsys.rows, sel_t,
                                 chunk_tokens=chunk, bucket=64)
        _scan(cj)
        _scan(ct)
        np.testing.assert_array_equal(ct.recompute, cj.recompute)
        assert ct.recompute.any() and not ct.recompute.all()
        (lj, kj, vj), = JENG.selective_layers_batch(jsys.params, jsys.cfg, [cj.sel_item()])
        (lt, kt, vt), = TENG.selective_layers_batch(tsys.model, tsys.cfg, [ct.sel_item()],
                                                    tsys.rows)
        np.testing.assert_allclose(lt, lj, atol=LOGIT_TOL, rtol=LOGIT_TOL)
        np.testing.assert_allclose(kt.numpy(), kj, atol=KV_TOL, rtol=KV_TOL)
        np.testing.assert_allclose(vt.numpy(), vj, atol=KV_TOL, rtol=KV_TOL)
        np.testing.assert_allclose(ct.k0_full().numpy(), cj.k0_full(), atol=KV_TOL)


@pytest.mark.parametrize("chunk", [64, 128, 96])
def test_chunked_prefill_matches_monolithic(systems, chunk):
    """Inside the port, any chunk size (ragged tails included) gives the
    monolithic prefill's recompute set, and its logits and merged KV
    within the tolerances."""
    _, tsys, _, (_, plans_t) = systems
    sel = TENG.SelectiveConfig()
    for rid in sorted(plans_t)[:3]:
        (lm, sm, km, vm), = TENG.selective_prefill_batch(
            tsys.model, tsys.cfg, [plans_t[rid]], sel, tsys.rows, bucket=64)
        cp = TENG.ChunkedPrefill(tsys.model, tsys.cfg, *plans_t[rid], tsys.rows, sel,
                                 chunk_tokens=chunk, bucket=64)
        _scan(cp)
        (lc, kr, vr), = TENG.selective_layers_batch(tsys.model, tsys.cfg,
                                                    [cp.sel_item()], tsys.rows)
        np.testing.assert_array_equal(cp.recompute, sm.recompute_mask)
        np.testing.assert_allclose(lc, lm, atol=LOGIT_TOL, rtol=LOGIT_TOL)
        kc = np.concatenate([cp.k0_full().numpy()[:, None], kr[:cp.n].numpy()], axis=1)
        vc = np.concatenate([cp.v0_full().numpy()[:, None], vr[:cp.n].numpy()], axis=1)
        np.testing.assert_allclose(kc, km.numpy(), atol=KV_TOL, rtol=KV_TOL)
        np.testing.assert_allclose(vc, vm.numpy(), atol=KV_TOL, rtol=KV_TOL)


def _run_port(tsys, reqs, plans, sched, chunk_tokens=64, step_tokens=256):
    config = ServeConfig(sched=sched, chunk_tokens=chunk_tokens, step_tokens=step_tokens,
                         decode_steps=DECODE_STEPS)
    engine, backend, batcher, done = PS.serve(tsys.model, tsys.cfg, config, reqs,
                                              plans, tsys.rows)
    assert len(done) == len(reqs)
    assert engine.pool.stats().pages_in_use == 0 and not engine.prefill_states
    return backend.generated, batcher.workers[0]


def test_chunked_tokens_equal_reference_chunked_trace(systems):
    """Greedy tokens of the chunked scheduler on the heavy-tail trace equal
    the reference's chunked run, and the port's own wave run."""
    jsys, tsys, (reqs_j, plans_j), (reqs_t, plans_t) = systems
    cfg_j = JAPI.ServeConfig(engine="jax", mode="rcllm", sched="chunked",
                             chunk_tokens=64, step_tokens=256, decode_steps=DECODE_STEPS)
    eng = JAPI.build_engine(jsys.params, jsys.cfg, cfg_j,
                            sel=JENG.SelectiveConfig(window=16))
    backend_j = JAPI.build_backend(eng, cfg_j, plans=plans_j)
    done_j = JAPI.build_batcher(backend_j, cfg_j).run(list(reqs_j))
    gen_c, w = _run_port(tsys, reqs_t, plans_t, "chunked")
    assert len(done_j) == len(reqs_t)
    assert gen_c == backend_j.generated
    assert max(t.chunk_tokens for t in w.ticks) > 0 and len(w.ticks) > len(reqs_t)
    gen_w, _ = _run_port(tsys, reqs_t, plans_t, "wave")
    assert gen_w == gen_c


@pytest.mark.parametrize("chunk_tokens,step_tokens", [(64, 192), (128, 512), (128, 96)])
def test_tick_budget_property(systems, chunk_tokens, step_tokens):
    """Per-tick charges never exceed the step budget, except a tick that
    carries ONE indivisible oversized item (a finalize whose padded
    recompute budget beats the budget must not starve)."""
    _, tsys, _, (reqs_t, plans_t) = systems
    _, w = _run_port(tsys, reqs_t, plans_t, "chunked", chunk_tokens, step_tokens)
    assert w.ticks
    for t in w.ticks:
        prefill_charge = t.chunk_tokens + t.finalize_tokens
        room = max(0, step_tokens - t.decode_tokens)
        if not t.oversized:
            assert prefill_charge <= room
        else:
            assert prefill_charge > room
            assert t.chunk_tokens == 0 or t.finalize_tokens == 0


def _requests(plans, n_reserve=2):
    return [BatchRequest(rid=rid, tokens=p[0].tokens, plan=p[0], block_table=p[1],
                         positions=p[2], have=p[3], n_reserve=n_reserve)
            for rid, p in sorted(plans.items())]


def test_engine_step_random_budgets(systems):
    """Driving `BatchEngine.step` with random budgets respects the charge
    bound and finishes every request with the wave prefill's token."""
    _, tsys, _, (_, plans_t) = systems
    reqs = _requests(dict(list(sorted(plans_t.items()))[:4]))
    ref_eng = BatchEngine(tsys.model, tsys.cfg, pool=pool_for(tsys.cfg, device="cpu"),
                          cache=tsys.rows)
    ref = {r.rid: int(np.argmax(lg)) for r, lg in zip(reqs, ref_eng.prefill(reqs, "rcllm"))}
    rng = np.random.default_rng(0)
    eng = BatchEngine(tsys.model, tsys.cfg, pool=pool_for(tsys.cfg, device="cpu"),
                      cache=tsys.rows, chunk_tokens=64)
    for r in reqs:
        eng.begin_prefill(r)
    queue, got = [r.rid for r in reqs], {}
    for _ in range(400):
        if not queue:
            break
        budget = int(rng.integers(16, 400))
        rep = eng.step(budget, [], [], queue)
        assert rep.charge_decode == 0
        if not rep.oversized:
            assert rep.charged <= budget
        got.update({rid: int(np.argmax(lg)) for rid, lg in rep.finalized.items()})
        queue = [rid for rid in queue if rid not in rep.finalized]
    assert not queue and got == ref


def test_abort_prefill_rolls_back_cleanly(systems):
    """Aborting between chunks releases every page and the chunk state,
    and a fresh begin_prefill re-runs the request to the same logits as
    an untouched engine (and the wave prefill's, within tolerance)."""
    _, tsys, _, (_, plans_t) = systems
    req, = _requests({0: plans_t[sorted(plans_t)[-1]]})
    pool = pool_for(tsys.cfg, device="cpu")
    eng = BatchEngine(tsys.model, tsys.cfg, pool=pool, cache=tsys.rows, chunk_tokens=64)
    eng.begin_prefill(req)
    rep = eng.step(64, [], [], [req.rid])
    assert rep.chunked == [req.rid] and req.rid in eng.prefill_states
    eng.abort_prefill(req.rid)
    assert req.rid not in eng.prefill_states and pool.stats().pages_in_use == 0
    assert pool.free_pages == pool.n_pages - 1
    eng.begin_prefill(req)
    rep = eng.step(10_000, [], [], [req.rid])
    fresh = BatchEngine(tsys.model, tsys.cfg, pool=pool_for(tsys.cfg, device="cpu"),
                        cache=tsys.rows, chunk_tokens=64)
    fresh.begin_prefill(req)
    want = fresh.step(10_000, [], [], [req.rid]).finalized[req.rid]
    np.testing.assert_array_equal(rep.finalized[req.rid], want)
    wave = BatchEngine(tsys.model, tsys.cfg, pool=pool_for(tsys.cfg, device="cpu"),
                       cache=tsys.rows).prefill([req], "rcllm")[0]
    np.testing.assert_allclose(want, wave, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    # the chunked pool rows equal the wave path's within the KV tolerance
    k_c, v_c = eng.pool.gather(req.rid)
    wave_eng = BatchEngine(tsys.model, tsys.cfg, pool=pool_for(tsys.cfg, device="cpu"),
                           cache=tsys.rows)
    wave_eng.prefill([req], "rcllm")
    k_w, v_w = wave_eng.pool.gather(req.rid)
    np.testing.assert_allclose(k_c, k_w, atol=KV_TOL, rtol=KV_TOL)
    np.testing.assert_allclose(v_c, v_w, atol=KV_TOL, rtol=KV_TOL)


def test_midprefill_preemption_in_loop(systems):
    """Decode-time PoolExhausted with a request mid-prefill: the batcher
    preempts the younger, prefilling request, rolls its chunk state back,
    and both requests still finish with full outputs (page_size 1: every
    slot its own page)."""
    _, tsys, _, (_, plans_t) = systems
    by_len = sorted(plans_t, key=lambda r: plans_t[r][0].n)
    plans = {0: plans_t[by_len[0]], 1: plans_t[by_len[-1]]}
    n_a, n_b = plans[0][0].n, plans[1][0].n
    assert n_b - n_a >= 128, "need a real length gap for the scenario"

    class NoReserveBackend(TorchEngineBackend):
        def _batch_requests(self, batch):
            out = super()._batch_requests(batch)
            for br in out:
                br.n_reserve = 0              # broken accounting on purpose
            return out

    cfg = tsys.cfg
    pool = PagedKVPool(cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim, page_size=1,
                       n_pages=n_a + n_b + 1, device="cpu")
    eng = BatchEngine(tsys.model, cfg, pool=pool, cache=tsys.rows, chunk_tokens=64)
    backend = NoReserveBackend(eng, mode="rcllm", plans=plans)
    batcher = ContinuousBatcher(backend, sched="chunked", chunk_tokens=64, step_tokens=128)
    done = batcher.run([PendingRequest(0.0, 0, n_a, 3, plans[0][0].tokens),
                        PendingRequest(0.0, 1, n_b, 1, plans[1][0].tokens)])
    assert len(done) == 2 and batcher.workers[0].preempted >= 1
    assert len(backend.generated[0]) == 3 and len(backend.generated[1]) == 1
    assert pool.stats().pages_in_use == 0 and not eng.prefill_states


def test_pool_remap_private_matches_reference():
    """alloc_mapped(extra_pages=) banks spare private slots; remap_private
    repoints mapped positions at them, growing by fresh pages only when
    the spares run out — slot tables, spares and the free list as the
    reference pool's."""
    from repro.serving.kv_pool import PagedKVPool as JaxPool
    pools = [PagedKVPool(2, 2, 4, page_size=4, n_pages=32, device="cpu"),
             JaxPool(2, 2, 4, page_size=4, n_pages=32)]
    mapped = np.asarray([0, 1, 2, 3, 8, 9])
    for p in pools:
        p.alloc(99, 8)                              # owner of the "shared" slots
        shared = p.slot_tables[99][:6]
        p.alloc_mapped(5, 20, mapped, shared, extra_pages=2)
        spare0 = len(p._spare[5])
        free0 = p.free_pages
        p.remap_private(5, np.asarray([1, 8]))
        assert p.free_pages == free0 and len(p._spare[5]) == spare0 - 2
        own = set(p.page_slots(p.page_tables[5]))
        assert int(p.slot_tables[5][1]) in own and int(p.slot_tables[5][8]) in own
        p.remap_private(5, np.asarray([0, 2, 3, 9]))
        p.slot_tables[5][4:8] = shared[2:6]         # pretend mapped: forces growth
        p.remap_private(5, np.arange(4, 8))
    a, b = pools
    np.testing.assert_array_equal(a.slot_tables[5], b.slot_tables[5])
    assert a.page_tables == b.page_tables and a._spare == b._spare
    assert a.free_pages == b.free_pages
    for p in pools:
        p.free(5)
        p.free(99)
        assert 5 not in p._spare and p.free_pages == 31


def test_chunked_config_and_launcher(capsys):
    with pytest.raises(ValueError, match="chunk-resumable"):
        ServeConfig(mode="full", sched="chunked")
    with pytest.raises(ValueError, match="chunk_tokens"):
        ServeConfig(sched="chunked", chunk_tokens=0)
    assert ServeConfig(chunk_tokens=64).resolved_step_tokens == 512
    assert ServeConfig(chunk_tokens=256).resolved_step_tokens == 1024
    assert dataclasses.replace(ServeConfig(), step_tokens=96).resolved_step_tokens == 96
    PS.main(["--device", "cpu", "--sched", "chunked", "--requests", "2",
             "--chunk-tokens", "64", "--decode-steps", "2"])
    rep = json.loads(capsys.readouterr().out)
    assert rep["sched"] == "chunked" and rep["requests"] == 2
    assert rep["decode_tokens"] == 4 and rep["ticks"] > 0 and rep["step_tokens"] == 512
