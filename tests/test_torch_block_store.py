"""Port parity for cross-request KV reuse: the shared block store
(`serving/block_store.py`), its pool interface and the store-backed
serving paths of the wave and chunked schedulers, against the JAX
package's store on the same weights (its init converted through numpy)
and the same traces.

The serving trace is the reference's repeat-user Zipf trace in two
arrival waves (4 requests at t = 0, the rest at t = 1000 s), so both
packages form the same batches whatever their speed, and the second wave
meets a warm store: prefix-tier hits injected before compute, item and
user hits mapped at store slots.  Greedy tokens, the store's counters and
the admission bounds must equal the reference's exactly; tokens with
reuse on and off must be equal within the port."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as JENG
from repro.serving import api as JAPI
from repro.serving import block_store as JBS
from repro.serving import workload as JWL
from repro.serving.batching import PendingRequest as JPending
from repro.serving.kv_pool import PagedKVPool as JPool
from repro_torch.core.rcllm import make_tiny_system, tiny_config
from repro_torch.kernels.block_gather import ops as BO
from repro_torch.kernels.block_gather.ref import block_gather_ref
from repro_torch.launch import serve as PS
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import block_store as BS
from repro_torch.serving import workload as TWL
from repro_torch.serving.api import ServeConfig, StoreConfig
from repro_torch.serving.batching import PendingRequest
from repro_torch.serving.block_store import (SharedBlockStore, check_partition,
                                             content_key, dequantize_rows)
from repro_torch.serving.kv_pool import PagedKVPool, PoolExhausted

N_REQ, WAVE1, DECODE_STEPS = 10, 4, 3
STORE_COUNTERS = ("hits_user", "hits_item", "hits_prefix", "misses_user",
                  "misses_item", "misses_prefix", "inserts", "insert_skips",
                  "evictions", "spills", "insert_spills", "spill_drops", "spill_hits")


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


def _workload(WL, system, pool_rv, prof):
    trace = WL.zipf_repeat_trace(system.catalog, pool_rv, prof, N_REQ, qps=1e6,
                                 n_users=3, zipf_a=1.4, seed=3)
    reqs, plans = WL.rcllm_workload(system, trace, decode_steps=DECODE_STEPS)
    return reqs, plans, WL.rcllm_reuse_info(system, trace, plans)


def _two_waves(reqs, cls):
    return [cls(0.0 if r.rid < WAVE1 else 1e3, r.rid, r.n_tokens, r.decode_steps,
                r.tokens) for r in reqs]


@pytest.fixture(scope="module")
def zipf(systems):
    jsys, tsys, pool_rv, prof = systems
    return _workload(JWL, jsys, pool_rv, prof), _workload(TWL, tsys, pool_rv, prof)


def _run_reference(jsys, work, sched, kv_reuse=True, n_pages=512, store=None):
    reqs, plans, reuse = work
    cfg = JAPI.ServeConfig(engine="jax", mode="rcllm", decode_steps=DECODE_STEPS,
                           sched=sched, kv_reuse=kv_reuse, chunk_tokens=64,
                           n_pages=n_pages, store=store or JAPI.StoreConfig())
    eng = JAPI.build_engine(jsys.params, jsys.cfg, cfg, sel=JENG.SelectiveConfig(window=16))
    backend = JAPI.build_backend(eng, cfg, plans=plans, reuse=reuse if kv_reuse else None)
    done = JAPI.build_batcher(backend, cfg).run(_two_waves(reqs, JPending))
    assert len(done) == len(reqs)
    JBS.check_partition(eng.pool, eng.store)
    return eng, backend


def _run_port(tsys, work, sched, kv_reuse=True, n_pages=512, store=None):
    reqs, plans, reuse = work
    config = ServeConfig(decode_steps=DECODE_STEPS, sched=sched, kv_reuse=kv_reuse,
                         chunk_tokens=64, n_pages=n_pages, store=store or StoreConfig())
    engine, backend, _, done = PS.serve(tsys.model, tsys.cfg, config,
                                        _two_waves(reqs, PendingRequest), plans,
                                        tsys.rows, reuse)
    assert len(done) == len(reqs)
    # no request holds a page or a store reference, and nothing leaked
    assert engine.pool.stats().pages_in_use == 0 and not engine.prefill_states
    check_partition(engine.pool, engine.store)
    if engine.store is not None:
        assert all(b.refcount == 0 for b in engine.store.blocks.values())
    return engine, backend


@pytest.fixture
def admitted(monkeypatch):
    """key -> (k, v): a copy, held by the test, of the fp32 bytes the store
    wrote for that block at its latest admission (an fp32 block keeps no
    payload of its own: its arena slots are its bytes)."""
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


def _store_bytes_intact(pool, store, admitted):
    """Every resident block's arena slots still hold the bytes the store
    wrote at its admission: no request ever wrote into a shared slot."""
    assert store.blocks
    for blk in store.blocks.values():
        sl = torch.from_numpy(blk.slots)
        pages, slots = sl // pool.page_size, sl % pool.page_size
        want_k, want_v = admitted[blk.key]
        assert torch.equal(pool.arena_k[pages, slots], want_k), blk.key
        assert torch.equal(pool.arena_v[pages, slots], want_v), blk.key
        assert torch.equal(blk.fp32_k, want_k) and torch.equal(blk.fp32_v, want_v)


# ------------------------------------------------- store unit behaviour
def _tiny_pool(n_pages=16, page_size=4):
    return PagedKVPool(n_layers=2, n_kv_heads=2, head_dim=4, page_size=page_size,
                       n_pages=n_pages, device="cpu")


def _blk(rng, n, L=2, H=2, D=4):
    return (torch.from_numpy(rng.normal(size=(n, L, H, D)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(n, L, H, D)).astype(np.float32)))


def test_store_refcounts_lru_and_pinning(admitted):
    """The reference's `test_store_refcounts_lru_and_pinning` on the port."""
    pool = _tiny_pool(n_pages=10, page_size=4)    # 9 usable
    store = SharedBlockStore(pool, max_user_pages=2)
    rng = np.random.default_rng(2)
    ka, va = _blk(rng, 8)
    kb, vb = _blk(rng, 8)
    kc, vc = _blk(rng, 8)
    a = store.insert(("item", "a"), "item", ka, va)
    store.insert(("item", "b"), "item", kb, vb)
    assert pool.free_pages == 5
    assert store.acquire(("item", "a")) is a      # hit + ref
    store.get(("item", "b"))                      # b is now most recent
    check_partition(pool, store)
    # c needs 2 pages while keeping 4 free with 5 free: evict; a is
    # referenced, so only b goes (though a is the least recent)
    c = store.insert(("item", "c"), "item", kc, vc, keep_free=4)
    assert c is not None
    assert store.has(("item", "a")) and not store.has(("item", "b"))
    check_partition(pool, store)
    store.release(("item", "a"))
    u = store.insert(("user", "u"), "user", ka[:4], va[:4], pinned=True)
    assert u is not None and u.pinned
    assert not store.evict_for(pool.n_pages)      # pinned u never evicts
    assert store.has(("user", "u"))
    # user-tier budget: a second user block over max_user_pages is skipped
    assert store.insert(("user", "u2"), "user", kb, vb, pinned=True) is None
    assert store.counters["insert_skips"] >= 1
    # the store's slots hold copies of its bytes
    ka0 = ka.clone()
    ka.add_(1.0)
    assert a.data_k is None and torch.equal(a.fp32_k, ka0)
    _store_bytes_intact(pool, store, admitted)
    check_partition(pool, store)


def test_store_mapped_request_roundtrip():
    """alloc_mapped + shared slots: a gather returns the store block's
    bytes at mapped positions (any alignment) and private rows elsewhere."""
    pool = _tiny_pool(n_pages=16, page_size=4)
    store = SharedBlockStore(pool)
    rng = np.random.default_rng(3)
    kb, vb = _blk(rng, 6)
    blk = store.insert(content_key("item", np.arange(6)), "item", kb, vb)
    n = 10
    mapped_pos = np.asarray([2, 3, 4, 7, 8])
    mapped_off = np.asarray([0, 1, 2, 4, 5])
    pool.alloc_mapped(5, n, mapped_pos, blk.slots[mapped_off])
    priv = np.setdiff1d(np.arange(n), mapped_pos)
    kw, vw = _blk(rng, len(priv))
    pool.write_at(5, priv, kw, vw)
    gk, gv = pool.gather(5)
    np.testing.assert_array_equal(gk[mapped_pos], kb.numpy()[mapped_off])
    np.testing.assert_array_equal(gv[mapped_pos], vb.numpy()[mapped_off])
    np.testing.assert_array_equal(gk[priv], kw.numpy())
    check_partition(pool, store)
    pool.free(5)
    check_partition(pool, store)


def _walk(store_cls, pool, tensors, exhausted, check, seed=4, steps=250):
    """The reference's partition random walk over either package's store
    (`tensors` converts the host rows it inserts; `check` runs after every
    op).  -> (store, live rids, held keys, a log of every op's outcome and
    the resident blocks after it)."""
    rng = np.random.default_rng(seed)
    store = store_cls(pool, max_user_pages=6)
    next_rid, next_bid = 0, 0
    live_rids, keys, held, log = [], [], {}, []
    for _ in range(steps):
        op = int(rng.integers(0, 7))
        try:
            if op == 0:                           # plain alloc
                pool.alloc(next_rid, int(rng.integers(1, 20)))
                live_rids.append(next_rid)
                held[next_rid] = []
                next_rid += 1
            elif op == 1 and keys:                # mapped alloc over a block
                key = keys[rng.integers(len(keys))]
                blk = store.acquire(key)
                if blk is not None:
                    n = blk.n_tokens
                    pos = np.sort(rng.choice(np.arange(n + 4), size=min(n, 3), replace=False))
                    off = np.sort(rng.choice(np.arange(n), size=len(pos), replace=False))
                    pool.alloc_mapped(next_rid, n + 4, pos, blk.slots[off])
                    live_rids.append(next_rid)
                    held[next_rid] = [key]
                    next_rid += 1
            elif op == 2 and live_rids:           # free (sometimes double)
                rid = live_rids[rng.integers(len(live_rids))]
                pool.free(rid)
                store.release_all(held.pop(rid, []))
                live_rids.remove(rid)
                if rng.random() < 0.3:
                    pool.free(rid)
            elif op == 3:                         # store insert
                nb = int(rng.integers(2, 10))
                k = rng.normal(size=(nb, 2, 2, 4)).astype(np.float32)
                v = rng.normal(size=(nb, 2, 2, 4)).astype(np.float32)
                kind = "user" if rng.random() < 0.3 else "item"
                store.insert((kind, f"b{next_bid}"), kind, tensors(k), tensors(v),
                             pinned=kind == "user")
                if store.has((kind, f"b{next_bid}")):
                    keys.append((kind, f"b{next_bid}"))
                next_bid += 1
            elif op == 4 and keys:                # ref churn, no mapping
                key = keys[rng.integers(len(keys))]
                if store.acquire(key) is not None:
                    store.release(key)
            elif op == 5:                         # eviction pressure
                store.evict_for(int(rng.integers(1, 8)))
                keys = [k for k in keys if store.has(k)]
            elif op == 6 and live_rids:           # decode append growth
                rid = live_rids[rng.integers(len(live_rids))]
                pool.seq_lens[rid] = len(pool.slot_tables[rid])
                pool.append_slots([rid])
            log.append((op, "ok"))
        except exhausted:
            log.append((op, "exhausted"))
        log.append(sorted((k, len(b.pages), b.refcount) for k, b in store.blocks.items()))
        check(pool, store)
    return store, live_rids, held, log


def test_partition_invariant_random_walk():
    """The reference's random walk: after every op each page is owned by
    exactly one of {free list, a request, the store}; refcounted blocks
    survive; every page comes home at the end.  The same walk over the
    reference's store takes the same decisions, op for op."""
    from repro.serving.kv_pool import PoolExhausted as JExhausted
    pool = _tiny_pool(n_pages=24, page_size=4)
    store, live_rids, held, log = _walk(SharedBlockStore, pool, torch.from_numpy,
                                        PoolExhausted, check_partition)
    jpool = JPool(n_layers=2, n_kv_heads=2, head_dim=4, page_size=4, n_pages=24)
    jstore, _, _, jlog = _walk(JBS.SharedBlockStore, jpool, lambda a: a, JExhausted,
                               JBS.check_partition)
    # no router hints here: prefetch promotes nothing on either side
    assert store.counters["prefetch_promotions"] == 0
    assert log == jlog and store.counters == jstore.counters
    for rid in list(live_rids):
        pool.free(rid)
        store.release_all(held.pop(rid, []))
    for blk in store.blocks.values():
        blk.refcount, blk.pinned = 0, False
    store.evict_for(pool.n_pages - 1)
    assert pool.free_pages == pool.n_pages - 1
    check_partition(pool, store)


def test_item_insert_copies_cached_rows_on_the_device(systems, zipf, admitted):
    """An item-tier miss inserts the block's rows of the device pool of
    cached rows, bitwise, and the engine maps its positions there."""
    _, tsys, _, _ = systems
    _, (reqs, plans, reuse) = zipf
    engine, _ = _run_port(tsys, (reqs[:2], plans, reuse), "wave")
    store, rows = engine.store, tsys.rows
    refs = [ref for rid in (0, 1) for ref in reuse[rid].blocks]
    assert refs and all(ref.row > 0 for ref in refs)
    for ref in refs:
        blk = store.peek(ref.key)
        assert blk is not None and blk.kind == BS.ITEM_TIER
        t = len(ref.tokens)
        want_k = rows.k[:, ref.row:ref.row + t, 0].transpose(0, 1)
        assert blk.data_k is None and torch.equal(blk.fp32_k, want_k)
        assert torch.equal(blk.fp32_v, rows.v[:, ref.row:ref.row + t, 0].transpose(0, 1))
    _store_bytes_intact(engine.pool, engine.store, admitted)


def test_pool_plane_is_the_arena_layer():
    pool = PagedKVPool(3, 2, 4, page_size=4, n_pages=5, device="cpu")
    pool.arena_k.copy_(torch.randn(pool.arena_k.shape))
    pool.arena_v.copy_(torch.randn(pool.arena_v.shape))
    for layer in range(3):
        k, v = (p[layer] for p in pool.planes())
        assert k.shape == (20, 1, 2, 4)
        assert k.data_ptr() == pool.arena_k[0, 0, layer].data_ptr()   # a view
        assert torch.equal(k[:, 0], pool.arena_k[:, :, layer].reshape(20, 2, 4))
        assert torch.equal(v[:, 0], pool.arena_v[:, :, layer].reshape(20, 2, 4))


@pytest.mark.parametrize("rotate", [False, True])
def test_block_gather_second_pool_plain(rotate):
    """Table entries past the first pool read the second pool (a strided
    arena plane): the same as gathering from the two pools stacked."""
    rng = np.random.default_rng(7 + rotate)
    pool = PagedKVPool(3, 2, 8, page_size=4, n_pages=6, device="cpu")
    pool.arena_k.copy_(torch.randn(pool.arena_k.shape))
    pool.arena_v.copy_(torch.randn(pool.arena_v.shape))
    pk = torch.from_numpy(rng.normal(size=(9, 1, 2, 8)).astype(np.float32))
    pv = -pk
    k2, v2 = (p[1] for p in pool.planes())
    table = torch.from_numpy(rng.integers(0, 9 + 24, 40).astype(np.int32))
    pos = torch.from_numpy(rng.integers(0, 500, (40, 1)).astype(np.int32))
    both_k, both_v = torch.cat([pk, k2]), torch.cat([pv, v2])
    want = block_gather_ref(both_k, both_v, table, pos, rotate=rotate, rope_theta=1e4)
    got = BO.assemble_kv(pk, pv, table, pos, rotate=rotate, rope_theta=1e4,
                         pool2_k=k2, pool2_v=v2, keep_raw=rotate)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if rotate:
        assert torch.equal(got[2], both_k[table.long()])


# --------------------------------------------- serving against the reference
@pytest.mark.parametrize("sched", ["wave", "chunked"])
def test_kv_reuse_tokens_and_counters_equal_reference(systems, zipf, sched, admitted):
    """kv_reuse=on, same two-wave Zipf trace: the port decodes the
    reference's greedy tokens, and its store counts the same hits and
    misses per tier, inserts, skips and evictions, and leaves the same
    blocks resident, with the same admission bounds for every request."""
    jsys, tsys, _, _ = systems
    jwork, twork = zipf
    jeng, jback = _run_reference(jsys, jwork, sched)
    engine, backend = _run_port(tsys, twork, sched)
    assert backend.generated == jback.generated
    assert {k: engine.store.counters[k] for k in STORE_COUNTERS} == \
        {k: jeng.store.counters[k] for k in STORE_COUNTERS}
    assert {k: len(b.pages) for k, b in engine.store.blocks.items()} == \
        {k: len(b.pages) for k, b in jeng.store.blocks.items()}
    for rid, (plan, _, _, have) in twork[1].items():
        jplan, _, _, jhave = jwork[1][rid]
        np.testing.assert_array_equal(have, jhave)
        for n_reserve in (0, DECODE_STEPS - 1):
            got = BS.admission_pages(engine.pool, engine.store, plan, have, engine.sel,
                                     twork[2][rid], n_reserve)
            want = JBS.admission_pages(jeng.pool, jeng.store, jplan, jhave, jeng.sel,
                                       jwork[2][rid], n_reserve)
            assert got == want
    _store_bytes_intact(engine.pool, engine.store, admitted)


@pytest.mark.parametrize("sched", ["wave", "chunked"])
def test_kv_reuse_on_off_tokens_bitwise(systems, zipf, sched, monkeypatch, admitted):
    """Reuse changes where decode reads, never what: tokens with the store
    on equal those without it, every tier sees hits, prefix-tier hits
    reach the selective layers through the block gather's second pool,
    and the partition holds with no page leaked."""
    _, tsys, _, _ = systems
    _, twork = zipf
    calls = {"pool2": 0}
    # on the CPU the engine binds the block gather's plain version
    # (`PlainGather`, the plain attention backend), which every binding's
    # CPU call goes through
    call = BO.PlainGather.__call__

    def spy(self, table, positions=None, layers=0, **kw):
        calls["pool2"] += self.two and not isinstance(layers, int)
        return call(self, table, positions, layers, **kw)

    monkeypatch.setattr(BO.PlainGather, "__call__", spy)
    _, off = _run_port(tsys, twork, sched, kv_reuse=False)
    assert calls["pool2"] == 0
    engine, on = _run_port(tsys, twork, sched)
    assert on.generated == off.generated
    stats = engine.store.stats()
    assert stats["hits_user"] > 0 and stats["hits_item"] > 0 and stats["hits_prefix"] > 0
    assert calls["pool2"] > 0
    # a warm store credits resident blocks: some repeat request's bound
    # sits below its full page demand, none above
    bounds = [(BS.admission_pages(engine.pool, engine.store, p[0], p[3], engine.sel,
                                  twork[2][rid], 2)[0], engine.pool.pages_for(p[0].n + 2))
              for rid, p in twork[1].items()]
    assert any(b < full for b, full in bounds) and all(b <= full for b, full in bounds)
    _store_bytes_intact(engine.pool, engine.store, admitted)


@pytest.mark.parametrize("kv_reuse", [False, True])
def test_chunked_decoded_token_parity(systems, kv_reuse):
    """The reference's `test_chunked.py` parametrisation on the port: wave
    and chunked decode the same tokens on the heavy-tail trace (long
    prompts, many chunks, mid-stream finalizes), with and without the
    store."""
    jsys, tsys, pool_rv, prof = systems
    from repro_torch.data import synth as TSY
    trace = TSY.make_trace(tsys.catalog, pool_rv, prof, 6, qps=8.0, n_users=3,
                           n_candidates=8, reviews_per_user=1, seed=5,
                           long_prompt_frac=0.4, long_prompt_reviews=6)
    reqs, plans = TWL.rcllm_workload(tsys, trace, decode_steps=DECODE_STEPS)
    reuse = TWL.rcllm_reuse_info(tsys, trace, plans)
    gen = {}
    for sched in ("wave", "chunked"):
        config = ServeConfig(decode_steps=DECODE_STEPS, sched=sched, kv_reuse=kv_reuse,
                             chunk_tokens=64, step_tokens=256)
        engine, backend, batcher, done = PS.serve(tsys.model, tsys.cfg, config, reqs,
                                                  plans, tsys.rows, reuse)
        assert len(done) == len(reqs) and engine.pool.stats().pages_in_use == 0
        check_partition(engine.pool, engine.store)
        gen[sched] = backend.generated
    assert gen["wave"] == gen["chunked"]


@pytest.mark.parametrize("tiers", ["fp32", "int8_spill"])
def test_store_under_eviction_pressure_equals_reference(systems, zipf, tiers, admitted):
    """A pool small enough that the store evicts and skips inserts: the
    chunked run takes the reference's store decisions (the same counters,
    spills and spill hits included, with int8 payloads and a spill tier
    too) and leaves no page held; with fp32 payloads it decodes the
    reference's tokens, which are those without reuse."""
    jsys, tsys, _, _ = systems
    jwork, twork = zipf
    kw = {} if tiers == "fp32" else dict(kv_store_dtype="int8", spill_mb=64)
    jeng, jback = _run_reference(jsys, jwork, "chunked", n_pages=96,
                                 store=JAPI.StoreConfig(**kw))
    engine, backend = _run_port(tsys, twork, "chunked", n_pages=96, store=StoreConfig(**kw))
    assert engine.store.counters["evictions"] > 0
    assert {k: engine.store.counters[k] for k in STORE_COUNTERS} == \
        {k: jeng.store.counters[k] for k in STORE_COUNTERS}
    if kw:
        assert engine.store.counters["spills"] > 0 and engine.store.counters["spill_hits"] > 0
    else:
        _, off = _run_port(tsys, twork, "chunked", kv_reuse=False, n_pages=96)
        assert backend.generated == jback.generated == off.generated
    _store_bytes_intact(engine.pool, engine.store, admitted)


def test_launcher_reports_the_store():
    """`--kv-reuse on` prints the reference's `kv_reuse`, `store` and
    `block_store` keys."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "4", "--kv-reuse", "on", "--zipf-users", "1.4",
         "--kv-store-dtype", "int8", "--spill-mb", "16", "--sched", "chunked"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=300, check=True)
    rep = json.loads(out.stdout)
    assert rep["kv_reuse"] == "on" and rep["decode_tokens"] == 4 * 4
    assert rep["store"] == {"kv_store_dtype": "int8", "spill_mb": 16,
                            "prefetch_pages_per_tick": 0}
    assert set(STORE_COUNTERS) <= set(rep["block_store"])
    assert rep["block_store"]["hits_item"] > 0
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--spill-mb", "16"], cwd=repo, env=env, capture_output=True, text=True,
        timeout=300)
    assert bad.returncode != 0 and "kv_reuse" in bad.stderr


def test_serve_config_validates_reuse():
    with pytest.raises(ValueError, match="kv_reuse"):
        ServeConfig(mode="full", kv_reuse=True)
    with pytest.raises(ValueError, match="kv_reuse"):
        ServeConfig(store=StoreConfig(spill_mb=16))
    cfg = ServeConfig(kv_reuse=True, store=StoreConfig(kv_store_dtype="int8"))
    assert dataclasses.replace(cfg, sched="chunked").store.kv_store_dtype == "int8"
