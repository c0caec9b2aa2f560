"""Port parity for prefill/decode disaggregation: KV migration between two
pools (`kv_pool.export_request` / `import_request`), store payloads by
content key (`block_store.export_payload` / `import_payload`), the
engine's handoff record (`batch_engine.RequestKV`) and the role-typed
cluster, against the JAX package's on the same inputs.

Pool-level records are compared with the reference's field by field and
the page bytes bitwise; a migrated request decodes from bitwise the bytes
it left.  The cluster runs are clock-free (arrivals 1000 s apart: one
prefill worker, one decode worker, each request alone), so tokens and the
migration ledger (pages, bytes, digest hits, billed seconds on one
`Hardware`) must equal the reference's."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import cost_model as JCM
from repro.serving import api as JAPI
from repro.serving import block_store as JBS
from repro.serving import workload as JWL
from repro.serving.cluster import ClusterEngine as JCluster
from repro.serving.kv_pool import PagedKVPool as JPool
from repro.serving.kv_pool import PoolExhausted as JPoolExhausted
from repro_torch.core import cost_model as TCM
from repro_torch.core.rcllm import make_tiny_system, tiny_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import api as API
from repro_torch.serving import block_store as BS
from repro_torch.serving import workload as TWL
from repro_torch.serving.batch_engine import (BatchEngine, BatchRequest, RequestKV,
                                              migration_bytes)
from repro_torch.serving.block_store import SharedBlockStore, check_partition
from repro_torch.serving.cluster import ClusterEngine
from repro_torch.serving.kv_pool import PagedKVPool, PoolExhausted, pool_for

L, HKV, DH, PS = 2, 2, 4, 4  # tiny arena geometry for the pool tests
DECODE_STEPS = 3
LOGIT_TOL = 1e-4   # chunked vs monolithic inside the port (test_torch_chunked.py)
JHW = JCM.Hardware(**dataclasses.asdict(TCM.H100_SXM))


# ------------------------------------------------ pool-layer round trip
class _Side:
    """One package's pool + store, fed the same seeded bytes."""

    def __init__(self, torch_side: bool, n_pages: int = 64):
        self.t = torch_side
        if torch_side:
            self.pool = PagedKVPool(L, HKV, DH, page_size=PS, n_pages=n_pages, device="cpu")
            self.store = SharedBlockStore(self.pool)
        else:
            self.pool = JPool(n_layers=L, n_kv_heads=HKV, head_dim=DH, page_size=PS,
                              n_pages=n_pages)
            self.store = JBS.SharedBlockStore(self.pool)

    def kv(self, k, v):
        return (torch.from_numpy(k), torch.from_numpy(v)) if self.t else (k, v)


def _rand_kv(rng, t):
    return (rng.standard_normal((t, L, HKV, DH)).astype(np.float32),
            rng.standard_normal((t, L, HKV, DH)).astype(np.float32))


def _build_request(rng, side, rid):
    """One random request: optionally a store-mapped prefix, private tail
    bytes, spare pages, and (half the time) a truncated seq_len as a
    chunk-partial prefill leaves it.  -> held keys."""
    pool, store = side.pool, side.store
    n_tokens = int(rng.integers(5, 28))
    held, t_blk = [], 0
    if rng.integers(0, 2):
        t_blk = int(rng.integers(1, n_tokens // 2 + 2))
        key = (BS.ITEM_TIER, f"blk-{rid}-{t_blk}")
        blk = store.insert(key, BS.ITEM_TIER, *side.kv(*_rand_kv(rng, t_blk)))
        blk.refcount += 1
        held.append(key)
        pool.alloc_mapped(rid, n_tokens, np.arange(t_blk), np.asarray(blk.slots, np.int64),
                          extra_pages=int(rng.integers(0, 3)))
    else:
        pool.alloc(rid, n_tokens)
    priv = np.arange(t_blk, n_tokens)
    if len(priv):
        pool.write_at(rid, priv, *side.kv(*_rand_kv(rng, len(priv))))
    else:
        pool.seq_lens[rid] = t_blk
    if rng.integers(0, 2):
        pool.seq_lens[rid] = int(rng.integers(max(t_blk, 1), n_tokens + 1))
    return held


def _migrate(export, held, src, dst):
    """The transport in miniature: payloads by content key, then the pool
    snapshot under the slot translation map."""
    fmap = {}
    for key in held:
        payload = src.store.export_payload(key)
        blk, _ = dst.store.import_payload(payload)
        fmap.update(zip(payload.slots.tolist(), np.asarray(blk.slots).tolist()))
    dst.pool.import_request(export, fmap)
    dst.store.flush_writes()


def _export_fields(e):
    return (e.rid, e.seq_len, e.page_size, e.owner_page.tolist(), e.owner_off.tolist(),
            e.foreign_slots.tolist(), e.spare_page.tolist(), e.spare_off.tolist(),
            e.n_pages, e.nbytes)


@pytest.mark.parametrize("seed", range(10))
def test_export_import_roundtrip_sweep(seed):
    """Seeded layouts: the export equals the reference's field by field and
    its pages bitwise, and the import restores the request bitwise."""
    sides = {}
    for torch_side in (False, True):
        rng = np.random.default_rng(seed)
        a, b = _Side(torch_side), _Side(torch_side)
        held = {rid: _build_request(rng, a, rid) for rid in range(int(rng.integers(1, 4)))}
        exports = {rid: a.pool.export_request(rid) for rid in held}
        for rid, keys in held.items():
            _migrate(exports[rid], keys, a, b)
        sides[torch_side] = (a, b, held, exports)
    _, jb, held, jex = sides[False]
    ta, tb, _, tex = sides[True]
    check_partition(ta.pool, ta.store)
    check_partition(tb.pool, tb.store)
    for rid, keys in held.items():
        assert _export_fields(tex[rid]) == _export_fields(jex[rid])
        np.testing.assert_array_equal(tex[rid].page_k.numpy(), np.asarray(jex[rid].page_k))
        np.testing.assert_array_equal(tex[rid].page_v.numpy(), np.asarray(jex[rid].page_v))
        for x, y in zip(ta.pool.gather(rid), tb.pool.gather(rid)):    # bitwise round trip
            np.testing.assert_array_equal(x, y)
        assert tb.pool.seq_lens[rid] == ta.pool.seq_lens[rid]
        np.testing.assert_array_equal(tb.pool.slot_tables[rid], jb.pool.slot_tables[rid])
        assert tb.pool._spare.get(rid, []) == jb.pool._spare.get(rid, [])
        store_slots = {int(s) for blk in tb.store.blocks.values() for s in blk.slots}
        for pos in np.where(tex[rid].owner_page < 0)[0]:
            assert int(tb.pool.slot_tables[rid][pos]) in store_slots
    for side in (ta, tb):
        for rid, keys in held.items():
            side.pool.free(rid)
            side.store.release_all(keys)
        assert side.pool.stats().pages_in_use == 0
        check_partition(side.pool, side.store)


def test_pool_import_validates_before_mutating():
    for seed in range(8):      # the first layout that maps a store block
        a = _Side(True)
        held = _build_request(np.random.default_rng(seed), a, 0)
        if held:
            break
    assert held
    export = a.pool.export_request(0)
    b = _Side(True)
    _migrate(export, held, a, b)
    with pytest.raises(KeyError, match="already allocated"):   # duplicate rid
        b.pool.import_request(export, {})
    c = _Side(True)
    free0 = c.pool.free_pages
    with pytest.raises(KeyError, match="no destination mapping"):
        c.pool.import_request(export, {})
    assert c.pool.free_pages == free0 and 0 not in c.pool.page_tables
    d = PagedKVPool(L, HKV, DH, page_size=2 * PS, n_pages=64, device="cpu")
    with pytest.raises(ValueError, match="page_size"):
        d.import_request(export, {s: s for s in range(10**4)})


def test_pool_import_exhaustion_leaves_destination_untouched():
    rng = np.random.default_rng(5)
    res = {}
    for torch_side, exc in ((False, JPoolExhausted), (True, PoolExhausted)):
        a = _Side(torch_side)
        a.pool.alloc(0, 24)                      # 6 pages of private bytes
        a.pool.write_at(0, np.arange(24), *a.kv(*_rand_kv(rng, 24)))
        b = _Side(torch_side, n_pages=4)         # 3 usable pages
        free0 = b.pool.free_pages
        with pytest.raises(exc):
            b.pool.import_request(a.pool.export_request(0), {})
        res[torch_side] = (b.pool.free_pages == free0, 0 in b.pool.page_tables)
        if torch_side:
            check_partition(b.pool, b.store)
    assert res[True] == res[False] == (True, False)


def test_payload_digest_hit_moves_zero_bytes():
    rng = np.random.default_rng(7)
    a, b = _Side(True), _Side(True)
    key = (BS.ITEM_TIER, "shared-digest")
    kb, vb = _rand_kv(rng, 6)
    a.store.insert(key, BS.ITEM_TIER, *a.kv(kb, vb))
    assert a.store.export_payload((BS.ITEM_TIER, "nope")) is None
    payload = a.store.export_payload(key)
    assert payload.nbytes == 2 * kb.nbytes
    blk1, hit1 = b.store.import_payload(payload)
    b.store.flush_writes()
    blk2, hit2 = b.store.import_payload(payload)
    assert (hit1, hit2) == (False, True)
    assert blk2 is blk1 and blk1.refcount == 2        # one reference per import
    np.testing.assert_array_equal(blk1.fp32_k.numpy(), kb)
    src = _Side(True)
    src.pool.alloc(0, 8)
    src.pool.write_at(0, np.arange(8), *src.kv(*_rand_kv(rng, 8)))
    rec = RequestKV(rid=0, export=src.pool.export_request(0), held=[key],
                    payloads={key: payload})
    assert rec.nbytes == rec.export.nbytes + payload.nbytes
    assert migration_bytes(rec, None) == rec.export.nbytes + payload.nbytes
    assert migration_bytes(rec, b.store) == rec.export.nbytes      # digest hit
    # a key held in the spill tier is a hit too: promoted, nothing moves
    c = PagedKVPool(L, HKV, DH, page_size=PS, n_pages=8, device="cpu")
    cs = SharedBlockStore(c, spill_mb=1)
    cs.insert(key, BS.ITEM_TIER, *a.kv(kb, vb))
    cs.evict_for(c.n_pages - 1)
    assert cs.in_spill(key) and migration_bytes(rec, cs) == rec.export.nbytes
    blk, hit = cs.import_payload(payload)
    assert hit and blk.refcount == 1 and cs.counters["spill_hits"] == 1


# ---------------------------------------------- engine-layer handoff
@pytest.fixture(scope="module")
def systems():
    from repro.core.rcllm import make_tiny_system as jax_tiny
    jsys, pool_rv, prof, _ = jax_tiny(n_items=60, n_requests_hist=30, k_instances=2,
                                      n_layers=2, d_model=32)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jsys.params),
                              tiny_config(2, 32), device="cpu")
    tsys, _, _, _ = make_tiny_system(n_items=60, n_requests_hist=30, k_instances=2,
                                     n_layers=2, d_model=32, device="cpu", model=model)
    trace = JWL.heavy_tail_trace(jsys.catalog, pool_rv, prof, 6, qps=8.0, n_users=3,
                                 long_prompt_frac=0.4, long_prompt_reviews=6, seed=5)
    return jsys, tsys, trace


@pytest.fixture(scope="module")
def work(systems):
    _, tsys, trace = systems
    _, plans = TWL.rcllm_workload(tsys, trace, decode_steps=DECODE_STEPS)
    return plans, TWL.rcllm_reuse_info(tsys, trace, plans)


def _engine(tsys, n_pages=512, store=True):
    pool = pool_for(tsys.cfg, n_pages=n_pages, device="cpu")
    return BatchEngine(tsys.model, tsys.cfg, pool=pool, cache=tsys.rows, chunk_tokens=64,
                       store=SharedBlockStore(pool) if store else None)


def _request(plans, reuse, rid, as_rid=None):
    plan, table, pos, have = plans[rid]
    return BatchRequest(rid=rid if as_rid is None else as_rid, tokens=plan.tokens,
                        plan=plan, block_table=table, positions=pos, have=have,
                        n_reserve=2, reuse=reuse[rid])


def _finish(eng, rid, budget=10_000):
    for _ in range(64):
        rep = eng.step(budget, [], [], [rid])
        if rid in rep.finalized:
            return rep.finalized[rid]
    raise AssertionError("prefill never finalized")


@pytest.mark.parametrize("prefix_hit", [False, True], ids=["cold", "prefix-hit"])
def test_chunk_partial_handoff_matches_single_engine(systems, work, prefix_hit):
    """A request exported one chunk in and imported into another engine
    finalizes to bitwise the logits it finalizes to on one engine (with a
    prefix-tier hit, the moved scan reads the prefix rows at the
    destination store's slots); both pools drain."""
    _, tsys, _ = systems
    plans, reuse = work
    rid = max(plans, key=lambda r: plans[r][0].n)
    eng_a, eng_b, ref = _engine(tsys), _engine(tsys), _engine(tsys)
    if prefix_hit:            # warm both source and reference: the same bucket
        for eng in (eng_a, ref):
            eng.begin_prefill(_request(plans, reuse, rid, as_rid=-1))
            _finish(eng, -1)
            eng.release(-1)
    want = None
    ref.begin_prefill(_request(plans, reuse, rid))
    want = _finish(ref, rid, budget=64)
    req = _request(plans, reuse, rid)
    eng_a.begin_prefill(req)
    rep = eng_a.step(64, [], [], [rid])          # exactly one chunk lands
    assert rep.started == [rid] and rid not in rep.finalized
    assert (eng_a.prefill_states[rid].cp.shared is not None) == prefix_hit
    rec = eng_a.export_request_kv(rid)
    assert rec.prefill is not None
    counters = eng_b.import_request_kv(rec)
    assert counters["pages"] >= rec.export.n_pages
    assert counters["bytes"] >= rec.export.nbytes
    eng_a.abort_prefill(rid)
    assert eng_a.pool.stats().pages_in_use == 0
    check_partition(eng_a.pool, eng_a.store)
    if prefix_hit:
        assert eng_b.prefill_states[rid].cp.shared is eng_b.pool
    got = _finish(eng_b, rid, budget=64)
    np.testing.assert_array_equal(got, want)
    mono = _engine(tsys, store=False).prefill([dataclasses.replace(req, reuse=None)], "rcllm")
    np.testing.assert_allclose(got, mono[0], atol=LOGIT_TOL, rtol=LOGIT_TOL)
    eng_b.release(rid)
    assert eng_b.pool.stats().pages_in_use == 0
    check_partition(eng_b.pool, eng_b.store)


def test_engine_import_rolls_back_on_exhaustion(systems, work):
    _, tsys, _ = systems
    plans, reuse = work
    rid = max(plans, key=lambda r: plans[r][0].n)
    eng_a = _engine(tsys)
    eng_a.begin_prefill(_request(plans, reuse, rid))
    _finish(eng_a, rid)
    rec = eng_a.export_request_kv(rid)
    assert rec.export.n_pages > 3 and rec.payloads
    eng_b = _engine(tsys, n_pages=4)
    free0 = eng_b.pool.free_pages
    with pytest.raises(PoolExhausted):
        eng_b.import_request_kv(rec)
    assert eng_b.pool.free_pages == free0
    assert rid not in eng_b.pool.page_tables and rid not in eng_b.store_refs
    assert all(blk.refcount == 0 for blk in eng_b.store.blocks.values())
    check_partition(eng_b.pool, eng_b.store)
    eng_a.release(rid)


# ------------------------------------------------ cluster-level parity
def _spaced(trace):
    return [dataclasses.replace(r, arrival_s=1000.0 * i) for i, r in enumerate(trace)]


DISAGG = dict(prefill_workers=1, decode_workers=1)


def _run_port(tsys, trace, sched, kv_reuse, disagg=False, pressure=False, **kw):
    config = API.ServeConfig(k=2, sched=sched, kv_reuse=kv_reuse, chunk_tokens=64,
                             decode_steps=DECODE_STEPS,
                             disagg=API.DisaggConfig(**DISAGG) if disagg
                             else API.DisaggConfig(), **kw)
    eng = ClusterEngine(tsys, config)
    forced = _inject_pressure(eng.batcher.workers[0], lambda w: w.backend.engine) \
        if pressure else None
    rep = eng.run(trace, decode_steps=DECODE_STEPS)
    assert len(rep.completions) == len(trace)
    for b in eng.backends:
        assert b.engine.pool.stats().pages_in_use == 0 and not b.engine.prefill_states
        check_partition(b.engine.pool, b.engine.store)
        assert not b.plans and not b.reuse
    return eng, rep, forced


def _run_jax(jsys, trace, sched, kv_reuse, disagg=False, pressure=False, **kw):
    cfg = JAPI.ServeConfig(engine="jax", k=2, sched=sched, kv_reuse=kv_reuse,
                           chunk_tokens=64, decode_steps=DECODE_STEPS,
                           disagg=JAPI.DisaggConfig(**DISAGG) if disagg
                           else JAPI.DisaggConfig(), **kw)
    eng = JCluster(jsys, cfg, hw=JHW)
    forced = _inject_pressure(eng.batcher.workers[0], lambda w: w.backend.engine) \
        if pressure else None
    return eng, eng.run(trace, decode_steps=DECODE_STEPS), forced


def _inject_pressure(w0, engine_of):
    """Pool pressure once, the first time a request is mid-scan on the
    prefill worker: its step raises `PoolExhausted` (organic admission
    accounting never overcommits a prefill worker)."""
    orig = w0.backend.step
    forced = {"done": False}

    def step(budget, decode_batch, prefilling):
        states = engine_of(w0).prefill_states
        if not forced["done"] and any(
                states.get(r.rid) is not None and states[r.rid].started for r in prefilling):
            forced["done"] = True
            raise (PoolExhausted if isinstance(w0.backend.engine, BatchEngine)
                   else JPoolExhausted)("injected mid-chunk pool pressure")
        return orig(budget, decode_batch, prefilling)

    w0.backend.step = step
    return forced


MIGRATION_FIELDS = ("migrations", "migrated_out", "migrated_pages", "migration_bytes",
                    "migration_digest_hits", "migration_s", "n_requests",
                    "transfer_blocks", "transfer_bytes", "transfer_seconds")


@pytest.mark.parametrize("sched,kv_reuse", [("chunked", True), ("wave", False),
                                            ("chunked", False), ("wave", True)])
def test_disagg_matches_jax(systems, sched, kv_reuse):
    jsys, tsys, trace = systems
    trace = _spaced(trace)
    _, unified, _ = _run_port(tsys, trace, sched, kv_reuse)
    teng, trep, _ = _run_port(tsys, trace, sched, kv_reuse, disagg=True)
    _, jrep, _ = _run_jax(jsys, trace, sched, kv_reuse, disagg=True)
    assert trep.generated == unified.generated == jrep.generated
    assert trep.assigned == jrep.assigned
    for tw, jw in zip(trep.workers, jrep.workers):
        for f in MIGRATION_FIELDS:
            assert getattr(tw, f) == getattr(jw, f), f
    pre, dec = trep.workers
    assert [w.role for w in teng.batcher.workers] == ["prefill", "decode"]
    assert pre.migrated_out == len(trace) and pre.migrations == 0
    assert dec.migrations == pre.migrated_out and dec.migrated_pages > 0
    assert dec.migration_bytes > 0 and dec.migration_s > 0
    assert all(w.migrations == 0 for w in unified.workers)
    if kv_reuse:
        assert dec.migration_digest_hits > 0
        for tw, jw in zip(trep.workers, jrep.workers):
            assert tw.kv_reuse["transfers_avoided"] == jw.kv_reuse["transfers_avoided"]
            for c in ("hits_item", "hits_user", "hits_prefix", "inserts", "evictions"):
                assert tw.kv_reuse[c] == jw.kv_reuse[c], c


def test_cluster_mid_chunk_migration_matches_jax(systems):
    """Pool pressure mid-prefill on the prefill worker hands the LIVE scan
    state to the decode worker, which resumes chunking there: tokens equal
    the unified run's, no preemption is spent, and the handoff's ledger
    equals the reference's under the same injection."""
    jsys, tsys, trace = systems
    trace = _spaced(trace)
    kw = dict(step_tokens=128)
    _, unified, _ = _run_port(tsys, trace, "chunked", True, **kw)
    teng, trep, tforced = _run_port(tsys, trace, "chunked", True, disagg=True,
                                    pressure=True, **kw)
    jeng, jrep, jforced = _run_jax(jsys, trace, "chunked", True, disagg=True,
                                   pressure=True, **kw)
    assert tforced["done"] and jforced["done"]
    assert trep.generated == unified.generated == jrep.generated
    assert teng.batcher.workers[0].preempted == 0 == jeng.batcher.workers[0].preempted
    assert trep.workers[0].migrated_out == len(trace)
    for tw, jw in zip(trep.workers, jrep.workers):
        for f in MIGRATION_FIELDS:
            assert getattr(tw, f) == getattr(jw, f), f


# --------------------------------------------------- config surface
def test_disagg_config_validation():
    with pytest.raises(ValueError, match="must be >= 0"):
        API.DisaggConfig(prefill_workers=-1, decode_workers=2)
    with pytest.raises(ValueError, match="both roles"):
        API.DisaggConfig(prefill_workers=2, decode_workers=0)
    with pytest.raises(ValueError, match="mig_gamma"):
        API.DisaggConfig(prefill_workers=1, decode_workers=1, mig_gamma=-0.1)
    off = API.DisaggConfig()
    assert not off.enabled and off.role_of(0) == "unified"
    d = API.DisaggConfig(prefill_workers=2, decode_workers=1)
    assert d.enabled and d.n_workers == 3
    assert [d.role_of(w) for w in range(3)] == ["prefill", "prefill", "decode"]


def test_serve_config_cross_checks():
    with pytest.raises(ValueError, match="k=3 must equal disagg.prefill_workers"):
        API.ServeConfig(k=3, disagg=API.DisaggConfig(**DISAGG))
    with pytest.raises(ValueError, match="k=0"):
        API.ServeConfig(k=0)
    with pytest.raises(ValueError, match="policy"):
        API.ServeConfig(policy="nope")
    with pytest.raises(ValueError, match="prefetch_pages_per_tick=4 needs spill_mb"):
        API.StoreConfig(prefetch_pages_per_tick=4)
    with pytest.raises(ValueError, match="prefetch_pages_per_tick"):
        API.StoreConfig(spill_mb=16, prefetch_pages_per_tick=-2)
    with pytest.raises(ValueError, match="sub-config"):
        API.ServeConfig.parse("disagg=2")
    with pytest.raises(ValueError, match="not a DisaggConfig field"):
        API.ServeConfig.parse("disagg.nope=1")
    with pytest.raises(ValueError, match="not a ServeConfig field"):
        API.ServeConfig.parse("tp=2")
    with pytest.raises(ValueError, match="expected on/off"):
        API.ServeConfig.parse("kv_reuse=maybe")


GRAMMAR = [
    "",
    "k=4,disagg.prefill_workers=2,disagg.decode_workers=2",
    "k=2,policy=round_robin,sched=chunked,chunk_tokens=64,step_tokens=256",
    "k=2,disagg.prefill_workers=1,disagg.decode_workers=1,disagg.mig_gamma=0.5,"
    "sched=chunked,kv_reuse=on,store.kv_store_dtype=int8,store.spill_mb=64,"
    "store.prefetch_pages_per_tick=8",
    "mode=full,n_pages=96,page_size=8,decode_steps=2,r_item=0.25,r_rev=0.5",
    "kv_reuse=true,store.spill_mb=16,max_batch_tokens=2048,max_decode_batch=8",
]


@pytest.mark.parametrize("spec", GRAMMAR)
def test_config_grammar_round_trip(spec):
    cfg = API.ServeConfig.parse(spec)
    assert API.ServeConfig.parse(cfg.render()) == cfg
    # the reference's grammar reads the same knobs the same way
    jcfg = JAPI.ServeConfig.parse("engine=jax," + spec if spec else "engine=jax")
    port, ref = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
    # the engine and the attention-backend knobs name each package's own
    # engine and routes
    for name in ("engine", "attn_backend", "decode_kernel"):
        del port[name]
    assert port == {name: ref[name] for name in port}


def test_from_args_overrides_the_config_string():
    import argparse

    base = API.ServeConfig.parse("k=2,sched=chunked,kv_reuse=on,disagg.prefill_workers=1,"
                                 "disagg.decode_workers=1")
    args = argparse.Namespace(k=None, sched=None, pages=96, kv_reuse="on", policy="random",
                              decode_steps=None, unrelated=3)
    cfg = API.ServeConfig.from_args(args, base=base)
    assert cfg == base.replace(n_pages=96, policy="random")
    assert API.ServeConfig.from_args(argparse.Namespace(), base=base) is base
