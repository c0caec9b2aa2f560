"""Port parity for the tiered store: int8 payloads (bitwise the
reference's quantization), the host-RAM spill tier (spill <-> promote
keeps bytes, refcounts and LRU order), the `StoreConfig` surface, and
fp32 spill parity through the serving loop —
the reference's `tests/test_tiered_store.py` on the port, plus
cross-package checks on identical inputs."""
import jax
import numpy as np
import pytest
import torch

from repro.serving import block_store as JBS
from repro_torch.core.rcllm import make_tiny_system, tiny_config
from repro_torch.launch import serve as PS
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import api as API
from repro_torch.serving import workload as WL
from repro_torch.serving.block_store import (SharedBlockStore, check_partition,
                                             dequantize_rows, quantize_rows)
from repro_torch.serving.kv_pool import PagedKVPool

from _hypothesis_compat import given, settings, st


def _tiny_pool(n_pages=16, page_size=4):
    return PagedKVPool(n_layers=2, n_kv_heads=2, head_dim=4, page_size=page_size,
                       n_pages=n_pages, device="cpu")


def _blk(rng, n, L=2, H=2, D=4):
    return (torch.from_numpy(rng.normal(size=(n, L, H, D)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(n, L, H, D)).astype(np.float32)))


def _arena_rows(pool, slots):
    sl = torch.from_numpy(np.asarray(slots))
    return pool.arena_k[sl // pool.page_size, sl % pool.page_size]


@pytest.fixture(scope="module")
def tiny_system():
    from repro.core.rcllm import make_tiny_system as jax_tiny
    jsys, pool_rv, prof, _ = jax_tiny(n_items=60, n_requests_hist=30, k_instances=1,
                                      n_layers=2, d_model=32)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jsys.params),
                              tiny_config(2, 32), device="cpu")
    tsys, _, _, _ = make_tiny_system(n_items=60, n_requests_hist=30, k_instances=1,
                                     n_layers=2, d_model=32, device="cpu", model=model)
    return tsys, pool_rv, prof


# ------------------------------------------------------- quantization
def _quant_inputs():
    """Random rows at several magnitudes, all-zero rows, rows holding exact
    half-way points (x / scale = k + 0.5, which round to even) and
    subnormal-scale rows."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(7, 3, 2, 16)).astype(np.float32)
    x *= np.float32(10.0) ** rng.integers(-3, 4, size=(7, 3, 2, 1)).astype(np.float32)
    x[1] = 0.0
    # scale exactly 0.5 (absmax 63.5), every other x / scale = k + 0.5
    halves = (np.arange(16, dtype=np.float32) - 7.5) * 0.5
    halves[0] = 63.5
    x[2, :, :] = halves
    x[3, 0, 0] = np.float32(1e-40)
    return x


@pytest.mark.parametrize("case", ["random", "integer_halves", "normal_1e6"])
def test_quantize_rows_equals_reference_bitwise(case):
    """The port's torch quantization gives the reference's numpy int8 codes
    and scales bit for bit, and the same dequantized bytes."""
    if case == "random":
        x = _quant_inputs()
    elif case == "integer_halves":
        x = (np.arange(4 * 2 * 2 * 8, dtype=np.float32).reshape(4, 2, 2, 8) - 60.5)
    else:
        x = np.random.default_rng(3).normal(size=(64, 4, 2, 32)).astype(np.float32) * 1e6
    q_ref, s_ref = JBS.quantize_rows(x)
    q, s = quantize_rows(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), q_ref)
    np.testing.assert_array_equal(s.numpy(), s_ref)
    np.testing.assert_array_equal(dequantize_rows(q, s).numpy(),
                                  JBS.dequantize_rows(q_ref, s_ref))


def test_quantize_rows_shapes_and_bounds():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(5, 2, 3, 8)).astype(np.float32) * 10)
    q, s = quantize_rows(x)
    assert q.shape == x.shape and s.shape == (5, 2, 3, 1)
    assert q.abs().amax(dim=-1).min() == 127
    err = (dequantize_rows(q, s) - x).abs()
    assert err.max() <= (x.abs().max() / 127.0) * 0.5 + 1e-6


def test_quantize_rows_zero_rows_exact():
    x = torch.zeros((3, 1, 2, 4))
    q, s = quantize_rows(x)
    assert torch.equal(dequantize_rows(q, s), x) and torch.equal(s, torch.ones_like(s))


def test_quantize_rows_idempotent():
    """q(dq(q(x))) == q(x): a block can hop store -> spill -> store any
    number of times without drift."""
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(6, 2, 2, 8)).astype(np.float32))
    q1, s1 = quantize_rows(x)
    q2, s2 = quantize_rows(dequantize_rows(q1, s1))
    assert torch.equal(q1, q2) and torch.equal(s1, s2)


def test_int8_store_arena_holds_dequantized_bytes():
    """Under int8 the arena receives dq(q(x)), the reference's bytes for
    the same x; the prefix tier stays bit-exact fp32."""
    pool = _tiny_pool()
    store = SharedBlockStore(pool, kv_store_dtype="int8")
    rng = np.random.default_rng(2)
    k, v = _blk(rng, 6)
    blk = store.insert(("item", "a"), "item", k, v)
    assert blk.scale_k is not None and blk.data_k.dtype == torch.int8
    q_ref, s_ref = JBS.quantize_rows(k.numpy())
    np.testing.assert_array_equal(blk.data_k.numpy(), q_ref)
    np.testing.assert_array_equal(blk.fp32_k.numpy(), JBS.dequantize_rows(q_ref, s_ref))
    assert torch.equal(_arena_rows(pool, blk.slots), blk.fp32_k)
    assert store.dequant_s > 0.0
    pk, pv = _blk(rng, 4)
    pblk = store.insert(("prefix", "p"), "prefix", pk, pv)
    assert pblk.scale_k is None and pblk.data_k is None and torch.equal(pblk.fp32_k, pk)
    check_partition(pool, store)


def test_fp32_store_is_bit_exact():
    pool = _tiny_pool()
    store = SharedBlockStore(pool)
    k, v = _blk(np.random.default_rng(3), 5)
    blk = store.insert(("item", "x"), "item", k, v)
    assert blk.scale_k is None and torch.equal(blk.fp32_k, k)
    assert store.dequant_s == 0.0


def test_fp32_block_keeps_no_payload_and_spills_its_arena_bytes():
    """A resident fp32 block's bytes are its arena slots alone: eviction to
    the spill tier reads them back to the host, and promotion lands them
    in new slots unchanged."""
    pool = _tiny_pool(n_pages=16, page_size=4)
    store = SharedBlockStore(pool, spill_mb=4)
    k, v = _blk(np.random.default_rng(13), 7)
    blk = store.insert(("item", "a"), "item", k, v)
    assert blk.data_k is None and blk.data_v is None and blk.scale_k is None
    assert torch.equal(_arena_rows(pool, blk.slots), k)
    assert store._evict_lru()
    sp = store.spill_peek(("item", "a"))
    assert torch.equal(sp.data_k, k) and torch.equal(sp.data_v, v)
    assert sp.nbytes == 2 * k.numel() * k.element_size()
    # other bytes land in the freed pages before the promotion
    store.insert(("item", "b"), "item", *_blk(np.random.default_rng(14), 16))
    blk = store.insert(("item", "a"), "item", k * 0, v * 0)
    store.flush_writes()
    assert blk.data_k is None and torch.equal(blk.fp32_k, k) and torch.equal(blk.fp32_v, v)
    check_partition(pool, store)


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
def test_evicting_an_unflushed_block_drops_its_write(dtype):
    """A block evicted before its deferred write lands (one prefetch
    promotion evicted by the next) spills its own bytes, and its write
    never lands on the pages the next block is handed."""
    pool = _tiny_pool(n_pages=8, page_size=4)
    store = SharedBlockStore(pool, spill_mb=1, kv_store_dtype=dtype)
    rng = np.random.default_rng(3)
    w, x, y = _blk(rng, 3), _blk(rng, 8), _blk(rng, 8)
    store.insert(("item", "w"), "item", *w, defer_write=True).refcount += 1
    store.insert(("item", "x"), "item", *x, defer_write=True)
    assert store.evict_for(pool.n_pages - 2)       # x goes, w (referenced) stays
    assert [p[0] for p in store._pending_writes] == [store.blocks[("item", "w")].slots]
    blk = store.insert(("item", "y"), "item", *y, defer_write=True)
    store.flush_writes()
    rt = ((lambda t: dequantize_rows(*quantize_rows(t))) if dtype == "int8"
          else (lambda t: t))
    assert torch.equal(_arena_rows(pool, blk.slots), rt(y[0]))
    sp = store.spill[("item", "x")]
    got = sp.data_k if sp.scale_k is None else dequantize_rows(sp.data_k, sp.scale_k)
    assert torch.equal(got, rt(x[0]))
    check_partition(pool, store)


def test_fp32_insert_writes_the_callers_bytes_without_a_copy():
    """An fp32 insert already on the pool's device stages the caller's
    tensors for the deferred arena write as they are (no copy); int8
    stages the dequantized bytes."""
    pool = _tiny_pool()
    k, v = _blk(np.random.default_rng(15), 5)
    store = SharedBlockStore(pool)
    store.insert(("item", "x"), "item", k, v, defer_write=True)
    (_, sk, sv), = store._pending_writes
    assert sk.data_ptr() == k.data_ptr() and sv.data_ptr() == v.data_ptr()
    store.flush_writes()
    assert torch.equal(_arena_rows(pool, store.peek(("item", "x")).slots), k)
    q8 = SharedBlockStore(_tiny_pool(), kv_store_dtype="int8")
    q8.insert(("item", "x"), "item", k, v, defer_write=True)
    (_, sk, _), = q8._pending_writes
    assert torch.equal(sk, dequantize_rows(*quantize_rows(k)))


# --------------------------------------------------------- spill tier
def test_evict_spills_to_host_and_promotes_on_reinsert():
    pool = _tiny_pool(n_pages=16, page_size=4)
    store = SharedBlockStore(pool, spill_mb=4)
    rng = np.random.default_rng(4)
    k, v = _blk(rng, 8)
    store.insert(("item", "a"), "item", k, v)
    assert store._evict_lru()
    assert not store.has(("item", "a"))
    assert store.in_spill(("item", "a")) and store.resident(("item", "a"))
    assert store.spill_peek(("item", "a")).data_k.device.type == "cpu"
    assert store.counters["spills"] == 1
    check_partition(pool, store)
    # the same key again: served from the spill tier (a spill hit)
    blk = store.insert(("item", "a"), "item", k * 0, v * 0)
    assert blk is not None and store.has(("item", "a")) and not store.in_spill(("item", "a"))
    assert store.counters["spill_hits"] == 1
    store.flush_writes()
    assert torch.equal(blk.fp32_k, k) and torch.equal(_arena_rows(pool, blk.slots), k)
    check_partition(pool, store)


def test_spill_capacity_trims_oldest():
    """LRU order survives the spill hop: the device-tier stamp rides along,
    so capacity trimming drops the coldest block first."""
    pool = _tiny_pool(n_pages=32, page_size=4)
    rng = np.random.default_rng(5)
    k, v = _blk(rng, 4)
    one_block = 2 * k.numel() * k.element_size()
    store = SharedBlockStore(pool, spill_mb=1)
    store.spill_cap = int(2.5 * one_block)
    keys = [("item", f"b{i}") for i in range(3)]
    for key in keys:
        store.insert(key, "item", *_blk(rng, 4))
    store.get(keys[1])
    store.get(keys[2])
    while store._evict_lru():
        pass
    assert store.counters["spills"] == 3 and store.counters["spill_drops"] == 1
    assert not store.in_spill(keys[0])
    assert store.in_spill(keys[1]) and store.in_spill(keys[2])
    assert store.spill_nbytes == 2 * one_block
    check_partition(pool, store)


@settings(max_examples=25, deadline=None)
@given(
    n_tokens=st.lists(st.integers(min_value=1, max_value=10), min_size=1, max_size=6),
    dtype=st.sampled_from(["fp32", "int8"]),
    seed=st.integers(min_value=0, max_value=2**16),
)
def test_spill_promote_roundtrip_property(n_tokens, dtype, seed):
    """Evict-to-spill then promote keeps every block's bytes and refcounts,
    and the partition holds at every hop."""
    pytest.importorskip("hypothesis")
    pool = _tiny_pool(n_pages=64, page_size=4)
    store = SharedBlockStore(pool, kv_store_dtype=dtype, spill_mb=64)
    rng = np.random.default_rng(seed)
    before = {}
    for i, n in enumerate(n_tokens):
        key = ("item", f"p{i}")
        blk = store.insert(key, "item", *_blk(rng, n))
        assert blk is not None
        store.flush_writes()
        before[key] = (blk.fp32_k.clone(), blk.fp32_v.clone())
    check_partition(pool, store)
    while store._evict_lru():
        pass
    assert not store.blocks and len(store.spill) == len(before)
    assert store.spill_nbytes == sum(s.nbytes for s in store.spill.values())
    check_partition(pool, store)
    for key in before:
        blk = store._promote(key)
        assert blk is not None and blk.refcount == 0
    store.flush_writes()
    for key, (hk, hv) in before.items():
        blk = store.peek(key)
        assert torch.equal(blk.fp32_k, hk) and torch.equal(blk.fp32_v, hv)
        assert torch.equal(_arena_rows(pool, blk.slots), hk)
    assert not store.spill and store.spill_nbytes == 0
    check_partition(pool, store)


# ----------------------------------------------------- config surface
def test_store_config_validation():
    with pytest.raises(ValueError, match="kv_store_dtype"):
        API.StoreConfig(kv_store_dtype="int4")
    with pytest.raises(ValueError, match="spill_mb"):
        API.StoreConfig(spill_mb=-1)
    assert not API.StoreConfig().enabled
    assert API.StoreConfig(kv_store_dtype="int8").enabled
    assert API.StoreConfig(spill_mb=16).enabled


def test_store_config_requires_reuse():
    with pytest.raises(ValueError, match="kv_reuse"):
        API.ServeConfig(store=API.StoreConfig(spill_mb=16))
    cfg = API.ServeConfig(kv_reuse=True, store=API.StoreConfig(
        kv_store_dtype="int8", spill_mb=16))
    assert cfg.store.enabled


def test_build_engine_threads_store_config(tiny_system):
    tsys, _, _ = tiny_system
    cfg = API.ServeConfig(kv_reuse=True, n_pages=64, store=API.StoreConfig(
        kv_store_dtype="int8", spill_mb=16))
    eng = API.build_engine(tsys.model, tsys.cfg, cfg, cache=tsys.rows)
    assert eng.store.kv_store_dtype == "int8"
    assert eng.store.spill_cap == 16 * 2**20
    assert eng.store.pool is eng.pool
    assert API.build_engine(tsys.model, tsys.cfg, API.ServeConfig(n_pages=64),
                            cache=tsys.rows).store is None


# ---------------------------------------------- serving with the tiers
def _run(tsys, reqs, plans, reuse, sched, store, n_pages=96):
    config = API.ServeConfig(decode_steps=3, sched=sched, kv_reuse=True, n_pages=n_pages,
                             store=store)
    engine, backend, _, done = PS.serve(tsys.model, tsys.cfg, config, reqs, plans,
                                        tsys.rows, reuse)
    assert len(done) == len(reqs)
    assert engine.pool.stats().pages_in_use == 0
    check_partition(engine.pool, engine.store)
    return backend, engine


@pytest.mark.parametrize("sched", ["wave", "chunked"])
def test_fp32_spill_decoded_parity(tiny_system, sched):
    """fp32 payloads with the spill tier on decode the same
    tokens as the plain store: demotion and promotion change where bytes
    wait, never what they are.  The small pool forces evictions through
    the spill tier, and the int8 run on the same trace spills and
    promotes too."""
    tsys, pool_rv, prof = tiny_system
    trace = WL.zipf_repeat_trace(tsys.catalog, pool_rv, prof, 8, qps=12.0, n_users=3,
                                 zipf_a=1.4, seed=3)
    reqs, plans = WL.rcllm_workload(tsys, trace, decode_steps=3)
    reuse = WL.rcllm_reuse_info(tsys, trace, plans)
    b_plain, e_plain = _run(tsys, reqs, plans, reuse, sched, API.StoreConfig())
    b_spill, e_spill = _run(tsys, reqs, plans, reuse, sched, API.StoreConfig(spill_mb=64))
    assert b_plain.generated == b_spill.generated
    st_plain, st_spill = e_plain.store.stats(), e_spill.store.stats()
    assert st_plain["evictions"] > 0 and st_spill["spills"] > 0
    _, e_int8 = _run(tsys, reqs, plans, reuse, sched, API.StoreConfig(
        kv_store_dtype="int8", spill_mb=64))
    st = e_int8.store.stats()
    assert st["spills"] > 0 and st["spill_hits"] > 0
