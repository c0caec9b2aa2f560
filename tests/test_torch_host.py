"""Port parity for the host-side numpy modules: the synthetic corpus,
Algorithm-1 placement, both cache pools and the assembly plan must equal
the JAX package's on the same seeds (arrays `array_equal`, plans field by
field)."""
import dataclasses

import numpy as np
import pytest

from repro.core import assembly as JA
from repro.core import item_cache as JIC
from repro.core import placement as JPL
from repro.core import semantic_cache as JSC
from repro.data import synth as JSY
from repro_torch.core import assembly as TA
from repro_torch.core import item_cache as TIC
from repro_torch.core import placement as TPL
from repro_torch.core import semantic_cache as TSC
from repro_torch.core.scheduler import hit_vector
from repro_torch.data import synth as TSY

L_, HKV, DH = 2, 2, 4   # cache-block shape for the fake KV


def _world(SY, seed):
    prof = dataclasses.replace(SY.PROFILES["amazon"], n_items=60, n_clusters=6,
                               mean_item_tokens=24, mean_review_tokens=20)
    catalog = SY.make_catalog(prof, vocab_size=4096, seed=seed)
    pool = SY.make_review_pool(vocab_size=4096, n_phrases=120, seed=seed + 1)
    trace = SY.make_trace(catalog, pool, prof, n_requests=30, qps=10.0,
                          n_users=12, n_candidates=8, reviews_per_user=2,
                          seed=seed + 2, user_zipf_a=1.2, long_prompt_frac=0.2)
    return catalog, pool, trace


def _assert_fields_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        elif isinstance(x, list):
            assert len(x) == len(y), f.name
            for u, w in zip(x, y):
                np.testing.assert_array_equal(u, w, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("seed", range(3))
def test_synth_equal(seed):
    jc, jp, jt = _world(JSY, seed)
    tc, tp, tt = _world(TSY, seed)
    _assert_fields_equal(jc, tc)
    _assert_fields_equal(jp, tp)
    assert len(jt) == len(tt)
    instr_j = JSY.make_instruction(207, jc.vocab_size)
    instr_t = TSY.make_instruction(207, tc.vocab_size)
    np.testing.assert_array_equal(instr_j, instr_t)
    for a, b in zip(jt, tt):
        _assert_fields_equal(a, b)
        for x, y in zip(a.prompt_segments(jc, instr_j), b.prompt_segments(tc, instr_t)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_placement_equal(k):
    jc, _, jt = _world(JSY, 0)
    items = [r.candidate_items for r in jt]
    a = JPL.place(jc.n_items, items, k)
    b = TPL.place(jc.n_items, items, k)
    _assert_fields_equal(a, b)
    for r in jt:
        from repro.core.scheduler import hit_vector as jax_hit_vector
        np.testing.assert_array_equal(hit_vector(r.candidate_items, b),
                                      jax_hit_vector(r.candidate_items, a))


def _fake_kv(docs, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(len(d), L_, HKV, DH)).astype(np.float32),
             rng.normal(size=(len(d), L_, HKV, DH)).astype(np.float32))
            for d in docs]


def _pools(SY, PL, IC, SC, seed, coverage):
    """Both cache pools over fake (seeded) KV, built the way
    `RcLLMSystem.build` builds them."""
    catalog, pool, trace = _world(SY, seed)
    placement = PL.place(catalog.n_items, [r.candidate_items for r in trace], 2)
    corpus = list({r.user_id: r.history_tokens for r in trace}.values())
    embed = np.random.default_rng(seed + 9).normal(size=(4096, 16)).astype(np.float32)
    corpus_kv = _fake_kv(corpus, seed + 1)
    semantic = SC.build_semantic_cache(corpus, embed, n_bits=8, seed=seed)
    SC.materialize_kv(semantic, corpus, None, kv_by_doc=lambda i: corpus_kv[i])
    docs = [np.concatenate([[SY.ITEM_SEP], t]).astype(np.int32)
            for t in catalog.item_tokens]
    store = IC.build_item_store(docs, placement, kv_list=_fake_kv(docs, seed + 2),
                                coverage=coverage, seed=seed)
    return catalog, trace, placement, semantic, store, embed


@pytest.mark.parametrize("coverage", [1.0, 0.6])
def test_cache_pools_equal(coverage):
    jc, jt, jpl, jsem, jstore, _ = _pools(JSY, JPL, JIC, JSC, 0, coverage)
    tc, tt, tpl, tsem, tstore, _ = _pools(TSY, TPL, TIC, TSC, 0, coverage)
    assert jsem.bucket_to_proto == tsem.bucket_to_proto
    for name in ("proto_embed", "proto_token", "proto_position", "proto_k", "proto_v"):
        np.testing.assert_array_equal(getattr(jsem, name), getattr(tsem, name))
    np.testing.assert_array_equal(jstore.token_count, tstore.token_count)
    for a, b in zip(jstore.shards, tstore.shards):
        assert sorted(a.blocks) == sorted(b.blocks)
        for it in a.blocks:
            np.testing.assert_array_equal(a.blocks[it].k, b.blocks[it].k)
    for r in jt[:10]:
        assert jstore.lookup(r.candidate_items, 0) == tstore.lookup(r.candidate_items, 0)


@pytest.mark.parametrize("seed", range(2))
def test_assembly_plans_equal(seed):
    jc, jt, _, jsem, jstore, embed = _pools(JSY, JPL, JIC, JSC, seed, 0.8)
    tc, tt, _, tsem, tstore, _ = _pools(TSY, TPL, TIC, TSC, seed, 0.8)
    instr = JSY.make_instruction(207, jc.vocab_size)
    n_reuse = 0
    for a, b in zip(jt, tt):
        for inst in (0, 1):
            tj, kj, ij = a.prompt_segments(jc, instr)
            tt_, kt, it_ = b.prompt_segments(tc, instr)
            pj = JA.build_plan(tj, kj, ij, a.history_marker_mask, jstore, jsem,
                               embed, instance=inst)
            pt = TA.build_plan(tt_, kt, it_, b.history_marker_mask, tstore, tsem,
                               embed, instance=inst)
            _assert_fields_equal(pj, pt)
            assert [dataclasses.astuple(s) for s in JA.plan_spans(pj)] == \
                [dataclasses.astuple(s) for s in TA.plan_spans(pt)]
            gj = JA.gather_cached_kv(pj, jstore, jsem, inst, L_, HKV, DH)
            gt = TA.gather_cached_kv(pt, tstore, tsem, inst, L_, HKV, DH)
            for x, y in zip(gj, gt):
                np.testing.assert_array_equal(x, y)
            n_reuse += int(gt[2].sum())
    assert n_reuse > 0   # the plans exercised both cache pools
