"""Port parity for the cluster's host-side policy layer: the cost model
(`core/cost_model.py`), the Eq. 2 scheduler (`core/scheduler.py`), the
placement's runtime helpers and the item-shard client's transfer ledger
(`core/item_cache.py:ShardClient`), against the JAX package on the same
inputs.  The cost model is held to rel 1e-12 on equal `Hardware` numbers;
routing and ledgers exactly."""
import dataclasses

import numpy as np
import pytest

from repro.configs.rcllm_qwen3_8b import CONFIG as JQWEN
from repro.core import cost_model as JCM
from repro.core import item_cache as JIC
from repro.core import placement as JPL
from repro.core import scheduler as JSCH
from repro.data import synth as JSY
from repro_torch.configs.rcllm_qwen3_8b import CONFIG as TQWEN
from repro_torch.core import cost_model as TCM
from repro_torch.core import item_cache as TIC
from repro_torch.core import placement as TPL
from repro_torch.core import scheduler as TSCH
from repro_torch.core.rcllm import tiny_config
from repro_torch.data import synth as TSY

L_, HKV, DH = 2, 2, 4   # cache-block shape of the fake KV


def _jax_tiny():
    from repro.configs.base import LMConfig
    t = tiny_config(2, 32)
    return LMConfig(name=t.name, n_layers=t.n_layers, d_model=t.d_model,
                    n_heads=t.n_heads, n_kv_heads=t.n_kv_heads, head_dim=t.head_dim,
                    d_ff=t.d_ff, vocab_size=t.vocab_size, mlp_type=t.mlp_type,
                    dtype=t.dtype)


CFGS = {"qwen3-8b": (JQWEN, TQWEN), "tiny": (_jax_tiny(), tiny_config(2, 32))}


def _hw_pair():
    h = TCM.H100_SXM
    return JCM.Hardware(**dataclasses.asdict(h)), h


def test_h100_constants():
    h = TCM.H100_SXM
    assert (h.peak_flops, h.hbm_bw, h.host_to_device_bw) == (989e12, 3.35e12, 64e9)
    assert (h.network_bw, h.network_rtt, h.mfu) == (12.5e9, 200e-6, 0.45)
    assert h != TCM.Hardware(**dataclasses.asdict(JCM.V5E_1))


COST_CASES = [
    ("kv_bytes_per_token", lambda CM, cfg, hw: CM.kv_bytes_per_token(cfg)),
    ("prefill_flops", lambda CM, cfg, hw: CM.prefill_flops(cfg, 453, 137)),
    ("prefill_flops_no_l0", lambda CM, cfg, hw: CM.prefill_flops(cfg, 453, 137, False)),
    ("prefill_time_s", lambda CM, cfg, hw: CM.prefill_time_s(cfg, hw, 453, 137)),
    ("fetch_time_s", lambda CM, cfg, hw: CM.fetch_time_s(cfg, hw, 220, 75)),
    ("fetch_time_s_local", lambda CM, cfg, hw: CM.fetch_time_s(cfg, hw, 220, 0)),
    ("ttft_s", lambda CM, cfg, hw: CM.ttft_s(cfg, hw, 453, 137, 220, 75)),
    ("ttft_s_no_l0", lambda CM, cfg, hw: CM.ttft_s(cfg, hw, 453, 137, 220, 75, False)),
    ("full_prefill_ttft_s", lambda CM, cfg, hw: CM.full_prefill_ttft_s(cfg, hw, 453)),
    ("prefix_cache_ttft_s", lambda CM, cfg, hw: CM.prefix_cache_ttft_s(cfg, hw, 453, 207)),
    ("decode_step_time_s", lambda CM, cfg, hw: CM.decode_step_time_s(cfg, hw, 8, 460)),
    ("decode_step_time_s_big", lambda CM, cfg, hw: CM.decode_step_time_s(cfg, hw, 512)),
]


@pytest.mark.parametrize("cfg_name", sorted(CFGS))
@pytest.mark.parametrize("name,fn", COST_CASES, ids=[c[0] for c in COST_CASES])
def test_cost_model_matches_jax(cfg_name, name, fn):
    jcfg, tcfg = CFGS[cfg_name]
    jhw, thw = _hw_pair()
    want = fn(JCM, jcfg, jhw)
    got = fn(TCM, tcfg, thw)
    assert got == pytest.approx(want, rel=1e-12, abs=0)


# ------------------------------------------------------- routing + ledger
def _world(SY, seed=0):
    prof = dataclasses.replace(SY.PROFILES["amazon"], n_items=60, n_clusters=6,
                               mean_item_tokens=24, mean_review_tokens=20)
    catalog = SY.make_catalog(prof, vocab_size=4096, seed=seed)
    pool = SY.make_review_pool(vocab_size=4096, n_phrases=120, seed=seed + 1)
    trace = SY.make_trace(catalog, pool, prof, n_requests=40, qps=10.0, n_users=12,
                          n_candidates=8, reviews_per_user=2, seed=seed + 2)
    return catalog, trace


@pytest.fixture(scope="module", params=[2, 4], ids=["k2", "k4"])
def placements(request):
    k = request.param
    jc, jt = _world(JSY)
    tc, tt = _world(TSY)
    jp = JPL.place(jc.n_items, [r.candidate_items for r in jt], k)
    tp = TPL.place(tc.n_items, [r.candidate_items for r in tt], k)
    np.testing.assert_array_equal(jp.shard_of, tp.shard_of)
    return k, jp, tp, [r.candidate_items for r in tt]


def test_placement_helpers_match_jax(placements):
    k, jp, tp, reqs = placements
    for inst in range(k):
        np.testing.assert_array_equal(tp.items_on(inst), jp.items_on(inst))
        for it in range(len(tp.shard_of)):
            assert tp.is_local(it, inst) == jp.is_local(it, inst)
        for items in reqs + [np.zeros(0, np.int64)]:
            assert tp.hit_rate(items, inst) == jp.hit_rate(items, inst)
            assert TSCH.hit_ratio(items, tp, inst) == JSCH.hit_ratio(items, jp, inst)
    for items in reqs:
        np.testing.assert_array_equal(TSCH.hit_vector(items, tp),
                                      JSCH.hit_vector(items, jp))


def _depths(rng, k):
    """Seeded live queue depths: idle, ties, and a spread of loads."""
    out = [np.zeros(k), np.full(k, 0.5)]
    out += [rng.exponential(0.2, k) for _ in range(10)]
    out += [np.where(rng.random(k) < 0.5, 0.0, rng.random(k)) for _ in range(4)]
    return out


@pytest.mark.parametrize("policy", TSCH.POLICIES)
def test_route_and_dispatch_match_jax(placements, policy):
    k, jp, tp, reqs = placements
    rng = np.random.default_rng(7)
    js, ts = JSCH.SchedulerState.fresh(k), TSCH.SchedulerState.fresh(k)
    jr, tr = np.random.default_rng(11), np.random.default_rng(11)
    jd = JSCH.ClusterScheduler(jp, policy=policy, seed=3)
    td = TSCH.ClusterScheduler(tp, policy=policy, seed=3)
    for items in reqs:
        for depth in _depths(rng, k):
            js.queue_depth, ts.queue_depth = depth.copy(), depth.copy()
            np.testing.assert_array_equal(TSCH.load_vector(ts), JSCH.load_vector(js))
            assert TSCH.route(items, tp, ts, policy, rng=tr) == \
                JSCH.route(items, jp, js, policy, rng=jr)
            assert td.dispatch(items, list(depth)) == jd.dispatch(items, list(depth))
    assert ts.rr_next == js.rr_next


def test_scheduler_rejects_unknown_policy(placements):
    _, _, tp, _ = placements
    with pytest.raises(ValueError, match="unknown policy"):
        TSCH.ClusterScheduler(tp, policy="nope")
    with pytest.raises(ValueError):
        TSCH.route(np.asarray([0]), tp, TSCH.SchedulerState.fresh(tp.k), "nope")


def _item_store(SY, PL, IC, placement, catalog):
    docs = [np.concatenate([[SY.ITEM_SEP], t]).astype(np.int32)
            for t in catalog.item_tokens]
    rng = np.random.default_rng(5)
    kv = [(rng.normal(size=(len(d), L_, HKV, DH)).astype(np.float32),
           rng.normal(size=(len(d), L_, HKV, DH)).astype(np.float32)) for d in docs]
    return IC.build_item_store(docs, placement, kv_list=kv, coverage=0.8, seed=1)


def _ledger(client):
    return [(t.item_id, t.src_instance, t.n_tokens, t.n_bytes) for t in client.transfers]


def test_shard_client_ledger_matches_jax(placements):
    k, jp, tp, reqs = placements
    jc, _ = _world(JSY)
    tc, _ = _world(TSY)
    jstore = _item_store(JSY, JPL, JIC, jp, jc)
    tstore = _item_store(TSY, TPL, TIC, tp, tc)
    hot = set(int(h) for h in tp.hot_items)
    for inst in range(k):
        jcl, tcl = JIC.ShardClient(jstore, inst), TIC.ShardClient(tstore, inst)
        for items in reqs:
            items = list(items) + list(items[:2])     # repeats stage once
            js, jm = jcl.stage(items)
            ts, tm = tcl.stage(items)
            assert sorted(js) == sorted(ts) and jm == tm
            view = TIC.StagedBlocks(ts)
            for it in ts:
                np.testing.assert_array_equal(view.get_block(it).k, js[it].k)
            assert view.get_block(10**6) is None
        assert _ledger(tcl) == _ledger(jcl) and tcl.transfers
        assert (tcl.n_local_blocks, tcl.n_miss_blocks) == (jcl.n_local_blocks,
                                                           jcl.n_miss_blocks)
        assert tcl.transferred_bytes() == jcl.transferred_bytes()
        assert tcl.transferred_tokens() == jcl.transferred_tokens()
        for rec in tcl.transfers:       # never a hot item, never its own shard
            assert rec.item_id not in hot and rec.src_instance != inst
            assert not tcl.resident(rec.item_id) and tcl.local_block(rec.item_id) is None
