"""Port parity for the multi-instance cluster (`serving/cluster.py`): K=2
engine workers over sharded item caches behind the Eq. 2 router, against
the JAX package's `ClusterEngine` on the same weights (its init converted
through numpy) and the same traces.

Routing under `affinity` reads each worker's backlog, which comes from
measured step times, so the two packages route a busy trace apart.  The
cross-package runs are therefore clock-free: arrivals 1000 s apart (every
dispatch sees idle workers, and Eq. 2 reduces to its hit term), or
round-robin routing of two waves whose requests arrive at one instant
each.  Assignments, hit rates, tokens, transfer ledgers, billed seconds
(on one `Hardware`) and block-store counters must then be equal.  Bursty
traces are served by the port alone."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.core import cost_model as JCM
from repro.data import synth as JSY
from repro.serving import api as JAPI
from repro.serving import workload as JWL
from repro.serving.cluster import ClusterEngine as JCluster
from repro_torch.core import cost_model as TCM
from repro_torch.core.rcllm import make_tiny_system, tiny_config
from repro_torch.launch import serve as PS
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.api import ServeConfig, StoreConfig
from repro_torch.serving.block_store import SharedBlockStore, check_partition, dequantize_rows
from repro_torch.serving.cluster import ClusterEngine

DECODE_STEPS = 3
STORE_COUNTERS = ("hits_user", "hits_item", "hits_prefix", "misses_user", "misses_item",
                  "misses_prefix", "inserts", "insert_skips", "evictions", "spills",
                  "insert_spills", "spill_drops", "spill_hits", "prefetch_promotions",
                  "device_blocks", "spill_blocks", "transfers_avoided")
JHW = JCM.Hardware(**dataclasses.asdict(TCM.H100_SXM))


@pytest.fixture(scope="module")
def systems():
    from repro.core.rcllm import make_tiny_system as jax_tiny
    jsys, pool_rv, prof, _ = jax_tiny(n_items=60, n_requests_hist=40, k_instances=2,
                                      n_layers=2, d_model=32)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jsys.params),
                              tiny_config(2, 32), device="cpu")
    tsys, _, _, _ = make_tiny_system(n_items=60, n_requests_hist=40, k_instances=2,
                                     n_layers=2, d_model=32, device="cpu", model=model)
    np.testing.assert_array_equal(jsys.placement.shard_of, tsys.placement.shard_of)
    return jsys, tsys, pool_rv, prof


def _bursty(system, pool_rv, prof):
    """The reference cluster tests' trace: 6 requests at 4 requests/s."""
    return JSY.make_trace(system.catalog, pool_rv, prof, 6, qps=4.0, n_users=3,
                          n_candidates=8, reviews_per_user=1, seed=21, cluster_bias=0.85)


def _spaced(trace, gap=1000.0):
    return [dataclasses.replace(r, arrival_s=gap * i) for i, r in enumerate(trace)]


def _two_waves(trace):
    half = len(trace) // 2
    return [dataclasses.replace(r, arrival_s=0.0 if i < half else 1000.0)
            for i, r in enumerate(trace)]


@pytest.fixture(scope="module")
def zipf(systems):
    """The repeat-user trace of the port's block-store tests in two
    waves: the second meets a store the first has churned."""
    jsys, _, pool_rv, prof = systems
    return _two_waves(JWL.zipf_repeat_trace(jsys.catalog, pool_rv, prof, 10, qps=1e6,
                                            n_users=3, zipf_a=1.4, seed=3))


def _run_jax(jsys, trace, **kw):
    cfg = JAPI.ServeConfig(engine="jax", k=2, chunk_tokens=64, decode_steps=DECODE_STEPS,
                           **kw)
    eng = JCluster(jsys, cfg, hw=JHW)
    return eng, eng.run(trace, decode_steps=DECODE_STEPS)


def _drained(eng):
    """No page or store reference held, the partition intact, nothing the
    cluster bound kept alive."""
    for b in eng.backends:
        assert b.engine.pool.stats().pages_in_use == 0 and not b.engine.prefill_states
        check_partition(b.engine.pool, b.engine.store)
        if b.engine.store is not None:
            assert all(blk.refcount == 0 for blk in b.engine.store.blocks.values())
        assert not b.plans and not b.reuse and not b.pending_transfer_s


def _run_port(tsys, trace, **kw):
    config = ServeConfig(k=2, chunk_tokens=64, decode_steps=DECODE_STEPS, **kw)
    eng = ClusterEngine(tsys, config)
    rep = eng.run(trace, decode_steps=DECODE_STEPS)
    assert len(rep.completions) == len(trace)
    _drained(eng)
    return eng, rep


def _ledgers(eng):
    return [[(t.item_id, t.src_instance, t.n_tokens, t.n_bytes) for t in b.shard.transfers]
            for b in eng.backends]


def _assert_reports_equal(jeng, jrep, teng, trep):
    assert trep.assigned == jrep.assigned
    assert trep.hit_rate == jrep.hit_rate
    assert trep.generated == jrep.generated
    assert trep.policy == jrep.policy
    assert _ledgers(teng) == _ledgers(jeng)
    for jw, tw in zip(jrep.workers, trep.workers):
        for f in ("n_requests", "mean_hit_rate", "transfer_blocks", "transfer_tokens",
                  "transfer_bytes", "transfer_seconds", "migrations", "migrated_out",
                  "migrated_pages", "migration_bytes", "migration_digest_hits"):
            assert getattr(tw, f) == getattr(jw, f), f


@pytest.mark.parametrize("sched", ["wave", "chunked"])
@pytest.mark.parametrize("policy", ["affinity", "round_robin"])
def test_cluster_matches_jax(systems, policy, sched):
    jsys, tsys, pool_rv, prof = systems
    trace = _spaced(_bursty(jsys, pool_rv, prof))
    jeng, jrep = _run_jax(jsys, trace, policy=policy, sched=sched)
    teng, trep = _run_port(tsys, trace, policy=policy, sched=sched)
    _assert_reports_equal(jeng, jrep, teng, trep)
    assert trep.mean_hit_rate() == jrep.mean_hit_rate()
    if policy == "round_robin":
        assert sum(w.transfer_blocks for w in trep.workers) > 0
        assert all(w.transfer_seconds > 0 for w in trep.workers if w.transfer_blocks)


REUSE_CASES = {
    "fp32-wave": dict(sched="wave"),
    "fp32-chunked": dict(sched="chunked"),
    "fp32-chunked-48pages": dict(sched="chunked", n_pages=48),
    "int8-spill-prefetch": dict(sched="chunked", n_pages=48, store=(
        "int8", 16, 8)),
}


@pytest.fixture
def admitted(monkeypatch):
    """key -> (k, v): the fp32 bytes each store wrote at a block's latest
    admission (any worker: the bytes of a key are the same everywhere)."""
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


@pytest.mark.parametrize("case", sorted(REUSE_CASES))
def test_cluster_kv_reuse_matches_jax(systems, zipf, case, admitted):
    """Round-robin over two waves: the store counters of every worker
    (transfers avoided, spill hits and prefetch promotions included), the
    transfer ledgers and the tokens equal the reference's."""
    jsys, tsys, _, _ = systems
    kw = dict(REUSE_CASES[case])
    jkw, tkw = dict(kw), dict(kw)
    if "store" in kw:
        dt, spill, pf = kw["store"]
        jkw["store"] = JAPI.StoreConfig(kv_store_dtype=dt, spill_mb=spill,
                                        prefetch_pages_per_tick=pf)
        tkw["store"] = StoreConfig(kv_store_dtype=dt, spill_mb=spill,
                                   prefetch_pages_per_tick=pf)
    jeng, jrep = _run_jax(jsys, zipf, policy="round_robin", kv_reuse=True, **jkw)
    teng, trep = _run_port(tsys, zipf, policy="round_robin", kv_reuse=True, **tkw)
    _assert_reports_equal(jeng, jrep, teng, trep)
    for jw, tw in zip(jrep.workers, trep.workers):
        got = {c: tw.kv_reuse[c] for c in STORE_COUNTERS}
        assert got == {c: jw.kv_reuse[c] for c in STORE_COUNTERS}
        assert (tw.spill_hits, tw.prefetch_promotions) == (jw.spill_hits,
                                                           jw.prefetch_promotions)
    for b in teng.backends:          # no request wrote into a store-shared slot
        pool, store = b.engine.pool, b.engine.store
        for blk in store.blocks.values():
            sl = torch.from_numpy(blk.slots)
            k = pool.arena_k[sl // pool.page_size, sl % pool.page_size]
            assert torch.equal(k, admitted[blk.key][0]), blk.key
    if "store" in kw:
        assert sum(w.prefetch_promotions for w in trep.workers) > 0
        assert sum(w.kv_reuse["transfers_avoided"] for w in trep.workers) > 0
    else:
        assert sum(w.kv_reuse["hits_item"] for w in trep.workers) > 0


# ------------------------------------------------------------ port only
@pytest.fixture(scope="module")
def bursty_runs(systems):
    jsys, tsys, pool_rv, prof = systems
    trace = _bursty(jsys, pool_rv, prof)
    out = {}
    for policy in ("affinity", "round_robin", "least_loaded", "random"):
        for sched in ("wave", "chunked"):
            out[policy, sched] = _run_port(tsys, trace, policy=policy, sched=sched)
    return out


def test_bursty_tokens_equal_across_policies(bursty_runs):
    ref = bursty_runs["affinity", "wave"][1].generated
    for (policy, sched), (eng, rep) in bursty_runs.items():
        assert rep.generated == ref, (policy, sched)
        assert len(rep.completions) == 6


@pytest.mark.parametrize("sched", ["wave", "chunked"])
def test_bursty_affinity_keeps_locality(bursty_runs, systems, sched):
    _, tsys, _, _ = systems
    aff, rr = bursty_runs["affinity", sched][1], bursty_runs["round_robin", sched][1]
    assert aff.mean_hit_rate() >= rr.mean_hit_rate()
    eng = bursty_runs["round_robin", sched][0]
    hot = set(int(h) for h in tsys.placement.hot_items)
    for wid, b in enumerate(eng.backends):
        for rec in b.shard.transfers:
            assert rec.item_id not in hot and rec.src_instance != wid


def test_workers_share_the_model_and_rows(bursty_runs, systems):
    _, tsys, _, _ = systems
    eng = bursty_runs["affinity", "chunked"][0]
    assert eng.backends[0].engine.model is eng.backends[1].engine.model is tsys.model
    assert eng.backends[0].engine.cache is eng.backends[1].engine.cache is tsys.rows
    assert eng.backends[0].engine.pool is not eng.backends[1].engine.pool
    assert [w.role for w in eng.batcher.workers] == ["unified", "unified"]
    assert all(w.migrate is None for w in eng.batcher.workers)


def test_cluster_rejects_mismatched_placement(systems):
    _, tsys, _, _ = systems
    with pytest.raises(ValueError, match="k_instances=3"):
        ClusterEngine(tsys, ServeConfig(k=3))


PER_WORKER_KEYS = {
    "worker", "role", "requests", "mean_hit_rate", "transfer_blocks", "transfer_tokens",
    "transfer_mbytes", "transfer_seconds", "pool_peak_pages", "busy_seconds", "preempted",
    "migrations", "migrated_out", "migrated_pages", "migration_mbytes", "migration_s",
    "migration_digest_hits", "device_blocks", "spill_blocks", "spill_hits",
    "prefetch_promotions", "dequant_s", "kv_reuse"}


def test_launcher_cluster_json(capsys):
    PS.main(["--device", "cpu", "--k", "2", "--requests", "6", "--decode-steps", "2"])
    rep = json.loads(capsys.readouterr().out)
    assert rep["engine"] == "torch-cluster" and rep["k"] == 2 and rep["requests"] == 6
    assert rep["transfer_billing"] == "modeled" and "mesh" not in rep
    assert rep["policy"] == "affinity" and 0 < rep["mean_hit_rate"] <= 1
    assert [w["worker"] for w in rep["per_worker"]] == [0, 1]
    for w in rep["per_worker"]:
        assert set(w) == PER_WORKER_KEYS and w["role"] == "unified"
    assert sum(w["requests"] for w in rep["per_worker"]) == 6
    assert len(rep["per_request_ttft_s"]) == 6 and rep["decode_tokens"] == 12


def test_launcher_disagg_json(capsys):
    PS.main(["--device", "cpu", "--requests", "6", "--decode-steps", "2",
             "--long-prompt-frac", "0.3", "--config",
             "k=2,disagg.prefill_workers=1,disagg.decode_workers=1,sched=chunked,"
             "kv_reuse=on"])
    rep = json.loads(capsys.readouterr().out)
    pre, dec = rep["per_worker"]
    assert rep["disagg"] == {"prefill_workers": 1, "decode_workers": 1, "mig_gamma": 0.25}
    assert (pre["role"], dec["role"]) == ("prefill", "decode")
    assert pre["migrated_out"] > 0 and dec["migrations"] == pre["migrated_out"]
    assert dec["migration_digest_hits"] > 0 and dec["requests"] == 0


def _full_backend(model, n_pages):
    from repro_torch.serving.batch_engine import BatchEngine
    from repro_torch.serving.batching import TorchEngineBackend
    from repro_torch.serving.kv_pool import pool_for

    eng = BatchEngine(model, model.cfg, bucket=32,
                      pool=pool_for(model.cfg, page_size=8, n_pages=n_pages, device="cpu"))
    return TorchEngineBackend(eng, mode="full")


def test_backpressure_stalls_only_the_full_worker():
    """Worker 0's pool fits one request at a time, worker 1's all of its
    load: admission serializes on worker 0 only (the reference's
    `test_backpressure_stalls_only_the_full_worker`)."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.batching import ClusterBatcher, PendingRequest

    model = init_params(PS.SERVE_TINY, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(11)
    b0, b1 = _full_backend(model, 9), _full_backend(model, 128)
    reqs = [PendingRequest(arrival_s=0.0, rid=i, n_tokens=40, decode_steps=2,
                           tokens=rng.integers(1, 512, 40).astype(np.int32))
            for i in range(6)]
    done = ClusterBatcher([b0, b1], dispatch=lambda req, t, ws: req.rid % 2).run(reqs)
    by_worker = {w: sorted((c for c in done if c.worker == w), key=lambda c: c.first_token_s)
                 for w in (0, 1)}
    assert [len(v) for v in by_worker.values()] == [3, 3]
    w0, w1 = by_worker[0], by_worker[1]
    assert w1[0].first_token_s == w1[2].first_token_s       # one shared prefill batch
    assert w0[1].first_token_s >= w0[0].done_s and w0[2].first_token_s >= w0[1].done_s
    assert b0.engine.pool.stats().pages_in_use == 0 == b1.engine.pool.stats().pages_in_use


def test_least_backlog_dispatch_reads_live_backlog():
    from repro_torch.serving.batching import (DecodeEntry, PendingRequest, WorkerState,
                                              least_backlog_dispatch)

    ws = [WorkerState(None, wid=i) for i in range(3)]
    req = PendingRequest(arrival_s=1.0, rid=0, n_tokens=100)
    assert least_backlog_dispatch(req, 1.0, ws) == 0             # idle: the first
    ws[0].clock = 3.0                                            # busy 2 s past t
    ws[1]._prefill_s_per_tok = 0.01
    ws[1].waiting.append(PendingRequest(arrival_s=0.5, rid=1, n_tokens=50))
    ws[2]._decode_s_per_step = 0.2
    ws[2].decoding[2] = DecodeEntry(req, 0.1, steps_left=4)
    assert [w.backlog_seconds(1.0) for w in ws] == [2.0, 0.5, 0.8]
    assert least_backlog_dispatch(req, 1.0, ws) == 1
