"""Port parity for serving: the wave-scheduled continuous batcher over
the paged pool decodes exactly the reference's greedy tokens.

The reference runs the JAX package's `ContinuousBatcher` with jnp
attention and the gather decode (the JAX package pins gather == paged
tokens itself, `tests/test_attn_backend.py`); the port runs its own
system (the JAX init converted through numpy, its own offline cache) and
decodes through the paged-decode wrapper."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.core import engine as JENG
from repro.data import synth as JSY
from repro.serving import api as JAPI
from repro.serving.workload import rcllm_workload as jax_workload
from repro_torch.core.rcllm import make_tiny_system, tiny_config
from repro_torch.data import synth as TSY
from repro_torch.launch import serve as PS
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.api import ServeConfig
from repro_torch.serving.kv_pool import PagedKVPool, PoolExhausted
from repro_torch.serving.workload import rcllm_workload

REPO = Path(__file__).resolve().parents[1]
N_REQ, DECODE_STEPS = 8, 4
# arrivals within microseconds: every step outlasts the whole arrival
# span, so both packages form the same batches whatever their speed
QPS = 1e6


@pytest.fixture(scope="module")
def systems():
    # the launcher's rcllm system: make_tiny_system(n_items=80,
    # n_requests_hist=40, k_instances=1, n_layers=2, d_model=32)
    from repro.core.rcllm import make_tiny_system as jax_tiny
    jsys, pool_rv, prof, _ = jax_tiny(n_items=80, n_requests_hist=40, k_instances=1,
                                      n_layers=2, d_model=32)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jsys.params),
                              tiny_config(2, 32), device="cpu")
    tsys, _, _, _ = make_tiny_system(n_items=80, n_requests_hist=40, k_instances=1,
                                     n_layers=2, d_model=32, device="cpu", model=model)
    return jsys, tsys, pool_rv, prof


def _trace(SY, system, pool_rv, prof):
    return SY.make_trace(system.catalog, pool_rv, prof, N_REQ, qps=QPS,
                         n_users=max(3, N_REQ // 2), n_candidates=8,
                         reviews_per_user=1, seed=2)


def test_wave_serving_tokens_equal_reference(systems):
    jsys, tsys, pool_rv, prof = systems
    reqs_j, plans_j = jax_workload(jsys, _trace(JSY, jsys, pool_rv, prof),
                                   decode_steps=DECODE_STEPS)
    cfg_j = JAPI.ServeConfig(engine="jax", mode="rcllm", decode_steps=DECODE_STEPS)
    eng = JAPI.build_engine(jsys.params, jsys.cfg, cfg_j,
                            sel=JENG.SelectiveConfig(window=16))
    backend_j = JAPI.build_backend(eng, cfg_j, plans=plans_j)
    done_j = JAPI.build_batcher(backend_j, cfg_j).run(list(reqs_j))

    reqs_t, plans_t = rcllm_workload(tsys, _trace(TSY, tsys, pool_rv, prof),
                                     decode_steps=DECODE_STEPS)
    engine, backend, batcher, done = PS.serve(
        tsys.model, tsys.cfg, ServeConfig(decode_steps=DECODE_STEPS), reqs_t, plans_t,
        tsys.rows)
    assert len(done) == len(done_j) == N_REQ
    assert {r: backend.generated[r] for r in range(N_REQ)} == \
        {r: backend_j.generated[r] for r in range(N_REQ)}
    for r in range(N_REQ):
        np.testing.assert_array_equal(plans_t[r][0].tokens, plans_j[r][0].tokens)
        assert len(backend.generated[r]) == DECODE_STEPS
    # every request's pages went back to the pool
    assert engine.pool.free_pages == engine.pool.n_pages - 1
    assert engine.pool.peak_pages > 0


def test_pool_matches_reference_bookkeeping():
    """Slot tables, growth across pages, transactional append rollback
    and the free list behave as the reference's pool."""
    from repro.serving.kv_pool import PagedKVPool as JaxPool
    from repro.serving.kv_pool import PoolExhausted as JaxExhausted
    pools = [PagedKVPool(1, 1, 2, page_size=4, n_pages=6, device="cpu"),
             JaxPool(1, 1, 2, page_size=4, n_pages=6)]
    for p in pools:
        p.alloc(0, 7)
        p.alloc(1, 5)
        for _ in range(3):
            p.append_slots([0, 1])
    assert pools[0].slot_tables.keys() == pools[1].slot_tables.keys()
    for rid in (0, 1):
        np.testing.assert_array_equal(pools[0].slot_tables[rid], pools[1].slot_tables[rid])
        assert pools[0].seq_lens[rid] == pools[1].seq_lens[rid]
    assert pools[0].free_pages == pools[1].free_pages == 1
    for p, exc in zip(pools, (PoolExhausted, JaxExhausted)):
        for _ in range(5):
            try:
                p.append_slots([0, 1])
            except exc:
                break
    for rid in (0, 1):
        np.testing.assert_array_equal(pools[0].slot_tables[rid], pools[1].slot_tables[rid])
        assert pools[0].seq_lens[rid] == pools[1].seq_lens[rid]
    for p in pools:
        p.free(0)
        p.free(1)
        p.free(1)                       # idempotent
    assert pools[0].free_pages == pools[1].free_pages == 5


def test_alloc_mapped_matches_reference():
    from repro.serving.kv_pool import PagedKVPool as JaxPool
    pools = [PagedKVPool(1, 1, 2, page_size=4, n_pages=8, device="cpu"),
             JaxPool(1, 1, 2, page_size=4, n_pages=8)]
    for p in pools:
        p.alloc(0, 5)
        p.alloc_mapped(1, 10, np.array([2, 3, 7]), p.slot_tables[0][[0, 1, 4]],
                       extra_pages=1)
    for rid in (0, 1):
        np.testing.assert_array_equal(pools[0].slot_tables[rid], pools[1].slot_tables[rid])
        assert pools[0].page_tables[rid] == pools[1].page_tables[rid]
        assert pools[0].seq_lens[rid] == pools[1].seq_lens[rid]
    assert pools[0]._spare == pools[1]._spare
    assert pools[0].free_pages == pools[1].free_pages


def test_sampling_matches_reference():
    from repro.serving import api as JAPI
    from repro_torch.serving import api as TAPI
    logits = np.random.default_rng(0).normal(size=64)
    for params in ((0.0, 0, 0), (0.7, 0, 3), (1.3, 5, 9)):
        pj, pt = JAPI.SamplingParams(*params), TAPI.SamplingParams(*params)
        draws = [f(logits, p, np.random.default_rng(params[2]))
                 for f, p in ((JAPI.sample_token, pj), (TAPI.sample_token, pt))]
        assert draws[0] == draws[1]
    for gen, stops in (([1, 2, 3], ((2, 3),)), ([1, 2, 3], ((1, 2),)), ([], ((1,),))):
        assert TAPI.match_stop(gen, stops) == JAPI.match_stop(gen, stops)


def test_pool_writes_in_place():
    pool = PagedKVPool(2, 1, 4, page_size=4, n_pages=4, device="cpu")
    arena = pool.arena_k
    pool.alloc(3, 6)
    k = np.arange(6 * 2 * 4, dtype=np.float32).reshape(6, 2, 1, 4)
    pool.write_prompt(3, k, -k)
    pool.write_at(3, np.arange(2), k[:2, 0] + 100, k[:2, 0], layer=0)
    assert pool.arena_k is arena        # updated in place, not rebuilt
    got_k, got_v = pool.gather(3)
    want = k.copy()
    want[:2, 0] += 100
    np.testing.assert_array_equal(got_k, want)
    np.testing.assert_array_equal(got_v[:, 1], -k[:, 1])


def test_launcher_prints_reference_report_keys():
    """`python -m repro_torch.launch.serve --device cpu` prints the JAX
    launcher's engine-report keys (`repro/launch/serve.py:_engine_report`
    plus its time-between-tokens stats) with engine "torch"."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "3"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300, check=True)
    rep = json.loads(out.stdout)
    keys = {"engine", "mode", "sched", "attn_backend", "decode_kernel", "requests",
            "kv_reuse", "mesh", "decode_steps", "includes_jit_compile",
            "ttft_p50_s", "ttft_p90_s", "ttft_p99_s", "ttft_mean_s",
            "queue_wait_mean_s", "prefill_mean_s", "decode_mean_s", "per_request",
            "decode_tokens", "throughput_tok_s", "pool_peak_pages",
            "pool_peak_utilization", "tbt_p50_s", "tbt_p90_s", "tbt_p99_s",
            "tbt_samples"}
    assert keys <= set(rep)
    assert rep["engine"] == "torch" and rep["requests"] == 3
    assert rep["decode_tokens"] == 3 * 4 and rep["device"] == "cpu"


def test_serve_config_validates():
    with pytest.raises(ValueError, match="mode"):
        ServeConfig(mode="prefix")
    with pytest.raises(ValueError, match="n_pages"):
        ServeConfig(n_pages=1)
    with pytest.raises(ValueError, match="decode_steps"):
        dataclasses.replace(ServeConfig(), decode_steps=0)
