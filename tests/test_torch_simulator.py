"""Port parity for the analytic cluster simulator (`core/simulator.py`)
and its serving seams (`batching.SimBackend`, ``ServeConfig(engine="sim",
mode="prefix")``, `launch/serve.py --engine sim`).

Both packages get the same `Hardware` values: the reference's default is
a TPU's, so the reference is built with the port's `H100_SXM` fields.
Inputs are numpy (no model runs), so the summaries must agree to float
rounding; the reference's orderings test is repeated on the port's rates.
"""
import dataclasses
import json

import numpy as np
import pytest

from repro.configs import registry as JREG
from repro.core import cost_model as JCM
from repro.core import placement as JPL
from repro.core import simulator as JSIM
from repro.serving.batching import ContinuousBatcher as JBatcher
from repro.serving.batching import PendingRequest as JPending
from repro_torch.configs.rcllm_qwen3_8b import CONFIG as QWEN3_8B
from repro_torch.core import cost_model as CM
from repro_torch.core import placement as PL
from repro_torch.core import simulator as SIM
from repro_torch.launch import serve as PS
from repro_torch.serving import api as API
from repro_torch.serving.batching import (ContinuousBatcher, PendingRequest, SimBackend,
                                          WorkerState)

JHW = JCM.Hardware(**dataclasses.asdict(CM.H100_SXM))
SETUP = dict(k=4, n_requests=300, qps=12.0, n_items=2000, seed=5)


@pytest.fixture(scope="module")
def setups():
    return SIM.make_sim_setup(**SETUP), JSIM.make_sim_setup(**SETUP)


def test_config_fields_equal_reference():
    jcfg = JREG.ARCHS["rcllm-qwen3-8b"]
    for f in dataclasses.fields(QWEN3_8B):
        # the serving execution knobs name each package's own routes
        if hasattr(jcfg, f.name) and f.name not in ("attn_backend", "decode_kernel"):
            assert getattr(QWEN3_8B, f.name) == getattr(jcfg, f.name), f.name
    assert QWEN3_8B.param_count() == jcfg.active_param_count()


def test_sim_setup_equals_reference(setups):
    (reqs, placement, _), (jreqs, jplacement, _) = setups
    np.testing.assert_array_equal(placement.shard_of, jplacement.shard_of)
    np.testing.assert_array_equal(placement.hot_items, jplacement.hot_items)
    assert len(reqs) == len(jreqs) == SETUP["n_requests"]
    for a, b in zip(reqs, jreqs):
        for f in dataclasses.fields(a):
            np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name))


def test_random_placement_equals_reference():
    pop = np.random.default_rng(3).random(500)
    got, want = PL.random_placement(500, pop, 6, seed=11), JPL.random_placement(500, pop, 6,
                                                                                seed=11)
    np.testing.assert_array_equal(got.shard_of, want.shard_of)
    np.testing.assert_array_equal(got.hot_items, want.hot_items)
    np.testing.assert_allclose(got.balance, want.balance, rtol=1e-12)


@pytest.mark.parametrize("mode", ["rcllm", "full", "prefix"])
@pytest.mark.parametrize("case", ["affinity", "round_robin", "fault_hedge_straggler",
                                  "remote_fetch"])
def test_summary_equals_reference(setups, mode, case):
    (reqs, placement, _), (jreqs, jplacement, _) = setups
    kw, jkw, sim = {}, {}, dict(mode=mode)
    if case == "round_robin":
        sim["policy"] = "round_robin"
    elif case == "remote_fetch":
        sim["remote_fetch"] = True
    elif case == "fault_hedge_straggler":
        slow = np.ones(placement.k)
        slow[1] = 8.0
        sim["hedge_ms"] = 5.0
        kw = dict(straggler_factors=slow, faults=[SIM.NodeFault(0, 0.0, 3.0)])
        jkw = dict(straggler_factors=slow, faults=[JSIM.NodeFault(0, 0.0, 3.0)])
    got = SIM.simulate(QWEN3_8B, CM.H100_SXM, reqs, placement, SIM.SimConfig(**sim), **kw)
    want = JSIM.simulate(JREG.ARCHS["rcllm-qwen3-8b"], JHW, jreqs, jplacement,
                         JSIM.SimConfig(**sim), **jkw)
    s, w = got.summary(), want.summary()
    assert s.keys() == w.keys()
    for key in s:
        assert s[key] == pytest.approx(w[key], rel=1e-6, abs=1e-12), key
    np.testing.assert_array_equal(got.per_instance_load, want.per_instance_load)
    np.testing.assert_allclose(got.ttft_s, want.ttft_s, rtol=1e-6)


def test_simulator_orderings_and_faults(setups):
    """The reference's `test_simulator_orderings_and_faults` on the port's
    H100 rates: RcLLM beats prefix caching beats full recompute at p50; a
    node fault still serves every request, no faster; hedging a straggler
    does not hurt p99 by more than 5%."""
    reqs, placement, _ = setups[0]
    res = {m: SIM.simulate(QWEN3_8B, CM.H100_SXM, reqs, placement,
                           SIM.SimConfig(mode=m, policy="affinity"))
           for m in ("rcllm", "prefix", "full")}
    assert res["rcllm"].pct(50) < res["prefix"].pct(50) < res["full"].pct(50)
    faults = [SIM.NodeFault(instance=0, t_fail_s=0.0, t_repair_s=0.3)]
    resf = SIM.simulate(QWEN3_8B, CM.H100_SXM, reqs, placement, SIM.SimConfig(mode="rcllm"),
                        faults=faults)
    assert resf.n_requests == len(reqs)
    assert resf.pct(50) >= res["rcllm"].pct(50) * 0.99
    slow = np.ones(placement.k)
    slow[1] = 8.0
    r_noh = SIM.simulate(QWEN3_8B, CM.H100_SXM, reqs, placement, SIM.SimConfig(mode="rcllm"),
                         straggler_factors=slow)
    r_h = SIM.simulate(QWEN3_8B, CM.H100_SXM, reqs, placement,
                       SIM.SimConfig(mode="rcllm", hedge_ms=5.0), straggler_factors=slow)
    assert r_h.pct(99) <= r_noh.pct(99) * 1.05


def test_sim_backend_batching_equals_reference():
    """The wave loop over the analytic clock: completions (times, order,
    reasons) equal the reference's `ContinuousBatcher` over its
    `SimBackend`, including backlog and a token budget that splits waves."""
    prefill = lambda n: CM.full_prefill_ttft_s(QWEN3_8B, CM.H100_SXM, n)
    decode = lambda b: CM.decode_step_time_s(QWEN3_8B, CM.H100_SXM, b)
    rng = np.random.default_rng(4)
    arrivals = np.cumsum(rng.exponential(0.02, 40))
    sizes = rng.integers(200, 3000, 40)
    steps = rng.integers(1, 6, 40)
    got = ContinuousBatcher(SimBackend(prefill, decode), max_batch_tokens=6000,
                            max_decode_batch=8).run(
        [PendingRequest(float(a), i, int(n), int(d))
         for i, (a, n, d) in enumerate(zip(arrivals, sizes, steps))])
    want = JBatcher(prefill, decode, max_batch_tokens=6000, max_decode_batch=8).run(
        [JPending(float(a), i, int(n), int(d))
         for i, (a, n, d) in enumerate(zip(arrivals, sizes, steps))])
    assert len(got) == len(want) == 40
    for g, w in zip(got, want):
        assert (g.rid, g.reason, g.worker) == (w.rid, w.reason, w.worker)
        assert (g.arrival_s, g.first_token_s, g.done_s, g.admitted_s) == \
            (w.arrival_s, w.first_token_s, w.done_s, w.admitted_s)
    with pytest.raises(ValueError, match="chunk-capable"):
        WorkerState(SimBackend(prefill, decode), sched="chunked")


def test_serveconfig_sim_and_prefix_rejections():
    """The reference's validation of the simulator's knobs
    (`repro/serving/api.py`), on the port's engine names."""
    assert API.ServeConfig(engine="sim", k=40, mode="prefix").engine == "sim"
    for bad, match in ((dict(engine="sim", kv_reuse=True), "kv_reuse"),
                       (dict(engine="sim", sched="chunked"), "wave-only"),
                       (dict(mode="prefix"), "simulator-only"),
                       (dict(engine="sim", k=2, disagg=API.DisaggConfig(1, 1)),
                        "KV to migrate"),
                       (dict(engine="sim", store=API.StoreConfig(spill_mb=8)),
                        "no block store")):
        with pytest.raises(ValueError, match=match):
            API.ServeConfig(**bad)


def test_launcher_engine_sim(capsys):
    """`launch/serve.py --engine sim`: the simulator's summary on the
    H100's rates, for each mode; no model is built."""
    argv = ["--engine", "sim", "--k", "4", "--model", "rcllm-qwen3-8b", "--requests", "120",
            "--qps", "10"]
    out = {}
    for mode in ("rcllm", "prefix", "full"):
        PS.main(argv + ["--mode", mode])
        out[mode] = json.loads(capsys.readouterr().out)
        assert out[mode]["engine"] == "sim" and out[mode]["hardware"] == "H100_SXM"
    assert out["rcllm"]["p50"] < out["prefix"]["p50"] < out["full"]["p50"]
    reqs, placement, _ = SIM.make_sim_setup(k=4, n_requests=120, qps=10.0, n_items=8000,
                                            seed=1)
    want = SIM.simulate(QWEN3_8B, CM.H100_SXM, reqs, placement, SIM.SimConfig()).summary()
    assert {k: out["rcllm"][k] for k in want} == want
    with pytest.raises(SystemExit, match="engine=torch"):
        PS.main(argv + ["--server"])
    with pytest.raises(SystemExit, match="simulator-only"):
        PS.main(["--mode", "prefix", "--device", "cpu"])
