"""The port's examples (`examples/torch_*.py`) run end to end on the CPU
through the kernels' plain versions, at small sizes: each `main()` with
`--device cpu` where it runs a model.  Where the reference example's
numbers are the same function of the same inputs, they are held to it:
the simulator's modelled TTFTs (numpy, both packages on the H100's
rates) exactly, and the quickstart, on the reference quickstart's weights,
to its routed instance, plan, recompute set and rankings, with scores
within 1e-4.  The ranker example is checked for its shape and ranges
only: its training functions are held to the reference's in
`tests/test_torch_ranker.py`, and the reference example's own run costs
~26 s of CPU."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
SCORE_TOL = 1e-4     # fp32 scores after the whole stack: summation order


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch CPU thread for this module: under pytest-xdist several
    test processes share the cores, and torch's threads a process then
    oversubscribe them, which slows these CPU runs many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_quickstart():
    """`examples/quickstart.py`'s steps on the reference package (its
    `main` prints and returns nothing).  -> (system, routed instance,
    plan, rcllm scores and stats, full scores, NDCG@5)."""
    from repro.core.engine import SelectiveConfig
    from repro.core.metrics import ranking_agreement_ndcg
    from repro.core.rcllm import make_tiny_system
    from repro.data import synth as SY

    system, pool, prof, _ = make_tiny_system(n_items=120, n_requests_hist=60, k_instances=4)
    req = SY.make_trace(system.catalog, pool, prof, 1, qps=1.0, n_users=3,
                        n_candidates=8, reviews_per_user=2, seed=7)[0]
    inst = system.best_instance(req)
    plan = system.plan_for(req, inst)
    sel = SelectiveConfig(r_item=0.3, r_rev=0.3, window=16)
    scores, stats = system.rank(req, "rcllm", sel)
    full, _ = system.rank(req, "full")
    return system, inst, plan, scores, stats, full, ranking_agreement_ndcg(full, scores, k=5)


def test_quickstart_runs_on_the_cpu(capsys):
    """The port's quickstart on the reference quickstart's weights
    (converted through numpy): the same routed instance, plan, recompute
    set and rankings, scores within SCORE_TOL."""
    import jax
    from repro_torch.core.rcllm import tiny_config
    from repro_torch.models.convert import params_from_numpy

    jsys, inst, plan, scores, stats, full, ndcg = _reference_quickstart()
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jsys.params), tiny_config(),
                              device="cpu")
    out = _load("torch_quickstart").main(["--device", "cpu"], model=model)
    text = capsys.readouterr().out
    assert "fidelity NDCG@5" in text and "device              : cpu" in text
    assert f"routed to instance  : {inst}" in text
    got = out["plan"]
    assert (got.n, got.n_local, got.n_remote, got.n_miss) == (plan.n, plan.n_local,
                                                              plan.n_remote, plan.n_miss)
    assert got.reuse_fraction() == plan.reuse_fraction()
    assert (out["stats"].n_recomputed, out["stats"].n_tokens,
            out["stats"].n_heavy_hitters) == (stats.n_recomputed, stats.n_tokens,
                                              stats.n_heavy_hitters)
    np.testing.assert_allclose(out["scores"], scores, atol=SCORE_TOL, rtol=SCORE_TOL)
    np.testing.assert_allclose(out["full"], full, atol=SCORE_TOL, rtol=SCORE_TOL)
    assert np.argsort(-out["scores"]).tolist() == np.argsort(-np.asarray(scores)).tolist()
    assert np.argsort(-out["full"]).tolist() == np.argsort(-np.asarray(full)).tolist()
    assert out["ndcg5"] == pytest.approx(ndcg, abs=1e-12)


def test_serve_cluster_equals_the_simulator_on_h100_rates(capsys):
    from repro.configs import registry as JR
    from repro.core import cost_model as JCM
    from repro.core import simulator as JSIM
    import dataclasses
    from repro_torch.core import cost_model as CM

    out = _load("torch_serve_cluster").main(["--k", "4", "--requests", "120"])
    text = capsys.readouterr().out
    assert "modelled" in text and "H100" in text
    hw = JCM.Hardware(**dataclasses.asdict(CM.H100_SXM))
    reqs, placement, _ = JSIM.make_sim_setup(k=4, n_requests=120, qps=12.0, n_items=8000,
                                             seed=1)
    for mode in ("full", "prefix", "rcllm"):
        want = JSIM.simulate(JR.ARCHS["rcllm-qwen3-8b"], hw, reqs, placement,
                             JSIM.SimConfig(mode=mode)).summary()
        assert out[mode] == pytest.approx(want, rel=1e-12)
    assert out["full"]["p50"] > out["rcllm"]["p50"]


def test_train_ranker_runs_on_the_cpu(capsys):
    out = _load("torch_train_ranker").main(["--device", "cpu", "--steps", "3",
                                            "--eval", "3"])
    text = capsys.readouterr().out
    assert "Table III" in text
    assert [s for s, _ in out["history"]] == [0, 2]
    assert all(np.isfinite(l) for _, l in out["history"])
    assert set(out["table"]) == {"full", "rcllm", "cacheblend", "epic"}
    for row in out["table"].values():
        assert 0.0 <= row["hr1"] <= row["hr3"] <= row["hr5"] <= 1.0

