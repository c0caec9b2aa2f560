"""Port parity for the ranking-accuracy path: `core/metrics.py`,
`core/baselines.py` (CacheBlend, EPIC), `RcLLMSystem.rank` and the NDCG
fidelity protocol of `benchmarks/bench_accuracy.py` (8 requests of 10
candidates over 12 users, 2 reviews each, seed 99; r = 0.3, window 16),
against the JAX package on the same weights (its init converted through
numpy, each package its own offline caches).

Scores are held to the reference's within `LOGIT_TOL`.  CacheBlend ranks
cached tokens purely by their layer-0 deviation, which is exactly 0 for
every cached item token in both packages: its selection breaks those
ties by numpy's unstable argsort, so masks are held equal on the SAME
deviation array, and end to end only scores and fidelity are compared.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import baselines as JBASE
from repro.core import metrics as JMET
from repro.core.engine import SelectiveConfig as JSel
from repro.data import synth as JSY
from repro.serving import block_store as JBS
from repro_torch.core import baselines as BASE
from repro_torch.core import metrics as MET
from repro_torch.core.engine import SelectiveConfig
from repro_torch.core.rcllm import make_tiny_system, tiny_config
from repro_torch.data import synth as SY
from repro_torch.kernels.block_gather import ops as BO
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import block_store as BS

LOGIT_TOL = 1e-4       # fp32 on both sides: summation order only
FIDELITY_TOL = 0.02    # the reference's int8 fidelity gate, reused for parity
METHODS = ("full", "rcllm", "cacheblend", "epic")
SEL = dict(r_item=0.3, r_rev=0.3, window=16)


@pytest.fixture(scope="module")
def systems():
    # `bench_accuracy.py --quick`'s system: make_tiny_system(n_items=100,
    # n_requests_hist=60, k_instances=4), 4 layers, d_model 64
    from repro.core.rcllm import make_tiny_system as jax_tiny
    jsys, pool, prof, _ = jax_tiny(n_items=100, n_requests_hist=60, k_instances=4)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jsys.params),
                              tiny_config(), device="cpu")
    tsys, _, _, _ = make_tiny_system(n_items=100, n_requests_hist=60, k_instances=4,
                                     device="cpu", model=model)
    trace = dict(n_requests=8, qps=5.0, n_users=12, n_candidates=10, reviews_per_user=2,
                 seed=99)
    reqs_j = JSY.make_trace(jsys.catalog, pool, prof, **trace)
    reqs_t = SY.make_trace(tsys.catalog, pool, prof, **trace)
    return jsys, tsys, reqs_j, reqs_t


@pytest.fixture(scope="module")
def scores(systems):
    """method -> (reference scores, port scores, port stats) per request."""
    jsys, tsys, reqs_j, reqs_t = systems
    out = {}
    for m in METHODS:
        out[m] = [(jsys.rank(rj, m, JSel(**SEL))[0], *tsys.rank(rt, m, SelectiveConfig(**SEL)))
                  for rj, rt in zip(reqs_j, reqs_t)]
    return out


def _fidelity(scores, method):
    return float(np.mean([MET.ranking_agreement_ndcg(f[1], s[1], k=10)
                          for f, s in zip(scores["full"], scores[method])]))


# ------------------------------------------------------------- metrics
def test_metrics_equal_reference():
    rng = np.random.default_rng(0)
    for n in (1, 5, 10, 37):
        gold = rng.integers(0, n, 64)
        assert MET.table_iii_metrics(gold) == JMET.table_iii_metrics(gold)
        for _ in range(8):
            a, b = rng.normal(size=n), rng.normal(size=n)
            b[: n // 3] = a[: n // 3]                   # some shared order
            np.testing.assert_array_equal(MET.ranks_from_scores(a),
                                          JMET.ranks_from_scores(a))
            for k in (1, 5, 10):
                assert MET.ranking_agreement_ndcg(a, b, k) == \
                    JMET.ranking_agreement_ndcg(a, b, k)
    a = rng.normal(size=10)
    assert MET.ranking_agreement_ndcg(a, a) == pytest.approx(1.0)
    assert MET.ranking_agreement_ndcg(a, -a) < 1.0


# ------------------------------------------------------- baseline masks
def test_baseline_masks_equal_reference_on_the_same_deviation(systems, monkeypatch):
    """CacheBlend's and EPIC's recompute sets equal the reference's, given
    the port's own layer-0 deviation on both sides (the reference's layer 0
    and selective layers stubbed out to read its mask)."""
    jsys, tsys, reqs_j, reqs_t = systems
    seen = {}
    monkeypatch.setattr(JBASE, "_layer0",
                        lambda params, cfg, plan, ck, cv: (None, seen["dev"], ck, cv))

    def capture(params, cfg, x, recompute, ckp, cvp, n, key_positions=None):
        seen["mask"], seen["pos"] = recompute.copy(), key_positions
        return np.zeros(cfg.vocab_size, np.float32)

    monkeypatch.setattr(JBASE, "run_selective_layers", capture)
    n_tied = 0
    for rj, rt in zip(reqs_j, reqs_t):
        inst = tsys.best_instance(rt)
        plan = tsys.plan_for(rt, inst)
        table, _, have = tsys.cached_kv(plan, inst)
        _, dev = BASE._layer0(tsys.model, tsys.cfg, plan, table, tsys.rows)
        seen["dev"] = dev
        jplan = jsys.plan_for(rj, jsys.best_instance(rj))
        np.testing.assert_array_equal(jplan.tokens, plan.tokens)
        ck, cv, jhave = jsys.cached_kv(jplan, jsys.best_instance(rj))
        np.testing.assert_array_equal(jhave, have)
        for r in (0.1, 0.3):
            JBASE.cacheblend_prefill_logits(jsys.params, jsys.cfg, jplan, ck, cv, jhave, r=r)
            mine = BASE.cacheblend_recompute(plan, have, dev * have.astype(np.float32), r)
            np.testing.assert_array_equal(mine, seen["mask"])
        original = np.arange(plan.n) - plan.rope_delta
        np.testing.assert_array_equal(seen["pos"], original)
        n_tied += int(((dev == 0) & have).sum())
        for k_link in (1, 2, 3):
            JBASE.epic_prefill_logits(jsys.params, jsys.cfg, jplan, ck, cv, jhave,
                                      k_link=k_link)
            np.testing.assert_array_equal(BASE.epic_recompute(plan, have, k_link),
                                          seen["mask"])
    assert n_tied > 0      # exact-zero deviations (cached items) were there to tie


# ---------------------------------------------------------- rank / NDCG
@pytest.mark.parametrize("method", METHODS)
def test_rank_scores_match_reference(scores, method):
    for want, got, stats in scores[method]:
        assert got.shape == want.shape == (10,)
        np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)
        if method == "full":
            assert stats is None
        else:
            assert 0.0 < stats.recompute_fraction() < 1.0


def test_cacheblend_rotates_to_original_positions(systems, monkeypatch):
    """CacheBlend's selective layers gather the cached keys at their
    original positions (request position minus the RoPE delta), which
    differ from the request positions wherever a block was realigned: one
    rotated gather of layers 1..L-1 per selective pass."""
    _, tsys, _, reqs_t = systems
    calls = []
    # on the CPU the engine binds the block gather's plain version
    # (`PlainGather`, the plain attention backend), which every binding's
    # CPU call goes through
    call = BO.PlainGather.__call__

    def tap(self, table, positions=None, layers=0, **kw):
        if kw.get("rotate", True):
            calls.append((layers, positions.clone()))
        return call(self, table, positions, layers, **kw)

    monkeypatch.setattr(BO.PlainGather, "__call__", tap)
    rt = reqs_t[0]
    tsys.rank(rt, "cacheblend", SelectiveConfig(**SEL))
    plan = tsys.plan_for(rt, tsys.best_instance(rt))
    assert [layers for layers, _ in calls] == [range(1, tsys.cfg.n_layers)]
    want = np.arange(plan.n) - plan.rope_delta
    assert (want != np.arange(plan.n)).sum() > 0
    for _, pos in calls:
        np.testing.assert_array_equal(pos.numpy()[:plan.n], want)
    calls.clear()
    tsys.rank(rt, "epic", SelectiveConfig(**SEL))
    assert calls
    for _, pos in calls:
        np.testing.assert_array_equal(pos.numpy()[:plan.n], np.arange(plan.n))


def test_full_equals_rcllm_at_r1(systems):
    """r = 1 with a window over the whole prompt recomputes every token:
    the selective scores are the full forward's."""
    _, tsys, _, reqs_t = systems
    rt = reqs_t[0]
    tokens, _, _ = rt.prompt_segments(tsys.catalog, tsys.instruction)
    full, none = tsys.rank(rt, "full")
    sc, stats = tsys.rank(rt, "rcllm", SelectiveConfig(r_item=1.0, r_rev=1.0,
                                                       window=len(tokens)))
    assert none is None and stats.recompute_fraction() == 1.0
    np.testing.assert_allclose(sc, full, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    with pytest.raises(ValueError, match="unknown ranking method"):
        tsys.rank(rt, "oracle")


def test_fidelity_matches_reference(scores):
    """Mean NDCG@10 against Full-Recompute, per method, within 0.02 of the
    reference's under the same protocol."""
    for m in ("rcllm", "cacheblend", "epic"):
        want = float(np.mean([JMET.ranking_agreement_ndcg(f[0], s[0], k=10)
                              for f, s in zip(scores["full"], scores[m])]))
        got = _fidelity(scores, m)
        assert 0.0 < got <= 1.0
        assert abs(got - want) <= FIDELITY_TOL, (m, got, want)


def test_int8_store_fidelity_gate(systems, scores):
    """The int8 store's fidelity gate (the reference's tiered-store
    benchmark): rcllm's NDCG@10 against Full-Recompute drops by at most
    0.02 when every cached row goes through the store's int8 codec, and
    the port's int8 scores stay within the reference's int8 scores."""
    jsys, tsys, reqs_j, reqs_t = systems
    q = dataclasses.replace(tsys, rows=BS.int8_roundtrip_rows(tsys.rows))
    assert torch.equal(q.rows.k[:, 0], torch.zeros_like(q.rows.k[:, 0]))
    assert not torch.equal(q.rows.k, tsys.rows.k)
    sel = SelectiveConfig(**SEL)
    int8 = [q.rank(rt, "rcllm", sel)[0] for rt in reqs_t]
    fid8 = float(np.mean([MET.ranking_agreement_ndcg(f[1], s, k=10)
                          for f, s in zip(scores["full"], int8)]))
    assert _fidelity(scores, "rcllm") - fid8 <= FIDELITY_TOL
    # the reference's round trip of its offline caches, in place (restored)
    rt8 = lambda a: JBS.dequantize_rows(*JBS.quantize_rows(a))
    blocks = [b for s in jsys.item_store.shards for b in s.blocks.values()]
    saved = [(b.k, b.v) for b in blocks], (jsys.semantic.proto_k, jsys.semantic.proto_v)
    try:
        for b in blocks:
            b.k, b.v = rt8(b.k), rt8(b.v)
        jsys.semantic.proto_k = rt8(jsys.semantic.proto_k)
        jsys.semantic.proto_v = rt8(jsys.semantic.proto_v)
        for rj, got in zip(reqs_j, int8):
            np.testing.assert_allclose(got, jsys.rank(rj, "rcllm", JSel(**SEL))[0],
                                       atol=LOGIT_TOL, rtol=LOGIT_TOL)
    finally:
        for b, (k, v) in zip(blocks, saved[0]):
            b.k, b.v = k, v
        jsys.semantic.proto_k, jsys.semantic.proto_v = saved[1]


def test_int8_roundtrip_rows_is_the_store_codec(systems):
    """Each cached row's int8 round trip equals the store's codec applied to
    that row alone (per layer, kv head and row), and is idempotent."""
    _, tsys, _, _ = systems
    rows = tsys.rows
    q = BS.int8_roundtrip_rows(rows)
    sel = torch.tensor([1, 7, rows.n_rows - 1])
    for pool, got in ((rows.k, q.k), (rows.v, q.v)):
        one = pool.index_select(1, sel).permute(1, 0, 2, 3, 4)[:, :, 0]   # (t, L, H, D)
        want = BS.dequantize_rows(*BS.quantize_rows(one))
        torch.testing.assert_close(got.index_select(1, sel).permute(1, 0, 2, 3, 4)[:, :, 0],
                                   want, atol=0, rtol=0)
    again = BS.int8_roundtrip_rows(q)
    assert torch.equal(again.k, q.k) and torch.equal(again.v, q.v)
