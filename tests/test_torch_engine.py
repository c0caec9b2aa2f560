"""Port parity for the RcLLM engine: the offline KV build, layer-0 Eq. 3
scoring, recompute selection, the batched selective prefill and the
full-recompute oracle, JAX package (jnp attention) vs `repro_torch` on the
JAX init converted through numpy.  fp32 throughout."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as JENG
from repro.data import synth as JSY
from repro.serving.workload import rcllm_batch_requests
from repro_torch.core import assembly as TA
from repro_torch.core import engine as TENG
from repro_torch.core.rcllm import make_tiny_system, tiny_config
from repro_torch.models.convert import params_from_numpy

KV_ATOL = 1e-5       # one forward per doc: per-layer K/V rounding
SUM_TOL = 1e-4       # Eq. 3 terms: sums of 64-512 fp32 terms of size ~1
LOGIT_ATOL = 1e-4    # logits after the whole stack: summation order
_REVIEWS: list = []  # (review pool, profile) of the module's systems


@pytest.fixture(scope="module")
def systems():
    from repro.core.rcllm import make_tiny_system as jax_tiny
    jsys, pool_rv, prof, _ = jax_tiny(n_items=60, n_requests_hist=30, k_instances=2,
                                      n_layers=2, d_model=32)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jsys.params),
                              tiny_config(2, 32), device="cpu")
    tsys, _, _, _ = make_tiny_system(n_items=60, n_requests_hist=30, k_instances=2,
                                     n_layers=2, d_model=32, device="cpu", model=model)
    _REVIEWS[:] = [pool_rv, prof]
    trace = JSY.make_trace(jsys.catalog, pool_rv, prof, 4, qps=2.0, n_users=3,
                           n_candidates=8, reviews_per_user=1, seed=21)
    return jsys, tsys, rcllm_batch_requests(jsys, trace)


def test_offline_kv_build_matches_jax(systems):
    jsys, tsys, _ = systems
    for a, b in zip(jsys.item_store.shards, tsys.item_store.shards):
        assert sorted(a.blocks) == sorted(b.blocks)
        for it in a.blocks:
            np.testing.assert_allclose(b.blocks[it].k, a.blocks[it].k, atol=KV_ATOL)
            np.testing.assert_allclose(b.blocks[it].v, a.blocks[it].v, atol=KV_ATOL)
    np.testing.assert_allclose(tsys.semantic.proto_k, jsys.semantic.proto_k, atol=KV_ATOL)
    np.testing.assert_allclose(tsys.semantic.proto_v, jsys.semantic.proto_v, atol=KV_ATOL)


def test_precompute_kv_batch_ragged_docs(systems):
    jsys, tsys, _ = systems
    rng = np.random.default_rng(0)
    docs = [rng.integers(5, 4096, n).astype(np.int32) for n in (3, 70, 64, 5, 130)]
    want = JENG.precompute_kv_batch(jsys.params, jsys.cfg, docs)
    got = TENG.precompute_kv_batch(tsys.model, tsys.cfg, docs)
    for (kj, vj), (kt, vt), d in zip(want, got, docs):
        assert kt.shape == (len(d), 2, 2, 16) and kt.dtype == np.float32
        np.testing.assert_allclose(kt, kj, atol=KV_ATOL)
        np.testing.assert_allclose(vt, vj, atol=KV_ATOL)


def _assembled(tsys, table, layers=None):
    """The port's device pool of cached rows gathered by a block table
    through the block-gather wrapper, unrotated: (n, L, Hkv, Dh) k and v."""
    t = torch.from_numpy(np.asarray(table, np.int32))
    gather = TENG.cache_gather(tsys.rows, 1e4, None, kernels=True)
    planes = [gather(t, t, l, rotate=False)
              for l in (range(tsys.cfg.n_layers) if layers is None else layers)]
    return (torch.stack([k for k, _ in planes], dim=1).numpy(),
            torch.stack([v for _, v in planes], dim=1).numpy())


def test_plans_and_cached_kv_equal(systems):
    """The port's system plans every request exactly as the reference's
    (numpy, equal) and assembles allclose cached KV (offline-build KV),
    gathered from its device pool by the plan's block table."""
    jsys, tsys, brs = systems
    from repro_torch.data import synth as TSY
    trace_t = TSY.make_trace(tsys.catalog, _REVIEWS[0], _REVIEWS[1], 4, qps=2.0,
                             n_users=3, n_candidates=8, reviews_per_user=1, seed=21)
    for br, rq in zip(brs, trace_t):
        inst = tsys.best_instance(rq)
        pt = tsys.plan_for(rq, inst)
        for f in ("tokens", "seg_kind", "source", "block_item", "block_offset",
                  "proto_id", "rope_delta"):
            np.testing.assert_array_equal(getattr(pt, f), getattr(br.plan, f), err_msg=f)
        assert (pt.n_local, pt.n_remote, pt.n_miss) == \
            (br.plan.n_local, br.plan.n_remote, br.plan.n_miss)
        table, positions, ht = tsys.cached_kv(pt, inst)
        np.testing.assert_array_equal(positions, np.arange(pt.n))
        kt, vt = _assembled(tsys, table)
        np.testing.assert_array_equal(ht, br.have)
        np.testing.assert_allclose(kt, br.cached_k, atol=KV_ATOL)
        np.testing.assert_allclose(vt, br.cached_v, atol=KV_ATOL)


def _layer0_inputs(br, n_pad_bucket=64):
    n = br.plan.n
    n_pad = -(-n // n_pad_bucket) * n_pad_bucket
    toks = JENG._pad_to(br.plan.tokens.astype(np.int32), n_pad)
    valid = np.zeros(n_pad, bool)
    valid[:n] = True
    ck0 = np.ascontiguousarray(JENG._pad_to(br.cached_k.astype(np.float32), n_pad)[:, 0])
    cv0 = np.ascontiguousarray(JENG._pad_to(br.cached_v.astype(np.float32), n_pad)[:, 0])
    return toks, valid, ck0, cv0


@pytest.mark.parametrize("i", range(4))
def test_layer0_terms_match(systems, i):
    """Same plan, same cached KV: the layer-0 pass and its Eq. 3 terms
    (attention mass, K/V divergence) allclose."""
    jsys, tsys, brs = systems
    toks, valid, ck0, cv0 = _layer0_inputs(brs[i])
    want = JENG._jit_layer0_kv(jsys.params, jnp.asarray(toks), jnp.asarray(valid),
                               jnp.asarray(ck0), jnp.asarray(cv0), jsys.cfg)
    got = TENG.layer0(tsys.model, toks, valid, ck0, cv0)
    for name, a, b, atol in zip(("x", "attn_mass", "div", "k0", "v0"), want, got,
                                (KV_ATOL, SUM_TOL, SUM_TOL, KV_ATOL, KV_ATOL)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=atol,
                                   rtol=KV_ATOL, err_msg=name)


@pytest.mark.parametrize("i", range(4))
def test_select_recompute_equal_on_same_scores(systems, i):
    """The Eq. 3 selection is a numpy copy: the same layer-0 terms give
    the same recompute mask and stats."""
    _, tsys, brs = systems
    br = brs[i]
    _, m, d, _, _ = TENG.layer0(tsys.model, *_layer0_inputs(br))
    m, d = m.numpy(), d.numpy()
    for window in (16, 32):
        rj, sj = JENG.select_recompute(br.plan, br.have, m, d,
                                       JENG.SelectiveConfig(window=window))
        rt, st = TENG.select_recompute(br.plan, br.have, m, d,
                                       TENG.SelectiveConfig(window=window))
        np.testing.assert_array_equal(rt, rj)
        assert (st.n_recomputed, st.n_heavy_hitters, st.n_reused_item,
                st.n_reused_semantic) == (sj.n_recomputed, sj.n_heavy_hitters,
                                          sj.n_reused_item, sj.n_reused_semantic)


def _own_items(tsys, brs):
    """The port's own (plan, block_table, positions, have) for the
    fixture's requests."""
    return [(br.plan, *tsys.cached_kv(br.plan, 0)) for br in brs]


def test_layer0_divergence_is_zero_for_cached_items(systems):
    """Layer-0 K/V depend on the token id alone: against the port's own
    offline cache, every cached item token's divergence is exactly 0 (the
    reference gets exact zeros the same way; noise there would be scaled
    up to O(1) by Eq. 3's normalisation)."""
    from repro_torch.core.assembly import FROM_ITEM
    _, tsys, brs = systems
    for plan, table, _, have in _own_items(tsys, brs):
        n = plan.n
        toks = JENG._pad_to(plan.tokens.astype(np.int32), -(-n // 64) * 64)
        valid = np.arange(len(toks)) < n
        ck0, cv0 = _assembled(tsys, JENG._pad_to(table, len(toks)), layers=[0])
        _, _, div, _, _ = TENG.layer0(tsys.model, toks, valid, ck0[:, 0], cv0[:, 0])
        items = (plan.source == FROM_ITEM) & have
        assert items.any()
        np.testing.assert_array_equal(div.numpy()[:n][items], 0.0)


def test_selective_prefill_batch_matches_jax(systems):
    """Each package on its own offline cache: recompute masks equal,
    logits and merged KV allclose."""
    jsys, tsys, brs = systems
    want = JENG.selective_prefill_batch(
        jsys.params, jsys.cfg, [(r.plan, r.cached_k, r.cached_v, r.have) for r in brs],
        JENG.SelectiveConfig(), bucket=64)
    got = TENG.selective_prefill_batch(tsys.model, tsys.cfg, _own_items(tsys, brs),
                                       TENG.SelectiveConfig(), tsys.rows, bucket=64)
    for (lj, sj, kj, vj), (lt, st, kt, vt) in zip(want, got):
        np.testing.assert_array_equal(st.recompute_mask, sj.recompute_mask)
        assert st.recompute_mask.any() and not st.recompute_mask.all()
        np.testing.assert_allclose(lt, np.asarray(lj), atol=LOGIT_ATOL, rtol=LOGIT_ATOL)
        np.testing.assert_allclose(kt.numpy(), kj, atol=KV_ATOL, rtol=KV_ATOL)
        np.testing.assert_allclose(vt.numpy(), vj, atol=KV_ATOL, rtol=KV_ATOL)


def test_full_prefill_logits_match_jax(systems):
    jsys, tsys, brs = systems
    for br in brs[:2]:
        want = JENG.full_prefill_logits(jsys.params, jsys.cfg, br.plan.tokens)
        got = TENG.full_prefill_logits(tsys.model, tsys.cfg, br.plan.tokens)
        np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=LOGIT_ATOL)


def test_selective_pad_rows_are_dropped(systems):
    """Padded recompute rows must not write: the merged caches at
    non-recomputed positions keep the cached values exactly (the host
    assembly of the same plan)."""
    _, tsys, brs = systems
    item, = _own_items(tsys, brs[:1])
    (_, st, k_all, v_all), = TENG.selective_prefill_batch(
        tsys.model, tsys.cfg, [item], TENG.SelectiveConfig(), tsys.rows, bucket=64)
    ck, cv, _ = TA.gather_cached_kv(item[0], tsys.item_store, tsys.semantic, 0,
                                    2, 2, 16)
    keep = ~st.recompute_mask
    np.testing.assert_array_equal(k_all.numpy()[keep, 1:], ck[keep, 1:])
    np.testing.assert_array_equal(v_all.numpy()[keep, 1:], cv[keep, 1:])
    assert torch.is_tensor(tsys.model.embed)
