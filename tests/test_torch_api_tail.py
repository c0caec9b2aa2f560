"""Port parity for the reference API that the benchmarks and examples
call: `rcllm_batch_requests`, `ClusterReport.summary`,
`AssemblyPlan.reuse_fraction`, `SemanticCache.size_bytes`,
`flop_reduction`, `PoolStats.utilization` / `internal_fragmentation`,
`needs_refresh`, `ItemKVStore.footprint_tokens_per_replica`,
`ChunkedPrefill.pending_tokens`, `molecule_energy`, `Catalog.item_len`,
`PagedKVPool.bytes_per_token` / `can_admit` / `seq_len` and
`StoredBlock.nbytes`, each against the JAX package's on the same inputs
(numpy, from a seed; the tiny system's weights are the JAX init converted
through numpy).  Counts are equal exactly; cached KV within 1e-5 (one
forward per document), SchNet's energy within 1e-5 relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.core import engine as JENG
from repro.core import placement as JPL
from repro.data import synth as JSY
from repro.gnn import schnet as JG
from repro.kernels.selective_attention import ops as JSO
from repro.serving import batching as JBAT
from repro.serving import block_store as JBS
from repro.serving import cluster as JCL
from repro.serving import kv_pool as JKV
from repro.serving import workload as JWL
from repro_torch.configs import registry as TR
from repro_torch.core import engine as TENG
from repro_torch.core import placement as TPL
from repro_torch.core.rcllm import make_tiny_system, tiny_config
from repro_torch.data import synth as TSY
from repro_torch.gnn import schnet as TG
from repro_torch.gnn.convert import schnet_params_from_numpy
from repro_torch.kernels.selective_attention import ops as TSO
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import batching as TBAT
from repro_torch.serving import block_store as TBS
from repro_torch.serving import cluster as TCL
from repro_torch.serving import kv_pool as TKV
from repro_torch.serving import workload as TWL

KV_ATOL = 1e-5
N_RESERVE = 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch CPU thread for this module: under pytest-xdist several
    test processes share the cores, and torch's threads a process then
    oversubscribe them, which slows these CPU runs many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def systems():
    from repro.core.rcllm import make_tiny_system as jax_tiny
    jsys, pool_rv, prof, _ = jax_tiny(n_items=60, n_requests_hist=30, k_instances=2,
                                      n_layers=2, d_model=32)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jsys.params),
                              tiny_config(2, 32), device="cpu")
    tsys, _, _, _ = make_tiny_system(n_items=60, n_requests_hist=30, k_instances=2,
                                     n_layers=2, d_model=32, device="cpu", model=model)
    traces = [SY.make_trace(s.catalog, pool_rv, prof, 4, qps=2.0, n_users=3,
                            n_candidates=8, reviews_per_user=1, seed=21)
              for SY, s in ((JSY, jsys), (TSY, tsys))]
    return (jsys, tsys, JWL.rcllm_batch_requests(jsys, traces[0], n_reserve=N_RESERVE),
            TWL.rcllm_batch_requests(tsys, traces[1], n_reserve=N_RESERVE))


def test_rcllm_batch_requests_equal_the_reference(systems):
    """Same rids, prompts, plans, reservations and `have`; the port's
    block table reads the reference's cached KV out of the device pool."""
    jsys, tsys, jreqs, treqs = systems
    assert [r.rid for r in treqs] == [r.rid for r in jreqs] == list(range(4))
    for j, t in zip(jreqs, treqs):
        np.testing.assert_array_equal(t.tokens, j.tokens)
        np.testing.assert_array_equal(t.plan.source, j.plan.source)
        np.testing.assert_array_equal(t.have, j.have)
        assert t.n_reserve == j.n_reserve == N_RESERVE
        assert len(t.block_table) == len(t.positions) == t.plan.n
        rows = t.block_table.astype(np.int64)
        k = tsys.rows.k[:, rows, 0].transpose(0, 1).numpy()
        v = tsys.rows.v[:, rows, 0].transpose(0, 1).numpy()
        np.testing.assert_allclose(k, np.asarray(j.cached_k), atol=KV_ATOL)
        np.testing.assert_allclose(v, np.asarray(j.cached_v), atol=KV_ATOL)


def test_plan_and_cache_sizes_equal_the_reference(systems):
    jsys, tsys, jreqs, treqs = systems
    for j, t in zip(jreqs, treqs):
        assert t.plan.reuse_fraction() == j.plan.reuse_fraction()
        assert 0.0 < t.plan.reuse_fraction() < 1.0
    assert tsys.semantic.size_bytes() == jsys.semantic.size_bytes() > 0
    assert (tsys.item_store.footprint_tokens_per_replica()
            == jsys.item_store.footprint_tokens_per_replica() > 0)
    for i in (0, 7, tsys.catalog.n_items - 1):
        assert tsys.catalog.item_len(i) == jsys.catalog.item_len(i)


@pytest.mark.parametrize("chunk", [64, 96])
def test_chunked_pending_tokens_equal_the_reference(systems, chunk):
    jsys, tsys, jreqs, treqs = systems
    j, t = jreqs[0], treqs[0]
    sel_j, sel_t = JENG.SelectiveConfig(), TENG.SelectiveConfig()
    cj = JENG.ChunkedPrefill(jsys.params, jsys.cfg, j.plan, j.cached_k, j.cached_v, j.have,
                             sel_j, chunk_tokens=chunk, bucket=64)
    ct = TENG.ChunkedPrefill(tsys.model, tsys.cfg, t.plan, t.block_table, t.positions,
                             t.have, tsys.rows, sel_t, chunk_tokens=chunk, bucket=64)
    seen = []
    while not ct.scan_done:
        assert ct.pending_tokens() == cj.pending_tokens()
        seen.append(ct.pending_tokens())
        ct.run_chunk()
        cj.run_chunk()
    assert ct.pending_tokens() == cj.pending_tokens() == 0
    assert seen[0] == ct.n_pad and len(seen) == -(-ct.n_pad // chunk)


def _completions(mod, rng, n):
    arr = np.sort(rng.uniform(0, 5, n))
    first = arr + rng.uniform(0.01, 2.0, n)
    return [mod.Completion(rid=i, arrival_s=float(arr[i]), first_token_s=float(first[i]),
                           done_s=float(first[i] + 1.0), worker=i % 3,
                           admitted_s=float(arr[i] + 0.005)) for i in range(n)]


def _workers(mod, rng):
    return [mod.WorkerReport(worker=w, n_requests=int(rng.integers(1, 9)),
                             mean_hit_rate=float(rng.random()),
                             transfer_blocks=int(rng.integers(0, 40)),
                             transfer_tokens=int(rng.integers(0, 900)),
                             transfer_bytes=int(rng.integers(0, 10 ** 8)),
                             transfer_seconds=float(rng.random() * 1e-2),
                             pool_peak_pages=int(rng.integers(0, 100)),
                             busy_seconds=float(rng.random())) for w in range(3)]


@pytest.mark.parametrize("n", [1, 7, 40])
def test_cluster_report_summary_equals_the_reference(n):
    reports = []
    for cl, bat in ((JCL, JBAT), (TCL, TBAT)):
        rng = np.random.default_rng(n)
        comps = _completions(bat, rng, n)
        hits = {c.rid: float(h) for c, h in zip(comps, rng.random(n))}
        reports.append(cl.ClusterReport(
            completions=comps, assigned={c.rid: c.worker for c in comps}, hit_rate=hits,
            generated={c.rid: [1, 2] for c in comps}, workers=_workers(cl, rng),
            policy="affinity").summary())
    want, got = reports
    assert list(got) == list(want)
    assert got == want


def test_flop_reduction_equals_the_reference():
    rng = np.random.default_rng(5)
    for _ in range(50):
        s = int(rng.integers(1, 5000))
        r, hh, w = int(rng.integers(0, s + 1)), int(rng.integers(0, s)), int(rng.integers(0, 600))
        assert TSO.flop_reduction(r, s, hh, w) == JSO.flop_reduction(r, s, hh, w)
    assert TSO.flop_reduction(64, 512, 10, 32) == 64 * 42 / 512 ** 2


@pytest.mark.parametrize("fields", [(64, 16, 0, 0, 0), (64, 16, 10, 3, 151),
                                    (512, 8, 511, 40, 4088), (2, 1, 1, 1, 1)])
def test_pool_stats_ratios_equal_the_reference(fields):
    names = ("n_pages", "page_size", "pages_in_use", "n_requests", "tokens_resident")
    j, t = (mod.PoolStats(**dict(zip(names, fields))) for mod in (JKV, TKV))
    assert t.utilization == j.utilization
    assert t.internal_fragmentation == j.internal_fragmentation


def test_pool_sizes_and_admission_equal_the_reference():
    jp = JKV.PagedKVPool(3, 2, 8, page_size=4, n_pages=12)
    tp = TKV.PagedKVPool(3, 2, 8, page_size=4, n_pages=12, device="cpu")
    assert tp.bytes_per_token == jp.bytes_per_token == 2 * 4 * 3 * 2 * 8
    for rid, n in enumerate((5, 9, 4, 7)):
        for tokens in (1, 4, 16, 44, 45):
            assert tp.can_admit(tokens) == jp.can_admit(tokens)
        if jp.can_admit(n):
            jp.alloc(rid, n)
            tp.alloc(rid, n)
            assert tp.seq_len(rid) == jp.seq_len(rid)
    assert tp.stats().utilization == jp.stats().utilization


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
def test_stored_block_nbytes_equal_the_reference(dtype):
    rng = np.random.default_rng(3)
    jp = JKV.PagedKVPool(2, 2, 8, page_size=4, n_pages=16)
    tp = TKV.PagedKVPool(2, 2, 8, page_size=4, n_pages=16, device="cpu")
    js = JBS.SharedBlockStore(jp, kv_store_dtype=dtype)
    ts = TBS.SharedBlockStore(tp, kv_store_dtype=dtype)
    for i, t in enumerate((3, 4, 9)):
        k = rng.normal(size=(t, 2, 2, 8)).astype(np.float32)
        v = rng.normal(size=(t, 2, 2, 8)).astype(np.float32)
        key = ("item", f"b{i}")
        jb = js.insert(key, JBS.ITEM_TIER, k, v)
        tb = ts.insert(key, TBS.ITEM_TIER, torch.from_numpy(k), torch.from_numpy(v))
        assert tb.nbytes == jb.nbytes > 0


def test_needs_refresh_equals_the_reference():
    rng = np.random.default_rng(9)
    for _ in range(40):
        old = rng.random(30) * rng.integers(0, 2, 30)
        new = old + rng.random(30) * rng.choice([0.01, 0.5, 3.0])
        for thr in (0.05, 0.25, 0.6):
            assert TPL.needs_refresh(old, new, thr) == JPL.needs_refresh(old, new, thr)
    assert TPL.needs_refresh(np.zeros(4), np.ones(4))


def test_molecule_energy_equals_the_reference():
    cfg, jcfg = TR.get_config("schnet", smoke=True), JR.get_config("schnet", smoke=True)
    rng = np.random.default_rng(4)
    # the reference's parameter tree, its leaves drawn from the seed
    shapes = jax.eval_shape(lambda key: JG.init_params(key, jcfg), jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 0.3).astype(a.dtype), shapes)
    model = schnet_params_from_numpy(params, cfg, "cpu")
    n, e = 7, 16
    inputs = (rng.integers(0, 100, n).astype(np.int32),
              (rng.normal(size=(n, 3)) * 1.5).astype(np.float32),
              rng.integers(0, n, e).astype(np.int32), rng.integers(0, n, e).astype(np.int32),
              rng.random(e) < 0.8)
    want = float(jax.jit(JG.molecule_energy, static_argnums=6)(
        jax.tree_util.tree_map(jnp.asarray, params), *map(jnp.asarray, inputs), jcfg))
    got = TG.molecule_energy(model, *map(torch.from_numpy, inputs))
    assert got.shape == ()
    assert float(got) == pytest.approx(want, rel=1e-5, abs=1e-6)
    # the batched cell's energies are each molecule's
    batch = {"atom_types": inputs[0][None], "positions": inputs[1][None],
             "edge_src": inputs[2][None], "edge_dst": inputs[3][None],
             "edge_mask": inputs[4][None]}
    batched = TG.batched_energy(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(batched[0]) == pytest.approx(float(got), rel=1e-6, abs=1e-6)
