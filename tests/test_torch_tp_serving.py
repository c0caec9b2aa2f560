"""Tensor-parallel RcLLM serving of the port, held against the reference's
UNSHARDED engine (the invariant of the reference's `tests/test_mesh.py`,
whose sharded cases need eight host devices and skip here): the
reference's tiny system (4 query / 4 kv heads) and a six-request trace,
served by gloo ranks on the CPU at tp = 2 and 4, and in this process on
an explicit (1, 1) mesh.

* tokens at every tp x {wave, chunked} x reuse {off, on} equal the JAX
  engine's, and tp = 1 is bitwise the port's unsharded path;
* tp = 2's (and 4's) full-prefill logits lie within 1e-5 of the JAX
  engine's (the all-reduces reorder fp32 sums, so bitwise equality is
  not expected);
* the ranks agree, by digest, on every step's plan, every dispatch and
  every Eq. 3 recompute mask (the mesh's check, on here);
* each rank's arena is (n_pages, page_size, L, Hkv / tp, Dh), every page
  is back after the run and `check_partition` holds on every rank;
* int8 store payloads are quantized per (row, layer, kv head), so a
  rank's payload of its heads' rows is the head slice of the unsharded
  payload, bitwise;
* a k = 2 cluster at tp = 2 decodes the JAX cluster's tokens, billing
  measured copies.

The ranks of one tp start once, in a module fixture (`launch.mesh.
spawn_ranks`), each with one torch thread; JAX runs only in this
process."""
import jax
import numpy as np
import pytest
import torch

from repro_torch.core import engine as TENG
from repro_torch.core.rcllm import make_tiny_system, tiny_config
from repro_torch.data import synth as TSY
from repro_torch.launch import mesh as TMESH
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import api as API
from repro_torch.serving import block_store as BS
from repro_torch.serving.api import MeshConfig, ServeConfig
from repro_torch.serving.cluster import ClusterEngine
from repro_torch.serving.kv_pool import pool_for
from repro_torch.serving.workload import rcllm_reuse_info, rcllm_workload
from repro_torch.sharding import ctx as CTX

RUNS = [(sched, reuse) for sched in ("wave", "chunked") for reuse in (False, True)]
LOGIT_TOL = 1e-5
PREFILL_TOKENS = np.arange(1, 33, dtype=np.int64)[None]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_system(model, mesh=None):
    """The port's tiny system on `model` (the reference's tiny weights),
    this rank's shard of it under `mesh`, and the six-request trace."""
    system, pool_rv, prof, _ = make_tiny_system(
        n_items=40, n_requests_hist=25, k_instances=2, n_layers=2, d_model=32, n_heads=4,
        n_kv_heads=4, device="cpu", model=model, mesh=mesh)
    trace = TSY.make_trace(system.catalog, pool_rv, prof, 6, qps=50.0, n_users=3,
                           n_candidates=6, reviews_per_user=1, seed=3)
    return system, trace


def _serve(system, trace, config):
    """The trace through the port's batching stack.  -> (tokens, engine)."""
    reqs, plans = rcllm_workload(system, trace, decode_steps=config.decode_steps)
    reuse = rcllm_reuse_info(system, trace, plans) if config.kv_reuse else None
    engine = API.build_engine(system.model, system.cfg, config, cache=system.rows)
    backend = API.build_backend(engine, config, plans=plans, reuse=reuse)
    API.build_batcher(backend, config).run(reqs)
    return ({int(r): [int(t) for t in ts] for r, ts in backend.generated.items()}, engine)


def _int8_payloads(pool, rows, heads):
    """The int8 payload (data, scales) an int8 store over `pool` holds for
    each of `rows` ({key: (k, v) fp32 numpy, all heads}) cut to `heads`."""
    store = BS.SharedBlockStore(pool, kv_store_dtype="int8")
    out = {}
    for key, (k, v) in rows.items():
        blk = store.insert(key, BS.ITEM_TIER, torch.from_numpy(k[:, :, heads]),
                           torch.from_numpy(v[:, :, heads]))
        out[key] = tuple(t.numpy().copy() for t in (blk.data_k, blk.scale_k,
                                                   blk.data_v, blk.scale_v))
    return out


def _rank_job(rank, world, backend, device, tree, item_rows, tp):
    """One rank: its shard of the system, the four serving runs and the
    cluster run on a (1, tp) mesh with the check on, its prefill logits,
    and its int8 payloads of `item_rows`."""
    torch.set_num_threads(1)
    cfg = tiny_config(2, 32, 4, 4)
    mesh_cfg = MeshConfig(tp=tp)
    mesh = mesh_cfg.build()
    mesh.check = True
    system, trace = _port_system(params_from_numpy(tree, cfg, device="cpu"), mesh)
    out = {"rank": rank, "backend": backend, "runs": {}}
    with CTX.axes(mesh):
        for sched, reuse in RUNS:
            mesh.log = []
            tokens, engine = _serve(system, trace, ServeConfig(
                sched=sched, kv_reuse=reuse, decode_steps=2, mesh=mesh_cfg))
            BS.check_partition(engine.pool, engine.store)
            out["runs"][sched, reuse] = {
                "tokens": tokens, "log": list(mesh.log),
                "arena": tuple(engine.pool.arena_k.shape),
                "page_tables": dict(engine.pool.page_tables)}
        out["logits"] = TENG.batched_prefill(system.model, PREFILL_TOKENS, np.array([31]),
                                             kernels=False)[0]
        mesh.log = []
        cluster = ClusterEngine(system, ServeConfig(k=2, decode_steps=2, mesh=mesh_cfg))
        rep = cluster.run(trace, decode_steps=2)
        out["cluster"] = {
            "tokens": {int(r): [int(t) for t in ts] for r, ts in rep.generated.items()},
            "log": list(mesh.log), "devices": cluster.worker_devices,
            "copies": cluster.transfer_copies,
            "billed": sum(b.transfer_seconds for b in cluster.backends),
            "measured": sum(b.shard.measured_seconds() for b in cluster.backends)}
        hk = cfg.n_kv_heads // tp
        out["int8"] = _int8_payloads(pool_for(cfg, n_pages=64, device="cpu", mesh=mesh),
                                     item_rows, slice(rank * hk, (rank + 1) * hk))
    return out


# ------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def reference():
    """The reference's tiny system and trace through its UNSHARDED engine:
    tokens of the four runs and of a k = 2 cluster, and full-prefill
    logits; with its weights as numpy."""
    from repro.core import engine as JENG
    from repro.core.rcllm import make_tiny_system as jax_tiny
    from repro.data import synth as JSY
    from repro.serving import api as JAPI
    from repro.serving.cluster import ClusterEngine as JCluster
    from repro.serving.workload import rcllm_reuse_info as j_reuse
    from repro.serving.workload import rcllm_workload as j_workload

    jsys, pool_rv, prof, _ = jax_tiny(n_items=40, n_requests_hist=25, k_instances=2,
                                      n_layers=2, d_model=32, n_heads=4, n_kv_heads=4)
    trace = JSY.make_trace(jsys.catalog, pool_rv, prof, 6, qps=50.0, n_users=3,
                           n_candidates=6, reviews_per_user=1, seed=3)
    tokens = {}
    for sched, reuse in RUNS:
        config = JAPI.ServeConfig(engine="jax", sched=sched, kv_reuse=reuse, decode_steps=2)
        reqs, plans = j_workload(jsys, trace, decode_steps=2)
        engine = JAPI.build_engine(jsys.params, jsys.cfg, config)
        backend = JAPI.build_backend(engine, config, plans=plans,
                                     reuse=j_reuse(jsys, trace, plans) if reuse else None)
        JAPI.build_batcher(backend, config).run(reqs)
        tokens[sched, reuse] = {int(r): [int(t) for t in ts]
                                for r, ts in backend.generated.items()}
    rep = JCluster(jsys, JAPI.ServeConfig(engine="jax", k=2, decode_steps=2)).run(
        trace, decode_steps=2)
    cluster = {int(r): [int(t) for t in ts] for r, ts in rep.generated.items()}
    logits = np.asarray(JENG._jit_batched_prefill(
        jsys.params, PREFILL_TOKENS.astype(np.int32), np.asarray([31], np.int32),
        jsys.cfg)[0])
    return jax.tree_util.tree_map(np.asarray, jsys.params), tokens, cluster, logits


@pytest.fixture(scope="module")
def unsharded(reference):
    """The port's system on the reference weights, one device, no mesh; a
    few item blocks' fp32 rows (every head) for the int8 check."""
    tree = reference[0]
    system, trace = _port_system(params_from_numpy(tree, tiny_config(2, 32, 4, 4),
                                                   device="cpu"))
    blocks = sorted({b.item_id: b for s in system.item_store.shards
                     for b in s.blocks.values()}.items())[:3]
    rows = {("item", str(it)): tuple(
        pool[:, b.row:b.row + len(b.tokens), 0].transpose(0, 1).numpy().copy()
        for pool in (system.rows.k, system.rows.v)) for it, b in blocks}
    return system, trace, rows


@pytest.fixture(scope="module", params=[2, 4], ids=["tp2", "tp4"])
def ranks(request, reference, unsharded):
    tp = request.param
    return tp, TMESH.spawn_ranks(_rank_job, tp, "cpu",
                                 args=(reference[0], unsharded[2], tp))


# ---------------------------------------------------------------- tests
@pytest.mark.parametrize("sched, reuse", RUNS, ids=[f"{s}-{'reuse' if r else 'priv'}"
                                                     for s, r in RUNS])
def test_tp1_mesh_is_bitwise_the_unsharded_path(reference, unsharded, sched, reuse):
    """tp = 1 on an explicit (1, 1) mesh: the reference's tokens, and the
    port's unsharded tokens, cached rows and prefill logits bitwise."""
    system, trace, _ = unsharded
    config = ServeConfig(sched=sched, kv_reuse=reuse, decode_steps=2)
    want, _ = _serve(system, trace, config)
    mesh_cfg = MeshConfig(mesh_shape=(1, 1))
    mesh = mesh_cfg.build()
    meshed, _ = _port_system(system.model, mesh)
    with CTX.axes(mesh):
        got, engine = _serve(meshed, trace, config.replace(mesh=mesh_cfg))
        logits = TENG.batched_prefill(meshed.model, PREFILL_TOKENS, np.array([31]), False)[0]
    assert engine.mesh is mesh and engine.pool.arena_k.shape[3] == 4
    assert got == want == reference[1][sched, reuse]
    assert torch.equal(meshed.rows.k, system.rows.k) and torch.equal(meshed.rows.v,
                                                                     system.rows.v)
    assert np.array_equal(logits, TENG.batched_prefill(system.model, PREFILL_TOKENS,
                                                        np.array([31]), False)[0])


@pytest.mark.parametrize("sched, reuse", RUNS, ids=[f"{s}-{'reuse' if r else 'priv'}"
                                                     for s, r in RUNS])
def test_sharded_tokens_equal_the_unsharded_reference(reference, ranks, sched, reuse):
    tp, outs = ranks
    for out in outs:
        assert out["backend"] == "gloo"
        assert out["runs"][sched, reuse]["tokens"] == reference[1][sched, reuse], out["rank"]


@pytest.mark.parametrize("sched, reuse", RUNS, ids=[f"{s}-{'reuse' if r else 'priv'}"
                                                     for s, r in RUNS])
def test_ranks_agree_on_plans_and_masks(ranks, sched, reuse):
    """Every rank logged the same digests of every step's plan and every
    recompute mask (the mesh's check compared them as they ran)."""
    tp, outs = ranks
    logs = [out["runs"][sched, reuse]["log"] for out in outs]
    tags = [tag for tag, _ in logs[0]]
    assert all(log == logs[0] for log in logs)
    assert tags.count("recompute mask") == 6 and "step plan" in tags


def test_rank_arenas_hold_their_kv_heads(ranks):
    tp, outs = ranks
    for out in outs:
        for run in out["runs"].values():
            assert run["arena"] == (512, 16, 2, 4 // tp, 16)
            assert run["page_tables"] == {}


def test_sharded_prefill_logits_allclose(reference, ranks):
    """Full-prefill logits at tp = 2 (and 4) within LOGIT_TOL of the JAX
    engine's, the same on every rank (the vocabulary gather)."""
    tp, outs = ranks
    for out in outs:
        np.testing.assert_allclose(out["logits"], reference[3], atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
    assert all(np.array_equal(out["logits"], outs[0]["logits"]) for out in outs)


def test_int8_payloads_are_the_head_slices(unsharded, ranks):
    """A rank's int8 payload of its kv heads' rows is the head slice of
    the unsharded store's payload: data and scales bitwise."""
    tp, outs = ranks
    _, _, rows = unsharded
    cfg = tiny_config(2, 32, 4, 4)
    whole = _int8_payloads(pool_for(cfg, n_pages=64, device="cpu"), rows, slice(None))
    hk = 4 // tp
    for out in outs:
        r = out["rank"]
        for key, parts in whole.items():
            for got, want in zip(out["int8"][key], parts):
                assert np.array_equal(got, want[:, :, r * hk:(r + 1) * hk]), (r, key)


def test_sharded_cluster_decodes_the_reference_cluster(reference, ranks):
    tp, outs = ranks
    for out in outs:
        c = out["cluster"]
        assert c["tokens"] == reference[2]
        assert c["devices"] == [torch.device("cpu")] * 2 and c["copies"] == "same device"
        assert c["measured"] == pytest.approx(c["billed"], abs=1e-9)
        assert c["log"] == outs[0]["cluster"]["log"]
        assert [t for t, _ in c["log"]].count("dispatch") == 6


def test_launcher_serves_a_tp2_mesh(capsys):
    """`launch.serve --config mesh.tp=2` starts the ranks itself; rank 0's
    JSON names the mesh, the backend and both ranks."""
    import json

    from repro_torch.launch import serve as PS

    PS.main(["--device", "cpu", "--requests", "3", "--decode-steps", "2", "--config",
             "mesh.tp=2,sched=chunked"])
    rep = json.loads(capsys.readouterr().out)
    assert rep["engine"] == "torch" and rep["requests"] == 3 and rep["decode_tokens"] == 6
    mesh = rep["mesh"]
    assert (mesh["tp"], mesh["dp"], mesh["shape"], mesh["backend"]) == (2, 1, [1, 2], "gloo")
    assert [r["rank"] for r in mesh["ranks"]] == [0, 1]
    assert {r["device"] for r in mesh["ranks"]} == {"cpu"}
