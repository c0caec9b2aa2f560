"""The port's mesh surface against the reference's (`tests/test_mesh.py`
and `repro/sharding`, `repro/launch/mesh.py`): `MeshConfig` and its
``--config`` grammar, the mesh construction, every spec tree at stub
meshes of (1, 1), (2, 4) and (16, 16) (duck-typed ``.shape`` /
``.axis_names``, so JAX needs no devices), the analytic roofline's
collective term, the rank-local weights (cut from a whole model, from
the reference's numpy tree, or drawn from a generator one parameter at a
time), the measured cross-shard transfers, and the errors of what is not
ported under tp > 1.  Everything here runs in this process (a one-rank
world); `test_torch_tp_serving.py` starts the ranks."""
import math
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as JR
from repro.gnn import schnet as JSCHNET
from repro.launch import roofline as JRF
from repro.launch import roofline_analytic as JRA
from repro.models import transformer as JT
from repro.sharding import specs as JS
from repro_torch.configs import registry as TR
from repro_torch.core.rcllm import tiny_config
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import roofline as TRF
from repro_torch.launch import roofline_analytic as TRA
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import init_params
from repro_torch.serving import api as API
from repro_torch.serving.api import MeshConfig, ServeConfig
from repro_torch.sharding import ctx as CTX
from repro_torch.sharding import specs as TS

STUB_SHAPES = [(1, 1), (2, 4), (16, 16)]
LM_ARCHS = ("rcllm-qwen3-8b", "gemma-7b", "nemotron-4-15b", "starcoder2-15b",
            "moonshot-v1-16b-a3b", "kimi-k2-1t-a32b")
RECSYS_ARCHS = ("wide-deep", "autoint", "dien", "bert4rec")


def _stub(shape):
    return SimpleNamespace(shape=dict(zip(("data", "model"), shape)),
                           axis_names=("data", "model"))


def _flat(tree, leaf, path=()):
    """{path: spec as a tuple} of a spec tree (`leaf` is its spec type)."""
    if isinstance(tree, leaf):
        return {path: tuple(tree)}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, leaf, path + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, leaf, path + (i,)))
        return out
    raise TypeError(type(tree))


def _same(port, ref):
    assert _flat(port, TS.P) == _flat(ref, JP)


# ------------------------------------------------------------ MeshConfig
def test_mesh_config_defaults_disabled():
    m = MeshConfig()
    assert not m.enabled and m.build() is None
    assert ServeConfig().mesh == m


def test_mesh_config_shape_derives_tp_dp():
    m = MeshConfig(mesh_shape=(2, 4))
    assert (m.tp, m.dp) == (4, 2) and m.enabled and m.n_devices == 8
    assert m.shape == {"data": 2, "model": 4}
    assert MeshConfig(tp=2).resolved_shape == (1, 2)
    m = MeshConfig(mesh_shape=(2, 2, 2), axis_names=("pod", "data", "model"))
    assert (m.tp, m.dp) == (2, 4)


@pytest.mark.parametrize("kw", [
    dict(tp=0),
    dict(tp=3, mesh_shape=(1, 2)),
    dict(dp=3, mesh_shape=(2, 4)),
    dict(axis_names=("data", "expert")),
    dict(axis_names=("model",)),
    dict(mesh_shape=(2, 2, 2)),
    dict(mesh_shape=(0, 2)),
])
def test_mesh_config_rejects(kw):
    with pytest.raises(ValueError, match="invalid MeshConfig"):
        MeshConfig(**kw)


def test_serve_config_cross_validates_mesh():
    with pytest.raises(ValueError) as ei:
        ServeConfig(engine="sim", mesh=MeshConfig(tp=2))
    assert "mesh" in str(ei.value) and "engine" in str(ei.value)


def test_kernels_stay_valid_under_tp():
    """The reference rejects its single-device Pallas kernels under tp;
    each rank of the port is a single-device program, so the kernels
    stay, and "auto" resolves as without a mesh."""
    cfg = ServeConfig(attn_backend="cuda", decode_kernel="paged", mesh=MeshConfig(tp=2))
    assert cfg.apply_to(tiny_config(2, 32)).decode_kernel == "paged"
    lm = ServeConfig(mesh=MeshConfig(tp=2)).apply_to(tiny_config(2, 32))
    assert (lm.attn_backend, lm.decode_kernel) == ("auto", "auto")


def test_parse_dotted_mesh_keys():
    c = ServeConfig.parse("mesh.tp=2,sched=chunked")
    assert c.mesh.tp == 2 and c.sched == "chunked"
    c = ServeConfig.parse("mesh.mesh_shape=2x4")
    assert (c.mesh.tp, c.mesh.dp) == (4, 2)
    c = ServeConfig.parse("mesh.mesh_shape=2x2x2,mesh.axis_names=pod+data+model")
    assert c.mesh.axis_names == ("pod", "data", "model")
    with pytest.raises(ValueError, match="mesh.bogus"):
        ServeConfig.parse("mesh.bogus=1")
    with pytest.raises(ValueError, match="sub-config"):
        ServeConfig.parse("mesh=2")
    with pytest.raises(ValueError, match="int tuple"):
        ServeConfig.parse("mesh.mesh_shape=two")


@pytest.mark.parametrize("cfg", [
    ServeConfig(),
    ServeConfig(mesh=MeshConfig(tp=2)),
    ServeConfig(mesh=MeshConfig(mesh_shape=(2, 4))),
    ServeConfig(mesh=MeshConfig(mesh_shape=(2, 1, 2), axis_names=("pod", "data", "model")),
                sched="chunked", kv_reuse=True),
    ServeConfig(k=2, mesh=MeshConfig(mesh_shape=(1, 1))),
])
def test_config_render_round_trip(cfg):
    assert ServeConfig.parse(cfg.render()) == cfg


# ------------------------------------------------------- mesh construction
def test_factor_devices_and_explicit_shape_error():
    assert TMESH.factor_devices(8) == (4, 2)
    assert TMESH.factor_devices(256) == (16, 16)
    assert TMESH.factor_devices(7) == (7, 1)
    with pytest.raises(RuntimeError, match=r"needs 256 devices"):
        TMESH.make_production_mesh(shape=(16, 16))
    with pytest.raises(RuntimeError, match=r"needs 2 devices"):
        MeshConfig(tp=2).build()
    mesh = MeshConfig(mesh_shape=(1, 1)).build()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.coords == {"data": 0, "model": 0}
    assert mesh.groups == {} and mesh.axis_ranks("model") == [0]


def test_mesh_layout_is_row_major():
    """Rank d * tp + m holds model shard m of replica d, as jax.make_mesh
    lays devices out."""
    mesh = TMESH.Mesh((2, 4), ("data", "model"), rank=6)
    assert mesh.coords == {"data": 1, "model": 2} and mesh.size == 8
    assert mesh.axis_ranks("model") == [4, 5, 6, 7]
    assert mesh.axis_ranks("data") == [2, 6]
    assert TMESH.collective_backend(2, "cpu") == "gloo"


def test_ctx_is_the_identity_outside_a_split_mesh():
    x = torch.arange(6.0).reshape(2, 3)
    assert CTX.current() is None and CTX.tp_size() == 1 and CTX.resolve("dp") is None
    assert CTX.all_reduce(x) is x and CTX.gather_vocab(x, 12) is x
    assert CTX.decide(1.5) == 1.5
    mesh = MeshConfig(mesh_shape=(1, 1)).build()
    with CTX.axes(mesh):
        assert CTX.current() is mesh and CTX.tp_size() == 1
        assert CTX.all_reduce(x) is x and CTX.mean_over_tp(x) is x
        assert tuple(CTX.resolve("dp", "mp", "dp+mp", None)) == (
            "data", "model", ("data", "model"), None)
    assert CTX.digest((1, [2, 3], np.arange(3))) == CTX.digest((1, [2, 3], np.arange(3)))
    assert CTX.digest((1, 2)) != CTX.digest((2, 1))


# ------------------------------------------------------------- spec trees
@pytest.mark.parametrize("shape", STUB_SHAPES)
def test_lm_specs_equal_the_reference(shape):
    mesh = _stub(shape)
    for arch in LM_ARCHS:
        tcfg, jcfg = TR.ARCHS[arch], JR.ARCHS[arch]
        for mode in ("train", "serve"):
            _same(TS.lm_param_specs(tcfg, mesh, mode=mode),
                  JS.lm_param_specs(jcfg, mesh, mode=mode))
        for step, name in (("train", "train_4k"), ("prefill", "prefill_32k"),
                           ("decode", "decode_32k"), ("decode", "long_500k")):
            dims = TR.LM_SHAPES[name].dims
            _same(TS.lm_input_specs(tcfg, mesh, step, dims),
                  JS.lm_input_specs(jcfg, mesh, step, dims))
        for b in (1, 16, 256):
            _same(TS.lm_cache_spec(tcfg, mesh, b, 1024), JS.lm_cache_spec(jcfg, mesh, b, 1024))
    assert tuple(TS.serving_arena_spec()) == tuple(JS.serving_arena_spec())


@pytest.mark.parametrize("shape", STUB_SHAPES)
def test_zero_shard_equals_the_reference(shape):
    mesh = _stub(shape)
    for arch in ("rcllm-qwen3-8b", "moonshot-v1-16b-a3b"):
        tcfg, jcfg = TR.ARCHS[arch], JR.ARCHS[arch]
        shapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), jcfg))
        _same(TS.zero_shard(TS.lm_param_specs(tcfg, mesh), shapes, mesh),
              JS.zero_shard(JS.lm_param_specs(jcfg, mesh), shapes, mesh))


@pytest.mark.parametrize("shape", STUB_SHAPES)
def test_recsys_and_gnn_specs_equal_the_reference(shape):
    mesh = _stub(shape)
    for arch in RECSYS_ARCHS:
        tcfg, jcfg = TR.ARCHS[arch], JR.ARCHS[arch]
        _same(TS.recsys_param_specs(tcfg, mesh), JS.recsys_param_specs(jcfg, mesh))
        for name, spec in TR.RECSYS_SHAPES.items():
            _same(TS.recsys_input_specs(tcfg, mesh, spec.step, spec.dims),
                  JS.recsys_input_specs(jcfg, mesh, spec.step, spec.dims))
    abstract = JSCHNET.abstract_params(JR.ARCHS["schnet"])
    _same(TS.gnn_param_specs(abstract, mesh), JS.gnn_param_specs(abstract, mesh))
    for name in JR.GNN_SHAPES:
        shapes = JR.input_specs("schnet", name)
        _same(TS.gnn_input_specs(mesh, name, shapes), JS.gnn_input_specs(mesh, name, shapes))


def test_serving_divisibility_names_both_head_counts():
    cfg = tiny_config(2, 32)            # 4 heads, 2 kv heads
    TS.check_serving_divisibility(cfg, _stub((1, 2)))
    with pytest.raises(ValueError, match=r"n_heads=4 and n_kv_heads=2") as ei:
        TS.check_serving_divisibility(cfg, _stub((1, 4)))
    with pytest.raises(ValueError) as ej:
        JS.check_serving_divisibility(JR.ARCHS["rcllm-qwen3-8b"], _stub((1, 3)))
    with pytest.raises(ValueError) as et:
        TS.check_serving_divisibility(TR.ARCHS["rcllm-qwen3-8b"], _stub((1, 3)))
    assert str(et.value) == str(ej.value) and "mesh.tp=4" in str(ei.value)


# ------------------------------------------------------- analytic roofline
@pytest.mark.parametrize("n_chips, data_par", [(2, 1), (8, 2), (256, 16)])
@pytest.mark.parametrize("step, shape", [("train", "train_4k"), ("prefill", "prefill_32k"),
                                         ("decode", "decode_32k")])
def test_lm_analytic_collective_term_equals_the_reference(n_chips, data_par, step, shape):
    """Per-device FLOPs, bytes and collective bytes equal the reference's
    at its knobs' defaults; the times are the reference's scaled by the
    two packages' rates (the H100's NVLink for the collective term)."""
    dims = TR.LM_SHAPES[shape].dims
    for arch in ("rcllm-qwen3-8b", "moonshot-v1-16b-a3b"):
        got = TRA.lm_analytic(TR.ARCHS[arch], step, dims, n_chips=n_chips,
                              data_par=data_par)
        want = JRA.lm_analytic(JR.ARCHS[arch], step, dims, n_chips=n_chips,
                               data_par=data_par)
        for key in ("flops_per_device", "bytes_per_device", "collective_bytes_per_device"):
            assert got[key] == want[key], (arch, key)
        scale = {"compute_s": JRF.PEAK_FLOPS / TRF.PEAK_FLOPS,
                 "memory_s": JRF.HBM_BW / TRF.HBM_BW,
                 "collective_s": JRF.ICI_BW / TRF.NVLINK_BW}
        for key, r in scale.items():
            assert math.isclose(got[key], want[key] * r, rel_tol=1e-12), (arch, key)
        terms = {k: got[k + "_s"] for k in ("compute", "memory", "collective")}
        assert got["bottleneck"] == max(terms, key=terms.get)


def test_lm_analytic_default_is_one_card():
    dims = TR.LM_SHAPES["decode_32k"].dims
    cfg = TR.ARCHS["gemma-7b"]
    assert TRA.lm_analytic(cfg, "decode", dims) == TRA.lm_analytic(cfg, "decode", dims,
                                                                   n_chips=1, data_par=1)
    assert "collective_s" not in TRA.lm_analytic(cfg, "decode", dims)


# ------------------------------------------------------- rank-local weights
@pytest.fixture(scope="module")
def jax_tiny_params():
    from repro.core.rcllm import make_tiny_system as jax_tiny

    jsys, _, _, _ = jax_tiny(n_items=40, n_requests_hist=25, k_instances=2, n_layers=2,
                             d_model=32, n_heads=4, n_kv_heads=4)
    return jax.tree_util.tree_map(np.asarray, jsys.params), tiny_config(2, 32, 4, 4)


@pytest.mark.parametrize("tp", [2, 4])
def test_shards_are_the_whole_model_cut_by_the_serve_specs(jax_tiny_params, tp):
    """A rank's shard cut from the whole port model equals the one cut
    from the reference's numpy tree, and the concatenation of the ranks'
    shards along the serve specs' model dims is the whole model."""
    tree, cfg = jax_tiny_params
    whole = params_from_numpy(tree, cfg, device="cpu")
    shards = [TS.shard_lm_params(whole, cfg, _stub((1, tp)), coords={"model": r})
              for r in range(tp)]
    dims = {"embed": 0, "lm_head": 1, "wq": 1, "wk": 1, "wv": 1, "wo": 0,
            "mlp.w_up": 1, "mlp.w_gate": 1, "mlp.w_down": 0}
    for r in range(tp):
        from_tree = TS.shard_lm_params(tree, cfg, _stub((1, tp)), coords={"model": r})
        for (name, a), (_, b) in zip(shards[r].named_parameters(),
                                     from_tree.named_parameters()):
            assert torch.equal(a, b), name
    assert shards[1].tp == tp and shards[1].tp_rank == 1
    assert shards[0].layers[0].wk.shape[1] == cfg.n_kv_heads // tp
    for name, p in whole.named_parameters():
        key = name.split(".", 2)[2] if name.startswith("layers.") else name
        parts = [s.get_parameter(name) for s in shards]
        got = torch.cat(parts, dim=dims[key]) if key in dims else parts[0]
        assert torch.equal(got, p), name


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_sharded_init_draws_init_params_blocks(tp):
    """`init_sharded_params` draws every whole parameter as `init_params`
    does (same generator order) and keeps the rank's block."""
    cfg = tiny_config(2, 32, 4, 4 if tp == 4 else 2)
    whole = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for r in range(tp):
        mesh = SimpleNamespace(**vars(_stub((1, tp))), coords={"data": 0, "model": r})
        got, embed = TS.init_sharded_params(cfg, mesh, torch.Generator().manual_seed(0), "cpu")
        want = TS.shard_lm_params(whole, cfg, mesh)
        for (name, a), (_, b) in zip(got.named_parameters(), want.named_parameters()):
            assert torch.equal(a, b), name
        assert np.array_equal(embed, whole.embed.numpy())


def test_a_shard_refuses_to_run_outside_its_mesh():
    """A shard's steps run only inside a mesh of its tp (each looks its
    tokens up through `embed_tokens`); what reads the whole model (the
    semantic cache's token embedding) refuses a shard."""
    from repro_torch.models import transformer as TT

    cfg = tiny_config(2, 32)
    whole = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    shard = TS.shard_lm_params(whole, cfg, _stub((1, 2)), coords={"model": 0})
    with pytest.raises(ValueError, match="split over 2 ranks"):
        shard.embed_tokens(torch.tensor([1, 2]))
    with pytest.raises(ValueError, match="split over 2 ranks"):
        TT.prefill(shard, torch.tensor([[1, 2]]))
    with pytest.raises(ValueError, match="split over 2 ranks"):
        TT.loss_fn(shard, torch.tensor([[1, 2]]), torch.tensor([[2, 3]]))
    with pytest.raises(ValueError, match="needs the whole model"):
        shard.whole("the semantic cache's token embedding")


# --------------------------------------------------- measured transfers
@pytest.fixture(scope="module")
def tiny_port(jax_tiny_params):
    """The port's system on the reference's tiny weights and a six-request
    trace (the reference's `tiny` fixture)."""
    from repro_torch.core.rcllm import make_tiny_system
    from repro_torch.data import synth as TSY

    tree, cfg = jax_tiny_params
    model = params_from_numpy(tree, cfg, device="cpu")
    system, pool_rv, prof, _ = make_tiny_system(
        n_items=40, n_requests_hist=25, k_instances=2, n_layers=2, d_model=32, n_heads=4,
        n_kv_heads=4, device="cpu", model=model)
    trace = TSY.make_trace(system.catalog, pool_rv, prof, 6, qps=50.0, n_users=3,
                           n_candidates=6, reviews_per_user=1, seed=3)
    return system, trace


def test_shard_client_measured_transfers(tiny_port):
    """With home devices a cross-shard pull is a measured device copy:
    measured_s lands in the TransferRecord and the pending sum, and the
    block's bytes are unchanged."""
    from repro_torch.core import item_cache as IC

    system, _ = tiny_port
    store = system.item_store
    remote = next(it for it in store.shards[1].blocks if it not in store.shards[0].blocks)
    ledger = IC.ShardClient(store, 0)
    assert not ledger.measures
    blk_l = ledger.pull(remote)
    assert ledger.transfers[0].measured_s == 0.0
    client = IC.ShardClient(store, 0, devices=[torch.device("cpu")] * 2)
    assert client.measures and client.home_device(3) == torch.device("cpu")
    blk = client.pull(remote)
    rec = client.transfers[0]
    assert rec.measured_s > 0.0
    assert client.measured_seconds() == rec.measured_s
    assert client.take_measured_s() == rec.measured_s
    assert client.take_measured_s() == 0.0
    np.testing.assert_array_equal(blk.k, blk_l.k)


def test_cluster_bills_measured_transfer_time(tiny_port):
    """Under config.mesh the cluster bills the measured copies (the sum of
    the per-pull measurements is the sum of the workers' billing) and
    decodes the same tokens as the ledgered path."""
    from repro_torch.serving.cluster import ClusterEngine

    system, trace = tiny_port
    base = ServeConfig(k=2, decode_steps=2)
    rep0 = ClusterEngine(system, base).run(trace, decode_steps=2)
    ce = ClusterEngine(system, base.replace(mesh=MeshConfig(mesh_shape=(1, 1))))
    assert ce.worker_devices is not None and ce.transfer_copies == "same device"
    rep1 = ce.run(trace, decode_steps=2)
    tok = lambda rep: {r: [int(t) for t in ts] for r, ts in rep.generated.items()}
    assert tok(rep0) == tok(rep1)
    measured = sum(b.shard.measured_seconds() for b in ce.backends if b.shard)
    billed = sum(b.transfer_seconds for b in ce.backends)
    assert measured == pytest.approx(billed, abs=1e-9)
    if sum(len(b.shard.transfers) for b in ce.backends if b.shard):
        assert measured > 0.0


# ------------------------------------------------ what waits (ROADMAP A.2)
def test_session_server_under_tp_names_the_roadmap_item():
    """The server runs under tp > 1 now (`test_torch_tp_server.py`), inside
    a mesh of that tp only.  A kv-head count tp does not divide no longer
    waits: the LM steps cut each kv head's Dh (`test_torch_tp_kv_split.py`),
    and the RcLLM serving path refuses it as the reference does, naming
    both head counts."""
    from repro_torch.serving.server import AsyncSessionServer

    with pytest.raises(ValueError, match="runs inside a mesh whose model axis has 2 ranks"):
        AsyncSessionServer(None, ServeConfig(mesh=MeshConfig(tp=2)))
    cfg = TR.get_config("rcllm-qwen3-8b", smoke=True)      # 4 query / 2 kv heads
    shard = TS.shard_lm_params(init_params(cfg, torch.Generator().manual_seed(0), device="cpu"),
                               cfg, _stub((1, 4)), coords={"model": 1})
    assert tuple(shard.layers[0].wk.shape) == (64, 2, 4)   # every kv head, Dh / 4
    assert shard.layers[0].kv_keep == slice(0, 1)          # query head 1 reads kv head 0
    with pytest.raises(ValueError, match="n_kv_heads=2"):
        TS.check_serving_divisibility(cfg, _stub((1, 4)))


def test_tp_must_divide_kv_heads(tiny_port):
    system, _ = tiny_port
    with pytest.raises(ValueError, match=r"n_kv_heads"):
        API.build_engine(system.model, system.cfg, ServeConfig(mesh=MeshConfig(tp=3)),
                         cache=system.rows)


def test_launcher_refuses_before_starting_ranks(capsys):
    from repro_torch.launch import serve as PS

    with pytest.raises(SystemExit, match="n_kv_heads"):
        PS.main(["--device", "cpu", "--config", "mesh.tp=4"])     # tiny: 2 kv heads
    with pytest.raises(SystemExit, match="single-worker session server"):
        PS.main(["--device", "cpu", "--server", "--config", "mesh.tp=2,k=2"])
