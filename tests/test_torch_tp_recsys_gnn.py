"""The recsys and SchNet train / serve steps on a mesh of gloo ranks
(`launch.steps.build`), held against the reference's UNSHARDED functions
at reduced() size in fp32 on the CPU.

* Recsys, all four archs, at (dp, tp) = (2, 1), (1, 2) and (2, 2): every
  table of 4,096 rows or more is cut by rows over every axis (a rank's
  block of 2,048 or 1,024), and a lookup is the rank's window summed over
  the ranks, each data rank keeping its rows.  `score` (8 rows, cut over
  the data axis) and `retrieval_scores` (one query, the same on every
  rank, against 64 candidates) within TOL = 1e-5 (atol = rtol): the
  lookups are exact (one rank holds each row), the wide sum (B5's plain
  version on each window) adds its fields per rank, then over the ranks.
  Two AdamW steps of `train_loss` (8 rows a step, BERT4Rec's 16
  negatives the same on every rank): the losses and gradient norms within
  1e-5 relative, each rank's parameters after them (its block of each
  table) within PARAM_TOL = 1e-4 absolute (AdamW turns summation-order
  noise near a zero gradient into a visible share of a step, as
  `test_torch_tp_lm.py` notes).
* SchNet, the three cells (`full_graph_sm`, `molecule`, `minibatch_lg`)
  at the same layouts: a graph's edges cut over every axis where they
  divide (the aggregations summed over the ranks, per-edge parameters'
  gradients summed, per-node ones counted once), molecules over the data
  axis.  Two AdamW steps: losses and norms within 1e-5 relative, the
  parameters within PARAM_TOL.
* The bundles' optimizer states equal the reference's spec data; the
  reference's `_prep` pads a graph's edges to the mesh (pad count) and the
  padded edges add nothing (the loss bitwise, gradients within 1e-6).

Each layout's ranks start once, one torch thread each, on a thread while
this process computes the reference (`torch_tp_ranks.recsys_gnn_rank_job`,
which imports no JAX)."""
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as JR
from repro.gnn import schnet as JG
from repro.recsys import models as JM
from repro.sharding import specs as JS
from repro.training import optimizer as JO
from repro_torch.configs import registry as TR
from repro_torch.data.pipeline import rows_of
from repro_torch.gnn import schnet as TG
from repro_torch.gnn.convert import schnet_params_from_numpy
from repro_torch.launch import mesh as TMESH
from repro_torch.sharding import specs as SPECS
from repro_torch.training.train_loop import trainable

import torch_tp_ranks as RK

TOL, PARAM_TOL = 1e-5, 1e-4
LAYOUTS = [(2, 1), (1, 2), (2, 2)]
RECSYS_ARCHS = [a for a in JR.ASSIGNED if JR.family_of(a) == "recsys"]
B, N_CAND, N_NEG = 8, 64, 16
GRAPH = dict(d_feat=12, n_classes=5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _name(path) -> str:
    return ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


# ------------------------------------------------------------ inputs
def _rows(cfg, b, rng):
    if cfg.kind in ("wide_deep", "autoint"):
        return {"dense": rng.normal(size=(b, cfg.n_dense)).astype(np.float32),
                "sparse_ids": np.stack([rng.integers(0, v, b) for v in cfg.field_vocabs],
                                       axis=1).astype(np.int32)}
    T = cfg.seq_len
    mask = np.arange(T)[None] < rng.integers(1, T + 1, b)[:, None]
    items = rng.integers(0, cfg.n_items, (b, T)).astype(np.int32)
    if cfg.kind == "dien":
        return {"hist_items": items,
                "hist_cates": rng.integers(0, cfg.n_cates, (b, T)).astype(np.int32),
                "hist_mask": mask,
                "target_item": rng.integers(0, cfg.n_items, b).astype(np.int32),
                "target_cate": rng.integers(0, cfg.n_cates, b).astype(np.int32)}
    return {"item_seq": items, "seq_mask": mask}


def recsys_batches(cfg, seed):
    """The score (B rows), retrieval (one query, N_CAND candidates) and
    train (B rows) batches of one arch."""
    rng = np.random.default_rng(seed)
    n_rows = cfg.n_items if cfg.kind in ("dien", "bert4rec") else sum(cfg.field_vocabs)
    train = _rows(cfg, B, rng)
    if cfg.kind == "bert4rec":
        train.update(mlm_positions=rng.integers(0, cfg.seq_len, (B, 2)).astype(np.int32),
                     mlm_labels=rng.integers(0, cfg.n_items, (B, 2)).astype(np.int32),
                     neg_samples=rng.integers(0, cfg.n_items, N_NEG).astype(np.int32))
    else:
        train["labels"] = rng.integers(0, 2, B).astype(np.float32)
    return {"score": _rows(cfg, B, rng),
            "retrieval": dict(_rows(cfg, 1, rng), candidate_ids=rng.integers(
                0, n_rows, N_CAND).astype(np.int32)),
            "train": train}


def _graph(rng, n=40, e=152):
    return {"node_feat": rng.normal(size=(n, GRAPH["d_feat"])).astype(np.float32),
            "positions": (rng.normal(size=(n, 3)) * 2).astype(np.float32),
            "edge_src": rng.integers(0, n, e).astype(np.int32),
            "edge_dst": rng.integers(0, n, e).astype(np.int32),
            "labels": rng.integers(0, GRAPH["n_classes"], n).astype(np.int32)}


def _molecules(rng, b=4, n=6, e=10):
    mask = np.ones((b, e), bool)
    mask[:, -3:] = False
    return {"atom_types": rng.integers(0, 100, (b, n)).astype(np.int32),
            "positions": (rng.normal(size=(b, n, 3)) * 1.5).astype(np.float32),
            "edge_src": rng.integers(0, n, (b, e)).astype(np.int32),
            "edge_dst": rng.integers(0, n, (b, e)).astype(np.int32),
            "edge_mask": mask, "targets": rng.normal(size=b).astype(np.float32)}


def _minibatch(rng):
    from repro_torch.gnn import sampler as TS

    src, dst = TS.make_powerlaw_graph(300, 1500, seed=2)
    sub = TS.sample_subgraph(TS.CSRGraph(300, src, dst), np.arange(6), (4, 3), rng)
    feats = rng.normal(size=(300, GRAPH["d_feat"])).astype(np.float32)
    coords = (rng.normal(size=(300, 3)) * 2).astype(np.float32)
    keep = sub["edge_src"].shape[0] // 4 * 4          # the edges over every axis
    return {"node_feat": feats[sub["node_ids"]], "positions": coords[sub["node_ids"]],
            "edge_src": sub["edge_src"][:keep], "edge_dst": sub["edge_dst"][:keep],
            "seed_labels": rng.integers(0, GRAPH["n_classes"], 6).astype(np.int32)}


GNN_BATCHES = {"full_graph_sm": _graph, "molecule": _molecules, "minibatch_lg": _minibatch}


# --------------------------------------------------------- reference
def _jax_train(loss_fn, params, batch, cfg):
    init, update = JO.get("adamw")
    state = init(params)
    step = jax.jit(lambda p, s, b: (lambda lg: update(lg[1], s, p) + (lg[0],))(
        jax.value_and_grad(loss_fn)(p, b, cfg)))
    hist = []
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    for _ in range(RK.MESH_STEPS):
        params, state, gnorm, loss = step(params, state, jb)
        hist.append({"loss": float(loss), "gnorm": float(gnorm)})
    return hist, {_name(p): np.asarray(v)
                  for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}


def reference(cases):
    out = {"recsys": {}, "gnn": {}}
    for arch in RECSYS_ARCHS:
        cfg = JR.get_config(arch, smoke=True)
        tree, batches = cases[arch]
        params = jax.tree_util.tree_map(jnp.asarray, tree)
        jb = {k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in batches.items()}
        res = {"score": np.asarray(JM.score(params, jb["score"], cfg)),
               "retrieval": np.asarray(JM.retrieval_scores(params, jb["retrieval"], cfg))}
        res["train"], res["params"] = _jax_train(JM.train_loss, params, batches["train"], cfg)
        out["recsys"][arch] = res
    cfg = JR.get_config("schnet", smoke=True)
    for cell, (tree, batch, _) in cases["schnet"].items():
        params = jax.tree_util.tree_map(jnp.asarray, tree)
        hist, got = _jax_train(JG.train_loss, params, batch, cfg)
        out["gnn"][cell] = {"hist": hist, "params": got}
    return out


def make_cases():
    cases = {}
    for i, arch in enumerate(RECSYS_ARCHS):
        cfg = JR.get_config(arch, smoke=True)
        tree = jax.tree_util.tree_map(np.asarray, JM.init_params(jax.random.PRNGKey(i), cfg))
        cases[arch] = (tree, recsys_batches(cfg, 10 + i))
    cfg = JR.get_config("schnet", smoke=True)
    cases["schnet"] = {}
    for i, (cell, make) in enumerate(GNN_BATCHES.items()):
        graph = {} if cell == "molecule" else GRAPH
        tree = jax.tree_util.tree_map(np.asarray, JG.init_params(jax.random.PRNGKey(20 + i),
                                                                 cfg, **graph))
        cases["schnet"][cell] = (tree, make(np.random.default_rng(30 + i)), graph)
    return cases


@pytest.fixture(scope="module")
def both():
    cases = make_cases()
    box = {}

    def start():
        try:
            box["ranks"] = {layout: TMESH.spawn_ranks(
                RK.recsys_gnn_rank_job, layout[0] * layout[1], "cpu", args=(cases, layout))
                for layout in LAYOUTS}
        except BaseException as e:          # raised below, in the test's thread
            box["error"] = e

    th = threading.Thread(target=start)
    th.start()
    try:
        ref = reference(cases)
    finally:
        th.join()
    if "error" in box:
        raise box["error"]
    return cases, ref, box["ranks"]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def by_layout(f):
    return pytest.mark.parametrize("layout", LAYOUTS, ids=[f"dp{d}-tp{t}" for d, t in LAYOUTS])(f)


# ---------------------------------------------------------------- tests
@by_layout
@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_score_and_retrieval_match_the_unsharded_reference(both, layout, arch):
    _, ref, ranks = both
    for out in ranks[layout]:
        assert out["backend"] == "gloo"
        got, want = out["recsys"][arch], ref["recsys"][arch]
        scores, cut = got["score"]
        assert cut
        _close(scores, rows_of(want["score"], out["coords"]["data"], layout[0]))
        scores, cut = got["retrieval"]
        assert not cut or layout[0] == 1
        _close(scores, want["retrieval"])


@by_layout
@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_train_steps_match_the_unsharded_reference(both, layout, arch):
    """Two AdamW steps: losses and norms, and each rank's parameters
    (tables: its block of rows, `row0` its first) after them."""
    _, ref, ranks = both
    want = ref["recsys"][arch]
    n = layout[0] * layout[1]
    for out in ranks[layout]:
        got = out["recsys"][arch]
        for g, w in zip(got["train"], want["train"]):
            assert g["loss"] == pytest.approx(w["loss"], rel=TOL)
            assert g["gnorm"] == pytest.approx(w["gnorm"], rel=TOL)
        assert set(got["params"]) == set(want["params"])
        c = out["coords"]["data"] * layout[1] + out["coords"]["model"]
        assert got["row0"]
        for name, w in want["params"].items():
            if name in got["row0"]:
                rows = w.shape[0] // n
                assert got["row0"][name] == c * rows
                w = w[c * rows:(c + 1) * rows]
            np.testing.assert_allclose(got["params"][name], w, rtol=0, atol=PARAM_TOL,
                                       err_msg=name)


@by_layout
@pytest.mark.parametrize("cell", list(GNN_BATCHES))
def test_schnet_train_steps_match_the_unsharded_reference(both, layout, cell):
    cases, ref, ranks = both
    want = ref["gnn"][cell]
    batch = cases["schnet"][cell][1]
    for out in ranks[layout]:
        got = out["gnn"][cell]
        if cell != "molecule":                             # edges over every axis
            assert got["edges"] * layout[0] * layout[1] == batch["edge_src"].shape[0]
        for g, w in zip(got["hist"], want["hist"]):
            assert g["loss"] == pytest.approx(w["loss"], rel=TOL)
            assert g["gnorm"] == pytest.approx(w["gnorm"], rel=TOL)
        for name, w in want["params"].items():
            np.testing.assert_allclose(got["params"][name], w, rtol=0, atol=PARAM_TOL,
                                       err_msg=name)


def _stub(shape):
    return SimpleNamespace(shape=dict(zip(("data", "model"), shape)),
                           axis_names=("data", "model"))


def _flat(tree, leaf, path=()):
    if isinstance(tree, leaf):
        return {path: tuple(tree)}
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, leaf, path + (k,)).items()}
    return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, leaf, path + (i,)).items()}


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (16, 16)])
def test_opt_state_specs_equal_the_reference(shape):
    """The recsys bundle's AdamW moments (ZeRO-cut parameter specs) and the
    GNN bundle's (the parameters' replicated specs), as spec data."""
    mesh = _stub(shape)
    for arch in RECSYS_ARCHS:
        jcfg, tcfg = JR.ARCHS[arch], TR.ARCHS[arch]
        jabs = JM.abstract_params(jcfg)
        jz = JS.zero_shard(JS.recsys_param_specs(jcfg, mesh), jabs, mesh)
        got = SPECS.recsys_opt_state_specs(tcfg, mesh)
        assert tuple(got.step) == ()
        for k in ("m", "v"):
            assert _flat(got.inner[k], SPECS.P) == _flat(jz, JP)
    for graph in ({}, GRAPH):
        jabs = JG.abstract_params(JR.ARCHS["schnet"], **graph)
        tabs = SPECS.tree_map(lambda a: SimpleNamespace(shape=a.shape), jax.tree_util.tree_map(
            lambda a: SimpleNamespace(shape=tuple(a.shape)), jabs))
        got = SPECS.gnn_opt_state_specs(tabs, mesh)
        want = JS.gnn_param_specs(jabs, mesh)
        for k in ("m", "v"):
            assert _flat(got.inner[k], SPECS.P) == _flat(want, JP)


def test_recsys_train_layout_cuts_the_tables_only():
    cfg = TR.get_config("wide-deep", smoke=True)
    lay = SPECS.recsys_train_layout(cfg, _stub((2, 2)))
    assert lay["table"].data_cut and lay["wide_table"].data_cut
    assert lay["table"].model_dims == (0,)
    assert not lay["deep.1.w"].data_cut and lay["deep.1.w"].data_dim == 0
    assert lay["deep.0.w"].data_dim == 1                  # (1293, 1024): the first even dim
    assert lay["wide_dense"].data_dim is None             # (13, 1): whole on every data rank


def test_prep_pads_edges_to_the_mesh_and_the_pads_add_nothing():
    """`schnet.pad_edges` (the reference's `_prep`): the pad count makes the
    edges a multiple of the ranks, src pads with 0 and dst with n_nodes,
    and the padded graph's loss is the unpadded graph's, bitwise (masked
    before the scatter), its gradients within 1e-6 (the filter's products
    sum over two more, zero, rows)."""
    cfg = TR.get_config("schnet", smoke=True)
    jtree = jax.tree_util.tree_map(np.asarray, JG.init_params(
        jax.random.PRNGKey(3), JR.get_config("schnet", smoke=True), **GRAPH))
    batch = {k: torch.from_numpy(v) for k, v in _graph(np.random.default_rng(4), e=150).items()}
    padded = TG.pad_edges(batch, 8, 40)
    assert padded["edge_src"].shape[0] == 152 and int(padded["edge_mask"].sum()) == 150
    assert padded["edge_dst"][150:].tolist() == [40, 40]
    assert padded["edge_src"][150:].tolist() == [0, 0]
    assert TG.pad_edges(batch, 2, 40)["edge_src"].shape[0] == 150
    got = []
    for b in (batch, padded):
        model = schnet_params_from_numpy(jtree, cfg, "cpu", **GRAPH)
        with trainable(model) as named:
            loss = TG.train_loss(model, b)
            loss.backward()
            got.append((float(loss.detach()), {n: p.grad.clone() for n, p in named}))
    assert got[0][0] == got[1][0]
    for n, g in got[0][1].items():
        torch.testing.assert_close(got[1][1][n], g, rtol=1e-6, atol=1e-6, msg=n)


@pytest.mark.parametrize("arch", ["wide-deep", "schnet"])
def test_train_launcher_at_dp2_matches_the_reference(arch, capsys):
    """`launch/train.py --smoke --config mesh.dp=2` (two gloo ranks, the
    family's train cell at reduced(): 64 Wide&Deep rows, SchNet's
    full_graph_sm) against the reference's `train_loss` and `adamw` on
    the same weights and batch (seed 0, converted through numpy): the
    losses and gradient norms of two steps within 1e-5 relative."""
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train as TRN
    from repro_torch.recsys.models import ParamTree

    rep = TRN.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                    "--config", "mesh.dp=2"])
    capsys.readouterr()
    assert rep["mesh"]["dp"] == 2 and rep["mesh"]["backend"] == "gloo"
    cell = TRN.TRAIN_CELL[TR.family_of(arch)]
    cfg = TR.get_config(arch, smoke=True)
    gen = torch.Generator().manual_seed(0)
    model = ST.init_model(cfg, gen, "cpu", cell)
    batch = TR.make_batch(cfg, cell, gen, "cpu", 64 if arch == "wide-deep" else None)

    def tree(m):
        if isinstance(m, torch.nn.ModuleList):
            return [tree(c) for c in m]
        out = {n: p.detach().numpy() for n, p in m.named_parameters(recurse=False)}
        out.update({n: tree(c) for n, c in m.named_children() if isinstance(
            c, (ParamTree, torch.nn.ModuleList))})
        return out
    jcfg = JR.get_config(arch, smoke=True)
    loss_fn = JM.train_loss if arch == "wide-deep" else JG.train_loss
    hist, _ = _jax_train(loss_fn, jax.tree_util.tree_map(jnp.asarray, tree(model)),
                         {k: v.numpy() for k, v in batch.items()}, jcfg)
    assert rep["loss"] == pytest.approx([h["loss"] for h in hist], rel=TOL)
    assert rep["gnorm"] == pytest.approx([h["gnorm"] for h in hist], rel=TOL)
