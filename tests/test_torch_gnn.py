"""Port parity for SchNet and its sampler (`repro_torch.gnn`) against the
JAX package (`repro.gnn`): the train loss and its gradients in the three
modes the card runs (full graph, molecules with edge masks, a sampled
minibatch with the loss on its seeds) at reduced() size, with the
reference's weights converted through numpy and numpy inputs, fp32 on
the CPU: loss within 1e-5 relative, gradients within atol = rtol = 1e-5
(TOL).  The sampler and the power-law graph equal the reference's
exactly for the same seeds; the radial centres equal `jnp.linspace`
bitwise; the reference's own GNN tests are mirrored."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.gnn import sampler as JS
from repro.gnn import schnet as JG
from repro_torch.configs import registry as TR
from repro_torch.gnn import sampler as TS
from repro_torch.gnn import schnet as TG
from repro_torch.gnn.convert import schnet_params_from_numpy
from repro_torch.training.train_loop import trainable

TOL = 1e-5


def _name(path) -> str:
    return ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _graph_batch(rng, n=40, e=150, d_feat=12, n_classes=5):
    return {"node_feat": rng.normal(size=(n, d_feat)).astype(np.float32),
            "positions": (rng.normal(size=(n, 3)) * 2).astype(np.float32),
            "edge_src": rng.integers(0, n, e).astype(np.int32),
            "edge_dst": rng.integers(0, n, e).astype(np.int32),
            "labels": rng.integers(0, n_classes, n).astype(np.int32)}


def _molecule_batch(rng, b=3, n=6, e=10):
    mask = np.ones((b, e), bool)
    mask[:, -3:] = False
    return {"atom_types": rng.integers(0, 100, (b, n)).astype(np.int32),
            "positions": (rng.normal(size=(b, n, 3)) * 1.5).astype(np.float32),
            "edge_src": rng.integers(0, n, (b, e)).astype(np.int32),
            "edge_dst": rng.integers(0, n, (b, e)).astype(np.int32),
            "edge_mask": mask, "targets": rng.normal(size=b).astype(np.float32)}


def _minibatch(rng, n_graph=300, e_graph=1500, d_feat=12, n_classes=5):
    src, dst = TS.make_powerlaw_graph(n_graph, e_graph, seed=2)
    g = TS.CSRGraph(n_graph, src, dst)
    sub = TS.sample_subgraph(g, np.arange(6), (4, 3), rng)
    feats = rng.normal(size=(n_graph, d_feat)).astype(np.float32)
    coords = (rng.normal(size=(n_graph, 3)) * 2).astype(np.float32)
    return {"node_feat": feats[sub["node_ids"]], "positions": coords[sub["node_ids"]],
            "edge_src": sub["edge_src"], "edge_dst": sub["edge_dst"],
            "seed_labels": rng.integers(0, n_classes, 6).astype(np.int32)}


MODES = {"full_graph": _graph_batch, "molecule": _molecule_batch, "minibatch": _minibatch}


@pytest.mark.parametrize("mode", list(MODES))
def test_train_loss_and_gradients_match_the_reference(mode):
    cfg, jcfg = TR.get_config("schnet", smoke=True), JR.get_config("schnet", smoke=True)
    batch = MODES[mode](np.random.default_rng(11))
    graph = dict(d_feat=12, n_classes=5) if mode != "molecule" else {}
    params = JG.init_params(jax.random.PRNGKey(0), jcfg, **graph)
    model = schnet_params_from_numpy(jax.tree_util.tree_map(np.asarray, params), cfg,
                                     "cpu", **graph)
    jloss, jgrads = jax.jit(jax.value_and_grad(JG.train_loss), static_argnums=2)(
        params, jax.tree_util.tree_map(jnp.asarray, batch), jcfg)
    with trainable(model) as named:
        loss = TG.train_loss(model, {k: torch.from_numpy(v) for k, v in batch.items()})
        loss.backward()
        grads = {n: p.grad.clone() for n, p in named}
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=TOL)
    flat, _ = jax.tree_util.tree_flatten_with_path(jgrads)
    assert {_name(p) for p, _ in flat} == set(grads)
    for path, g in flat:
        np.testing.assert_allclose(grads[_name(path)].numpy(), np.asarray(g),
                                   rtol=TOL, atol=TOL)


def test_published_radial_basis_matches_the_reference():
    """At the published 300 centres over 10 (gamma 900) the centres equal
    jnp.linspace bitwise and the basis matches the reference's."""
    cfg = TR.get_config("schnet")
    for n, cut in ((cfg.n_rbf, cfg.cutoff), (8, 10.0), (50, 7.3), (2, 1.0)):
        np.testing.assert_array_equal(TG.rbf_centres(n, cut).numpy(),
                                      np.asarray(jnp.linspace(0.0, cut, n)))
    d = np.random.default_rng(3).uniform(0, 12, 200).astype(np.float32)
    want = np.asarray(JG.rbf_expand(jnp.asarray(d), cfg.n_rbf, cfg.cutoff))
    got = TG.rbf_expand(torch.from_numpy(d), cfg.n_rbf, cfg.cutoff).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-6)
    np.testing.assert_allclose(TG.cosine_cutoff(torch.from_numpy(d), cfg.cutoff).numpy(),
                               np.asarray(JG.cosine_cutoff(jnp.asarray(d), cfg.cutoff)),
                               rtol=TOL, atol=1e-6)


def test_shifted_softplus_matches_the_reference_past_softplus_threshold():
    x = np.linspace(-40, 40, 161).astype(np.float32)
    np.testing.assert_allclose(TG.ssp(torch.from_numpy(x)).numpy(),
                               np.asarray(JG.ssp(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_edge_mask_zeroes_contributions():
    """With every edge masked the energy is the no-message readout (the
    reference's own test)."""
    cfg = TR.get_config("schnet", smoke=True)
    model = TG.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    at = torch.from_numpy(rng.integers(0, 10, (1, 6)).astype(np.int32))
    pos = torch.from_numpy(rng.normal(size=(1, 6, 3)).astype(np.float32))
    es = torch.from_numpy(rng.integers(0, 6, (1, 12)).astype(np.int32))
    none = torch.zeros((1, 12), dtype=torch.bool)
    e_none = TG.batched_energy(model, {"atom_types": at, "positions": pos, "edge_src": es,
                                       "edge_dst": es.flip(-1), "edge_mask": none})
    z = torch.zeros((1, 12), dtype=torch.int32)
    e_self = TG.batched_energy(model, {"atom_types": at, "positions": pos, "edge_src": z,
                                       "edge_dst": z, "edge_mask": none})
    assert float((e_none - e_self).abs().max()) < 1e-5


def test_sampler_and_graph_equal_the_reference():
    """make_powerlaw_graph, CSRGraph and sample_subgraph give the
    reference's arrays exactly for the same seeds (and its shapes and
    locality: the reference's own test)."""
    ts, td = TS.make_powerlaw_graph(1000, 5000, seed=0)
    js, jd = JS.make_powerlaw_graph(1000, 5000, seed=0)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(td, jd)
    tg, jg = TS.CSRGraph(1000, ts, td), JS.CSRGraph(1000, js, jd)
    np.testing.assert_array_equal(tg.col, jg.col)
    np.testing.assert_array_equal(tg.indptr, jg.indptr)
    for seeds, fan in ((np.arange(16), (5, 3)), (np.array([3, 999, 3, 0]), (15, 10))):
        t = TS.sample_subgraph(tg, seeds, fan, np.random.default_rng(7))
        j = JS.sample_subgraph(jg, seeds, fan, np.random.default_rng(7))
        assert set(t) == set(j)
        for k in t:
            np.testing.assert_array_equal(t[k], j[k])
            assert t[k].dtype == j[k].dtype
    sub = TS.sample_subgraph(tg, np.arange(16), (5, 3), np.random.default_rng(0))
    assert sub["node_ids"].shape == (16 + 80 + 240,)
    assert sub["edge_src"].shape == (80 + 240,)
    assert sub["edge_src"].max() < len(sub["node_ids"]) and sub["edge_dst"].max() < 16 + 80


def test_config_cells_and_init_shapes_equal_the_reference():
    cfg, jcfg = TR.ARCHS["schnet"], JR.ARCHS["schnet"]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(TR.get_config("schnet", True)) == \
        dataclasses.asdict(JR.get_config("schnet", True))
    assert TR.family_of("schnet") == JR.family_of("schnet") == "gnn"
    assert {k: (v.name, v.step, v.dims) for k, v in TR.GNN_SHAPES.items()} == \
        {k: (v.name, v.step, v.dims) for k, v in JR.GNN_SHAPES.items()}
    for graph in ({}, dict(d_feat=1433, n_classes=7)):
        ref = JG.abstract_params(jcfg, **graph)
        flat, _ = jax.tree_util.tree_flatten_with_path(ref)
        port = TG.param_shapes(TG.init_params(cfg, None, "meta", **graph))
        assert port == {_name(p): tuple(a.shape) for p, a in flat}


@pytest.mark.parametrize("shape", ["molecule", "full_graph_sm", "minibatch_lg"])
def test_make_batch_has_the_reference_inputs(shape):
    cfg = TR.get_config("schnet", smoke=True)
    spec = JR.input_specs("schnet", shape)
    gen = torch.Generator().manual_seed(0)
    batch = TR.make_batch(cfg, shape, gen, "cpu", batch=4 if shape == "molecule" else None)
    assert set(batch) == set(spec)
    for k, v in batch.items():
        want = tuple(spec[k].shape)
        if shape == "molecule":
            want = (4,) + want[1:]
        assert tuple(v.shape) == want and str(v.dtype) == "torch." + str(spec[k].dtype)
    n = batch["positions"].reshape(-1, 3).shape[0] if shape != "molecule" else 30
    assert int(batch["edge_src"].max()) < n and int(batch["edge_dst"].min()) >= 0
    with pytest.raises(ValueError, match="multi-card"):
        TR.make_batch(cfg, "ogb_products", gen, "cpu")
