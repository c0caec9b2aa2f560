"""The dry run (`launch.dryrun`) and the roofline tools of the port
(`launch.roofline.roofline_terms`, `launch.roofline_report`).

* Every cell of the registry at (16, 16) and (2, 16, 16): the rank's
  parameter, optimizer-state and input bytes, as the port builds its
  bundle on fake tensors, equal integer for integer the sum of shard
  sizes that the reference's specs give on `jax.eval_shape` of its
  parameters and `input_specs` (`lm_param_specs`, `lm_opt_state_specs`,
  `lm_input_specs`; `recsys_param_specs`, `zero_shard`,
  `recsys_input_specs`; `gnn_param_specs`, `gnn_input_specs`).  No XLA
  compile: this pins the data-axis cuts at the size they exist for.  Two
  rules differ on purpose, and the reference side here applies the
  port's: Adafactor (kimi-k2's train cell) keeps per-layer state, as the
  port's layers are separate tensors (ROADMAP C, PR 27 (3)), so the
  reference's rule is applied to its per-layer tree; and SchNet's
  ogb_products edges, which 256 or 512 ranks do not divide, are padded
  and cut before the step (`steps.gnn_inputs`), where the reference's
  argument replicates them and its step pads and re-shards inside.
* A traced dense cell, gemma-7b decode_32k at (16, 16), counts
  `lm_analytic`'s FLOPs per device within 1e-9 relative: its kv heads
  divide over the model axis, so its products are the closed form's
  (projections, scores over every cached key, MLP, head); cells whose kv
  heads tp does not divide multiply through a block-diagonal query
  matrix, and prefill skips the causal band's dead tiles, so those differ
  from the closed form by design.
* K6 under the dry run records its bound's FLOPs and launches nothing.
* `roofline_terms`, the collective counter and the pod mesh's data-axes
  group on a small fake world; a failing cell's record; the report."""
import json
import math
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as JR
from repro.gnn import schnet as JG
from repro.models import transformer as JT
from repro.recsys import models as JRM
from repro.sharding import specs as JS
from repro.training import optimizer as JO
from repro_torch.configs import registry as TR
from repro_torch.kernels.flash_attention.ops import mha_flash_bwd
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import roofline as TRF
from repro_torch.launch import roofline_report as RR
from repro_torch.launch.roofline_analytic import lm_analytic
from repro_torch.sharding import ctx as CTX

MESHES = {"pod": (16, 16), "multipod": (2, 16, 16)}


def _mesh(shape):
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return SimpleNamespace(shape=dict(zip(names, shape)), axis_names=names)


def _shard_bytes(spec, sds, mesh) -> int:
    n = 1
    dims = tuple(spec) + (None,) * (len(sds.shape) - len(spec))
    for size, ax in zip(sds.shape, dims):
        k = 1
        for a in (() if ax is None else ax if isinstance(ax, tuple) else (ax,)):
            k *= mesh.shape[a]
        n *= -(-size // k)
    return n * np.dtype(sds.dtype).itemsize


def _bytes(specs, abstract, mesh) -> int:
    leaves = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda s, a: _shard_bytes(s, a, mesh), specs, abstract,
        is_leaf=lambda x: isinstance(x, JP)))
    return int(sum(leaves))


def _unstack_abstract(tree, L):
    return {**{k: v for k, v in tree.items() if k != "layers"},
            "layers": [jax.tree_util.tree_map(
                lambda a: jax.ShapeDtypeStruct(a.shape[1:], a.dtype), tree["layers"])] * L}


def _drop_layer_axis(spec_tree):
    return jax.tree_util.tree_map(lambda s: JP(*tuple(s)[1:]), spec_tree,
                                  is_leaf=lambda x: isinstance(x, JP))


def reference_lm(arch, shape, mesh):
    cfg, spec = JR.ARCHS[arch], JR.LM_SHAPES[shape]
    mode = "train" if spec.step == "train" else "serve"
    abstract = jax.eval_shape(lambda k: JT.init_params(k, cfg), jax.random.PRNGKey(0))
    pspecs = JS.lm_param_specs(cfg, mesh, mode=mode)
    out = {"params": _bytes(pspecs, abstract, mesh), "opt_state": 0}
    if spec.step == "train":
        if cfg.optimizer == "adafactor":        # per-layer state (the module docstring)
            abstract = _unstack_abstract(abstract, cfg.n_layers)
            pspecs = {**pspecs, "layers": [_drop_layer_axis(pspecs["layers"])] * cfg.n_layers}
        opt = JO.abstract_opt_state(JO.get(cfg.optimizer)[0], abstract)
        ospecs = JS.lm_opt_state_specs(opt, pspecs, abstract, mesh)
        out["opt_state"] = _bytes(ospecs.inner, opt.inner, mesh)
    inputs = JR.input_specs(arch, shape)
    out["inputs"] = _bytes(JS.lm_input_specs(cfg, mesh, spec.step, spec.dims), inputs, mesh)
    return out


def reference_other(arch, shape, mesh):
    cfg = JR.ARCHS[arch]
    spec = JR.shapes_of(arch)[shape]
    inputs = JR.input_specs(arch, shape)
    if JR.family_of(arch) == "recsys":
        abstract = JRM.abstract_params(cfg)
        pspecs = JS.recsys_param_specs(cfg, mesh)
        ispecs = JS.recsys_input_specs(cfg, mesh, spec.step, spec.dims)
        ospecs = JS.zero_shard(pspecs, abstract, mesh)
        train = spec.step == "train"
    else:
        d = spec.dims
        abstract = (JG.abstract_params(cfg) if shape == "molecule" else
                    JG.abstract_params(cfg, d_feat=d["d_feat"], n_classes=d["n_classes"]))
        pspecs = ospecs = JS.gnn_param_specs(abstract, mesh)
        ispecs = JS.gnn_input_specs(mesh, shape, inputs)
        train = True
        esz = math.prod(mesh.shape.values())
        e = inputs["edge_src"].shape[0]
        if len(inputs["edge_src"].shape) == 1 and e % esz and e > 1_000_000:
            # the port's padding (the module docstring): edges and their
            # mask padded to a multiple of the ranks, then cut over them
            padded = jax.ShapeDtypeStruct((-(-e // esz) * esz,), inputs["edge_src"].dtype)
            inputs = {**inputs, "edge_src": padded, "edge_dst": padded,
                      "edge_mask": jax.ShapeDtypeStruct(padded.shape, np.bool_)}
            every = tuple(mesh.axis_names)
            ispecs = {**ispecs, "edge_src": JP(every), "edge_dst": JP(every),
                      "edge_mask": JP(every)}
    opt = 2 * _bytes(ospecs, jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, np.float32), abstract), mesh) if train else 0
    return {"params": _bytes(pspecs, abstract, mesh), "opt_state": opt,
            "inputs": _bytes(ispecs, inputs, mesh)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cells_are_the_reference_cells():
    assert list(TR.cells()) == list(JR.cells())
    assert len(list(TR.cells())) == 40


@pytest.mark.parametrize("arch,shape", list(TR.cells()))
def test_input_specs_equal_the_reference(arch, shape):
    got, want = TR.input_specs(arch, shape), JR.input_specs(arch, shape)
    flat = lambda t: {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                      for k, v in jax.tree_util.tree_flatten_with_path(
                          t, is_leaf=lambda x: hasattr(x, "dtype"))[0]}
    assert {str(k): v for k, v in flat(got).items()} == \
        {str(k): v for k, v in flat(want).items()}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,shape", list(TR.cells()))
def test_argument_bytes_equal_the_reference_specs(arch, shape, mesh_name):
    shape_ = MESHES[mesh_name]
    mesh = _mesh(shape_)
    got = D.argument_bytes(arch, shape, shape_)
    want = (reference_lm if JR.family_of(arch) == "lm" else reference_other)(arch, shape, mesh)
    assert got == want


def test_a_traced_dense_cell_counts_the_closed_form_flops():
    rec = D.trace_cell("gemma-7b", "decode_32k", MESHES["pod"])
    want = lm_analytic(TR.ARCHS["gemma-7b"], "decode", TR.LM_SHAPES["decode_32k"].dims,
                       n_chips=256, data_par=16)["flops_per_device"]
    assert rec["flops_per_device"] == pytest.approx(want, rel=1e-9)
    assert rec["memory"]["argument_size"] == sum(rec["memory"]["argument_parts"].values())
    assert 0 < rec["memory"]["temp_size"] < rec["memory"]["argument_size"]
    assert rec["collectives"]["counts"]["all-reduce"] > 0
    assert rec["n_chips"] == 256 and rec["kernels"] == {}


def test_k6_under_the_dry_run_records_its_bound_and_launches_nothing():
    before = mha_flash_bwd.launches
    rec = D.trace_cell("gemma-7b", "train_4k", MESHES["pod"], layers=1)
    S, B, D_ = 4096, 256 // 16, 256
    k6 = rec["kernels"]["flash_bwd"]
    assert k6["calls"] == 1
    assert k6["flops"] == 10 * D_ * (S * (S + 1) // 2) * B * 1      # one head a rank
    assert mha_flash_bwd.launches == before
    assert rec["cuts"] == {"n_layers": 1}


def test_collectives_are_counted_with_the_wire_multipliers():
    with TMESH.fake_world(16):
        mesh = TMESH.make_production_mesh(shape=(2, 2, 4))
        assert set(mesh.groups) == {"pod", "data", "model", ("pod", "data")}
        with CTX.axes(mesh), CTX.count_collectives() as c:
            assert CTX.dp_size() == 4 and CTX.dp_rank() == 0 and CTX.tp_size() == 4
            x = torch.ones(10, 6)
            CTX.all_reduce(x)                                   # 240 B x 2
            y = CTX.gather_data(x, 1)                           # 4 x 240 B
            assert y.shape == (10, 24)
            CTX.broadcast_(x, "data", 0)
            CTX.decide(1)
        assert c["per_op_bytes"]["all-reduce"] == 480 and c["counts"]["all-reduce"] == 1
        assert c["per_op_bytes"]["all-gather"] == 960 and c["counts"]["all-gather"] == 1
        assert c["total_bytes"] == 1440
        assert c["other"] == {"broadcast": {"bytes": 240, "count": 1}, "object": {"count": 1}}
    assert CTX._COUNTS is None
    rec = {"flops_per_device": 989e12, "bytes_per_device": 3.35e12 * 2,
           "collectives": {"total_bytes": 900e9 * 0.5}}
    t = TRF.roofline_terms(rec)
    assert t["compute_s"] == pytest.approx(1.0) and t["memory_s"] == pytest.approx(2.0)
    assert t["collective_s"] == pytest.approx(0.5)
    assert t["bottleneck"] == "memory"
    assert t["roofline_fraction_of_dominant"] == pytest.approx(0.5)


def test_run_cell_records_a_failure_and_the_report_renders(tmp_path, monkeypatch):
    rec = D.run_cell("wide-deep", "serve_p99", False, str(tmp_path))
    assert rec["ok"] and rec["kernels"]["bag_sum"]["calls"] == 1
    assert rec["roofline"]["is"] == "modelled at H100 SXM peaks"
    D.run_cell("gemma-7b", "decode_32k", False, str(tmp_path))

    def boom(*a, **k):
        raise RuntimeError("planted")
    monkeypatch.setattr(D, "trace_cell", boom)
    bad = D.run_cell("autoint", "serve_p99", False, str(tmp_path))
    assert not bad["ok"] and bad["error"] == "RuntimeError: planted" and bad["traceback"]
    with open(tmp_path / "autoint__serve_p99__pod_16x16.json") as f:
        assert json.load(f)["ok"] is False
    rows = RR.build_rows(str(tmp_path))
    assert [(r["arch"], r["src"]) for r in rows] == [("gemma-7b", "analytic"),
                                                     ("wide-deep", "traced")]
    table = RR.markdown(rows)
    assert table.count("\n") == 3 and "| gemma-7b | decode_32k | analytic |" in table
    assert "—" in table.splitlines()[-1]                   # no useful MF for recsys
