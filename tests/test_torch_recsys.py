"""Port parity for the recsys scoring and retrieval path: configs,
registry, embedding substrate and the four models (Wide&Deep, AutoInt,
DIEN, BERT4Rec) against the JAX package.

Weights are the reference's own init, carried across through numpy
(`recsys_params_from_numpy`); inputs are drawn with numpy, random over
each field's vocabulary (zeros would hide a wrong field offset), and fed
to both packages.  Everything runs in fp32 on the CPU, where Wide&Deep's
wide sum goes through the embedding-bag wrapper's plain version."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.configs import registry as JR
from repro.recsys import embedding as JE
from repro.recsys import models as JM
from repro_torch.configs import base as TB
from repro_torch.configs import registry as TR
from repro_torch.kernels.embedding_bag.ops import bag_sum
from repro_torch.launch import steps as TS
from repro_torch.recsys import embedding as TE
from repro_torch.recsys import models as TM
from repro_torch.recsys.convert import recsys_params_from_numpy

REPO = Path(__file__).resolve().parents[1]
ARCHS = ["wide-deep", "autoint", "dien", "bert4rec"]
# fp32 on both sides: only the order of sums in the matrix products and
# reductions differs (relative ~1e-6 on O(1) outputs).  DIEN carries that
# through 2 x 16 recurrent GRU steps, hence 1e-4.
TOL = {"wide-deep": 1e-5, "autoint": 1e-5, "dien": 1e-4, "bert4rec": 1e-5}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


# ------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference_field_for_field(arch):
    port, ref = TR.get_config(arch), JR.ARCHS[arch]
    assert [f.name for f in dataclasses.fields(TB.RecsysConfig)] == \
        [f.name for f in dataclasses.fields(JB.RecsysConfig)]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.table_rows() == ref.table_rows()
    assert dataclasses.asdict(TR.get_config(arch, smoke=True)) == \
        dataclasses.asdict(JR.get_config(arch, smoke=True))
    assert TR.family_of(arch) == JR.family_of(arch) == "recsys"


def test_registry_cells_equal_the_reference():
    assert sorted(a for a in TR.ARCHS if TR.family_of(a) == "recsys") == \
        sorted(a for a in JR.ASSIGNED if JR.family_of(a) == "recsys")
    assert {k: (v.name, v.step, v.dims) for k, v in TR.RECSYS_SHAPES.items()} == \
        {k: (v.name, v.step, v.dims) for k, v in JR.RECSYS_SHAPES.items()}
    with pytest.raises(TypeError):
        TB.reduced(JR.ARCHS["rcllm-qwen3-8b"])


@pytest.mark.parametrize("arch", ARCHS)
def test_init_shapes_equal_the_reference_at_published_width(arch):
    """The port's parameter tree at full width (built on the meta device,
    no memory) has the reference's leaves and shapes."""
    cfg = TR.get_config(arch)
    ref = JM.abstract_params(JR.ARCHS[arch])
    flat, _ = jax.tree_util.tree_flatten_with_path(ref)
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(a.shape)
            for path, a in flat}
    got = {n: tuple(p.shape) for n, p in TM.init_params(cfg, None, "meta").named_parameters()}
    assert got == want


def test_seeded_init_is_reproducible_at_the_reference_scales():
    cfg = TR.get_config("wide-deep", smoke=True)
    a = TM.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = TM.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    assert abs(float(a.table.std()) - TE.MEGA_TABLE_STD) < 1e-3
    assert abs(float(a.wide_dense.std()) - 0.1) < 0.05
    assert float(a.deep[0].b.abs().max()) == 0.0


# ------------------------------------------------------- registry batches
SERVED_SHAPES = [s for s, v in TR.RECSYS_SHAPES.items() if v.step != "train"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_make_batch_refuses_train_cells(arch, smoke):
    """The training cells' inputs (labels, MLM targets) wait for the
    training slice; make_batch refuses them rather than omit those keys."""
    with pytest.raises(ValueError, match="training slice"):
        TR.make_batch(TR.get_config(arch, smoke), "train_batch", torch.Generator(), "cpu")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SERVED_SHAPES)
@pytest.mark.parametrize("smoke", [False, True])
def test_make_batch_keeps_ids_in_range(arch, shape, smoke):
    """Every cell's inputs have the reference's keys and dtypes, its
    shapes (batch shrunk; at published width, since the reference's specs
    are the published config's), ids in range, and at least one valid
    position per sequence."""
    cfg = TR.get_config(arch, smoke)
    batch = TR.make_batch(cfg, shape, torch.Generator().manual_seed(1), "cpu", batch=64)
    spec = JR.input_specs(arch, shape)
    assert set(batch) == set(spec)
    for k, v in batch.items():
        assert str(v.dtype).replace("torch.", "") == str(spec[k].dtype), k
        want = tuple(64 if i == 0 and k != "candidate_ids" else n
                     for i, n in enumerate(spec[k].shape))
        assert smoke or tuple(v.shape) == want, k
    hi = {"target_item": cfg.n_items, "target_cate": cfg.n_cates, "hist_items": cfg.n_items,
          "hist_cates": cfg.n_cates, "item_seq": cfg.n_items,
          "candidate_ids": TR.retrieval_rows(cfg)}
    for k, v in batch.items():
        if k in hi:
            assert 0 <= int(v.min()) and int(v.max()) < hi[k], k
    if "sparse_ids" in batch:
        ids = batch["sparse_ids"]
        assert (ids >= 0).all() and (ids < torch.tensor(cfg.field_vocabs)).all()
        glob = ids + torch.from_numpy(TE.field_offsets(cfg.field_vocabs))
        assert int(glob.max()) < TE.mega_table_rows(cfg.field_vocabs)
    for k in ("hist_mask", "seq_mask"):
        if k in batch:
            assert batch[k].any(-1).all()
    assert TR.retrieval_rows(cfg) == (
        JE.pad_rows(cfg.n_items) if cfg.kind == "dien" else
        JE.pad_rows(cfg.n_items + 2) if cfg.kind == "bert4rec" else
        JE.mega_table_rows(cfg.field_vocabs))


# ------------------------------------------------------------ embedding
def test_table_layout_equals_the_reference():
    for vocabs in [(10, 20, 30), (1000,) * 7, TR.get_config("wide-deep").field_vocabs]:
        np.testing.assert_array_equal(TE.field_offsets(vocabs), JE.field_offsets(vocabs))
        assert TE.field_offsets(vocabs).dtype == JE.field_offsets(vocabs).dtype
        assert TE.mega_table_rows(vocabs) == JE.mega_table_rows(vocabs)
    for n in (0, 1, 4095, 4096, 4097, 1_000_002):
        assert TE.pad_rows(n) == JE.pad_rows(n)
    assert TE.ROW_PAD == JE.ROW_PAD
    t = TE.init_mega_table(torch.Generator().manual_seed(0), (10, 20), 4)
    assert t.shape == (JE.mega_table_rows((10, 20)), 4) and t.dtype == torch.float32


def test_lookups_equal_the_reference():
    rng = np.random.default_rng(0)
    vocabs = (50, 7, 300)
    table = rng.normal(size=(TE.mega_table_rows(vocabs), 8)).astype(np.float32)
    ids = np.stack([rng.integers(0, v, 16) for v in vocabs], 1).astype(np.int32)
    off = TE.field_offsets(vocabs)
    np.testing.assert_array_equal(
        _np(TE.fielded_lookup(_t(table), _t(ids), _t(off))),
        np.asarray(JE.fielded_lookup(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(off))))
    flat = rng.integers(0, len(table), 40).astype(np.int32)
    np.testing.assert_array_equal(_np(TE.lookup(_t(table), _t(flat))),
                                  np.asarray(JE.lookup(jnp.asarray(table), jnp.asarray(flat))))


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_ragged_embedding_bag_equals_the_reference(mode, weighted):
    """Ragged bags by segment id, bag 3 of 6 empty (max: -inf, as
    jax.ops.segment_max gives; sum and mean: 0)."""
    rng = np.random.default_rng(1)
    table = rng.normal(size=(100, 8)).astype(np.float32)
    ids = rng.integers(0, 100, 30).astype(np.int32)
    seg = np.sort(rng.choice([0, 1, 2, 4, 5], 30)).astype(np.int32)
    w = rng.random(30).astype(np.float32) if weighted else None
    got = TE.embedding_bag(_t(table), _t(ids), _t(seg), 6, mode=mode,
                           weights=None if w is None else _t(w))
    want = JE.embedding_bag(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(seg), 6,
                            mode=mode, weights=None if w is None else jnp.asarray(w))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    empty = _np(got)[3]
    assert (empty == (-np.inf if mode == "max" else 0.0)).all()
    with pytest.raises(ValueError):
        TE.embedding_bag(_t(table), _t(ids), _t(seg), 6, mode="min")


# -------------------------------------------------------------- models
def _np_batch(cfg, B, rng, n_cand=0):
    if cfg.kind in ("wide_deep", "autoint"):
        b = {"dense": rng.normal(size=(B, cfg.n_dense)).astype(np.float32),
             "sparse_ids": np.stack([rng.integers(0, v, B) for v in cfg.field_vocabs],
                                    axis=1).astype(np.int32)}
    else:
        T = cfg.seq_len
        mask = np.arange(T)[None] < rng.integers(1, T + 1, B)[:, None]
        items = rng.integers(0, cfg.n_items, (B, T)).astype(np.int32)
        if cfg.kind == "dien":
            b = {"hist_items": items,
                 "hist_cates": rng.integers(0, cfg.n_cates, (B, T)).astype(np.int32),
                 "hist_mask": mask,
                 "target_item": rng.integers(0, cfg.n_items, B).astype(np.int32),
                 "target_cate": rng.integers(0, cfg.n_cates, B).astype(np.int32)}
        else:
            b = {"item_seq": items, "seq_mask": mask}
    if n_cand:
        b["candidate_ids"] = rng.integers(0, TR.retrieval_rows(cfg), n_cand).astype(np.int32)
    return b


def _pair(arch, seed=0):
    jcfg = JR.get_config(arch, smoke=True)
    params = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = recsys_params_from_numpy(tree, TR.get_config(arch, smoke=True), device="cpu")
    return jcfg, params, model


@pytest.mark.parametrize("arch", ARCHS)
def test_score_user_and_retrieval_match_jax(arch):
    jcfg, params, model = _pair(arch)
    nb = _np_batch(jcfg, 12, np.random.default_rng(5), n_cand=300)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: _t(v) for k, v in nb.items()}
    tol = TOL[arch]
    for name, jf, tf in (("score", JM.score, TS.score_step),
                         ("user_repr", JM.user_repr, TM.user_repr),
                         ("retrieval", JM.retrieval_scores, TS.retrieval_step)):
        got, want = tf(model, tb), np.asarray(jf(params, jb, jcfg))
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape, name
        assert torch.isfinite(got).all(), name
        np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol, err_msg=name)


def test_widedeep_wide_part_through_bag_sum_equals_the_reference():
    jcfg, params, model = _pair("wide-deep", seed=1)
    nb = _np_batch(jcfg, 32, np.random.default_rng(2))
    off = JE.field_offsets(jcfg.field_vocabs)
    want = JE.fielded_lookup(params["wide_table"], jnp.asarray(nb["sparse_ids"]),
                             jnp.asarray(off))[..., 0].sum(-1)
    ids = _t(nb["sparse_ids"]) + model.offsets[None, :]
    assert ids.dtype == torch.int32
    got = bag_sum(model.wide_table, ids)[:, 0]
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_convert_rejects_a_tree_of_another_config():
    jcfg = JR.get_config("autoint", smoke=True)
    tree = jax.tree_util.tree_map(np.asarray, JM.init_params(jax.random.PRNGKey(0), jcfg))
    with pytest.raises(ValueError, match="does not match"):
        recsys_params_from_numpy(tree, dataclasses.replace(TR.get_config("autoint", True),
                                                           n_attn_layers=2), device="cpu")


def test_steps_refuse_the_training_cell():
    with pytest.raises(ValueError, match="training slice"):
        TS.step_of("train_batch")


def test_steps_cli_prints_its_json_line():
    cmd = [sys.executable, "-m", "repro_torch.launch.steps", "--device", "cpu", "--smoke",
           "--arch", "wide-deep", "--shape", "serve_p99"]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    assert rep["arch"] == "wide-deep" and rep["shape"] == "serve_p99"
    assert rep["batch"] == 512 and rep["device"] == "cpu" and rep["finite"]
    assert rep["out_shape"] == [512] and rep["bag_sum_launches"] == 0
    assert rep["ms_per_call"] > 0 and rep["peak_gb"] is None
