"""The LM layouts whose kv heads the model axis does not divide, and the
decode cache split over the sequence, on gloo ranks held against the
reference's UNSHARDED functions: every LM arch of the registry at
reduced() size in fp32 (4 query / 2 kv heads of 16) plus starcoder2 with
a 16-token window.

* (dp, tp) = (1, 4): each rank holds one query head and every kv head's
  4 of 16 Dh columns (the reference's ``P(None, din, None, 'model')``),
  gathers k / v into whole heads before RoPE and keeps the kv head its
  query head reads.  Prefill: the rows' last logits and the rank's block
  of 10 of the 40 cached positions (every kv head) against
  `transformer.prefill`; two greedy decode steps at staggered positions
  in the cache grown by 8 positions (`launch.steps.grow_cache`: blocks of
  12) against `transformer.decode_step`, flash-decoding over the model
  axis (the blocks merged by their log-sum-exp): tokens equal, logits
  within TOL = 1e-5 (atol = rtol); the loss and two training steps
  (AdamW, or Adafactor for kimi-k2) within 1e-5 relative, the whole
  parameters within PARAM_TOL = 1e-4 absolute (as `test_torch_tp_lm.py`
  states why).
* decode at batch 1 on (2, 1) and (2, 2): the data axis does not divide
  the batch, so the cache's 48 positions split over every axis (blocks of
  24 and 12; at (2, 2) the kv heads divide and are gathered too): two
  greedy steps from the reference's prefill cache, and the row's prefill
  on the mesh (blocks of 20 and 10 of its 40 positions, every kv head)
  with two greedy steps in its grown cache, tokens equal and logits
  within TOL.  The split decode rounds the attention weights to
  V's dtype before normalising, which in fp32 moves nothing beyond TOL.

The 4-rank layouts share one world (one spawn); the ranks run on a
thread while this process computes the reference
(`torch_tp_ranks.kv_split_rank_job`, which imports no JAX)."""
import dataclasses
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import transformer as JT
from repro.sharding import specs as JS
from repro.training import train_loop as JTL
from repro_torch.configs import registry as TR
from repro_torch.data.pipeline import rows_of
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import steps as ST
from repro_torch.sharding import specs as SPECS

import torch_tp_ranks as RK

TOL, PARAM_TOL = 1e-5, 1e-4
RUNS = RK.RUNS


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(run):
    arch, replace = RUNS[run]
    return dataclasses.replace(JR.get_config(arch, smoke=True), **replace)


def _unstack(tree, n_layers):
    layers = tree["layers"]
    return {**{k: v for k, v in tree.items() if k != "layers"},
            "layers": [jax.tree_util.tree_map(lambda a: a[i], layers)
                       for i in range(n_layers)]}


def _restack(p):
    return {**p, "layers": jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *p["layers"])}


def _port_names(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)] = \
            np.asarray(leaf)
    return out


def reference_trees():
    init = jax.jit(JT.init_params, static_argnums=1)
    return {arch: jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0), _jcfg(run)))
            for run, (arch, _) in RUNS.items() if not _jcfg(run).sliding_window}


def one_rows(trees):
    """Per run: the reference's prefill cache of row DECODE_ROW alone, its
    first greedy token (the batch-1 decode's input) and its logits."""
    prefill = jax.jit(JT.prefill, static_argnums=2)
    out = {}
    for run, (arch, _) in RUNS.items():
        toks, _ = RK.run_data(run)
        params = jax.tree_util.tree_map(jnp.asarray, trees[arch])
        jl, jc = prefill(params, jnp.asarray(toks[RK.DECODE_ROW:RK.DECODE_ROW + 1]),
                         _jcfg(run))
        out[run] = ({k: np.asarray(v) for k, v in jc.items()},
                    np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int64), np.asarray(jl))
    return out


def reference_outputs(trees, rows):
    """Per run: the unsharded prefill, decode (the batch and the one row,
    whose prefill is `rows[run]`), loss and two training steps."""
    out = {}
    prefill = jax.jit(JT.prefill, static_argnums=2)
    decode = jax.jit(JT.decode_step, static_argnums=4)
    loss_fn = jax.jit(JT.loss_fn, static_argnums=3)
    for run, (arch, _) in RUNS.items():
        jcfg, cfg = _jcfg(run), RK.port_config(run)
        params = jax.tree_util.tree_map(jnp.asarray, trees[arch])
        toks, batches = RK.run_data(run)
        res = {"one_row": rows[run]}
        jl, jc = prefill(params, jnp.asarray(toks), jcfg)
        res["prefill"] = (np.asarray(jl), np.asarray(jc["k"]), np.asarray(jc["v"]))
        for key, cache, pos, nxt in (
                ("decode", {k: jnp.asarray(RK.pad(v)) for k, v in jc.items()},
                 np.asarray(RK.POSITIONS, np.int32), jnp.argmax(jl, -1)),
                ("row", {k: jnp.asarray(RK.pad(v)) for k, v in rows[run][0].items()},
                 np.asarray([toks.shape[1]], np.int32), jnp.asarray(rows[run][1][:, 0]))):
            steps = []
            for _ in range(2):
                lg, cache = decode(params, nxt.astype(jnp.int32)[:, None], cache,
                                   jnp.asarray(pos), jcfg)
                nxt, pos = jnp.argmax(lg, -1), pos + 1
                steps.append((np.asarray(lg), np.asarray(nxt)))
            res[key] = steps
        b0 = batches[0]
        loss, nll = loss_fn(params, jnp.asarray(b0["tokens"]), jnp.asarray(b0["labels"]), jcfg)
        res["loss"] = (float(loss), float(nll))
        tcfg = RK.train_cfgs(run, cfg)[None]
        fn = lambda p, b, c=jcfg: JT.loss_fn(_restack(p), b["tokens"], b["labels"], c)[0]
        fresh = jax.tree_util.tree_map(jnp.array, trees[arch])
        got, _, hist = JTL.train(_unstack(fresh, jcfg.n_layers), fn,
                                 iter([jax.tree_util.tree_map(jnp.asarray, b) for b in batches]),
                                 JTL.TrainConfig(**dataclasses.asdict(tcfg)))
        res["train"] = {"hist": hist, "params": _port_names(got)}
        out[run] = res
    return out


@pytest.fixture(scope="module")
def both():
    trees = reference_trees()
    rows = one_rows(trees)
    box = {}

    def start():
        try:
            box["four"] = TMESH.spawn_ranks(RK.kv_split_rank_job, 4, "cpu",
                                            args=(trees, rows, RK.KV_LAYOUTS_4))
            box["two"] = TMESH.spawn_ranks(RK.kv_split_rank_job, 2, "cpu",
                                           args=(trees, rows, ((2, 1),)))
        except BaseException as e:          # raised below, in the test's thread
            box["error"] = e

    th = threading.Thread(target=start)
    th.start()
    try:
        ref = reference_outputs(trees, rows)
    finally:
        th.join()
    if "error" in box:
        raise box["error"]
    return ref, {**{lay: [r["layouts"][lay] for r in box["four"]] for lay in RK.KV_LAYOUTS_4},
                 (2, 1): [r["layouts"][(2, 1)] for r in box["two"]]}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("run", list(RUNS))
def test_dh_cut_prefill_and_split_decode_match_the_unsharded_reference(both, run):
    """(1, 4): logits, each rank's block of cached positions (every kv
    head whole), greedy tokens."""
    ref, ranks = both
    want = ref[run]
    for out in ranks[(1, 4)]:
        got = out["runs"][run]
        m = out["coords"]["model"]
        _close(got["prefill"][0], want["prefill"][0])
        for i in (1, 2):
            assert got["prefill"][i].shape[3] == TR.get_config(RUNS[run][0], True).n_kv_heads
            _close(got["prefill"][i], np.moveaxis(rows_of(np.moveaxis(want["prefill"][i], 2, 0),
                                                          m, 4), 0, 2))
        for (gl, gt), (wl, wt) in zip(got["decode"], want["decode"]):
            _close(gl, wl)
            assert np.array_equal(gt, wt)


@pytest.mark.parametrize("run", list(RUNS))
def test_dh_cut_loss_and_training_match_the_reference(both, run):
    """(1, 4): the loss, two training steps' losses and norms, and the
    whole parameters after them (K6's plain version on the rank's query
    head against its gathered kv head)."""
    ref, ranks = both
    want = ref[run]
    outs = ranks[(1, 4)]
    for out in outs:
        assert out["runs"][run]["loss"] == pytest.approx(want["loss"], rel=TOL)
    got = outs[0]["runs"][run]["train"]
    for g, w in zip(got["hist"], want["train"]["hist"]):
        assert g["loss"] == pytest.approx(w["loss"], rel=TOL)
        assert g["gnorm"] == pytest.approx(w["gnorm"], rel=TOL)
    assert set(got["params"]) == set(want["train"]["params"])
    for name, w in want["train"]["params"].items():
        np.testing.assert_allclose(got["params"][name], w, rtol=0, atol=PARAM_TOL, err_msg=name)
    for out in outs[1:]:
        assert out["runs"][run]["train"]["hist"] == got["hist"]


@pytest.mark.parametrize("layout", [(2, 1), (2, 2)], ids=["dp2-tp1", "dp2-tp2"])
@pytest.mark.parametrize("run", list(RUNS))
def test_one_row_decode_over_every_axis_matches_the_reference(both, run, layout):
    ref, ranks = both
    for out in ranks[layout]:
        got = out["runs"][run]
        n = layout[0] * layout[1]
        assert got["block"][2] == (RK.S_PROMPT + RK.EXTRA) // n
        assert got["block"][3] == TR.get_config(RUNS[run][0], True).n_kv_heads
        for (gl, gt), (wl, wt) in zip(got["decode"], ref[run]["row"]):
            _close(gl, wl)
            assert np.array_equal(gt, wt)


@pytest.mark.parametrize("layout", [(2, 1), (2, 2)], ids=["dp2-tp1", "dp2-tp2"])
@pytest.mark.parametrize("run", list(RUNS))
def test_one_row_prefill_then_decode_over_every_axis_matches_the_reference(both, run,
                                                                          layout):
    """The batch-1 prefill on the mesh: the row's logits, each rank's block
    of the 40 prompt positions counted over every axis (blocks of 20 and
    10) with every kv head (at (2, 2) the shard's heads gathered), then
    two greedy steps in that cache grown by `grow_cache`, against the
    reference's prefill and decode of the row: tokens equal, logits within
    TOL."""
    ref, ranks = both
    jc, _, jl = ref[run]["one_row"]
    n = layout[0] * layout[1]
    for out in ranks[layout]:
        got = out["runs"][run]
        c = out["coords"]["data"] * layout[1] + out["coords"]["model"]
        step = RK.S_PROMPT // n
        _close(got["prefill"][0], jl)
        for i, name in ((1, "k"), (2, "v")):
            _close(got["prefill"][i], jc[name][:, :, c * step:(c + 1) * step])
        for (gl, gt), (wl, wt) in zip(got["prefilled"], ref[run]["row"]):
            _close(gl, wl)
            assert np.array_equal(gt, wt)


def _stub(shape):
    return SimpleNamespace(shape=dict(zip(("data", "model"), shape)),
                           axis_names=("data", "model"))


def test_the_cache_specs_split_the_sequence_as_the_reference():
    """Where the port splits a cache's sequence is the reference's
    `lm_cache_spec`, and `cut_input` cuts it over every axis in mesh
    order."""
    cfg, jcfg = TR.get_config("gemma-7b", True), JR.get_config("gemma-7b", True)
    for shape, batch in (((1, 4), 4), ((2, 2), 1), ((2, 1), 1), ((1, 2), 4), ((2, 2), 4)):
        got = SPECS.lm_cache_spec(cfg, _stub(shape), batch, 48)["k"]
        want = JS.lm_cache_spec(jcfg, _stub(shape), batch, 48)["k"]
        assert tuple(got) == tuple(want)
    x = torch.arange(48).reshape(1, 1, 48, 1, 1)
    mesh = SimpleNamespace(shape={"data": 2, "model": 2}, axis_names=("data", "model"),
                           coords={"data": 1, "model": 0})
    block = ST.cut_input(x, SPECS.lm_cache_spec(cfg, mesh, 1, 48)["k"], mesh)
    assert block.flatten().tolist() == list(range(24, 36))


@pytest.mark.parametrize("tp,arch,msg", [
    (3, "starcoder2-15b", "must divide n_heads"),
    (8, "gemma-7b", "head_dim"),
    (4, "rcllm-qwen3-8b", "GQA group"),
])
def test_layouts_that_cannot_run_are_refused_by_name(tp, arch, msg):
    """Only what cannot run is refused: query heads tp does not divide, a
    Dh it does not divide.  starcoder2 at tp = 8 (4 kv heads, 6 query
    heads a rank in groups of 12) runs."""
    import dataclasses as dc
    cfg = TR.get_config(arch, True)
    if arch == "gemma-7b":
        cfg = dc.replace(cfg, n_heads=8, n_kv_heads=1, head_dim=4)
    if arch == "rcllm-qwen3-8b":                      # 6 query heads a rank, groups of 4
        cfg = dc.replace(cfg, n_heads=24, n_kv_heads=6)
    with pytest.raises(ValueError, match=msg):
        SPECS._check_shardable(cfg, _stub((1, tp)))
    SPECS._check_shardable(TR.ARCHS["starcoder2-15b"], _stub((1, 8)))
    with pytest.raises(ValueError, match="n_kv_heads"):
        SPECS.check_serving_divisibility(TR.ARCHS["starcoder2-15b"], _stub((1, 8)))
