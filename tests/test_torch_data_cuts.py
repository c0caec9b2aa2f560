"""The data-axis parameter cuts on a mesh of ranks, held against the
reference's UNSHARDED functions: moonshot and kimi-k2 at reduced() size
in fp32, on gloo ranks at (dp, tp) = (2, 1) and (2, 2).

The reference's `lm_param_specs` cuts an MoE's expert-ff dimension over
the data axis in both modes (w_gate / w_up's last, w_down's middle) and,
in serve mode, the d_model dimension of wq / wk / wv / wo; the port keeps
each rank's block and gathers it where it is used
(`sharding.ctx.gather_data`).

* every rank's parameter blocks, serve and train mode, equal the
  reference's whole parameters cut by the reference's `lm_param_specs`
  (exactly: they are copies), and the rank's expert-ff bytes are 1 / dp of
  what it held whole over the data axis;
* prefill and two greedy decode steps: tokens equal to the reference's
  `transformer.prefill` / `decode_step`, logits within TOL (1e-5);
* two steps of the port's loop (AdamW; Adafactor for kimi-k2; lr 1e-3)
  against two steps of the reference's `train`: losses and gradient norms
  within TOL relative, the whole parameters gathered from the ranks within
  PARAM_TOL (1e-4, `test_torch_tp_lm.py`'s: 5% of what two steps at lr
  1e-3 can move an element);
* the (2, 2) run's checkpoint of step 2 restores at (1, 2), and the third
  step's loss and norm are the reference's third (within TOL).

Each layout's ranks start once, one torch thread each, on a thread while
this process computes the reference (`torch_tp_ranks.data_cut_rank_job`
imports no JAX)."""
import dataclasses
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import registry as JR
from repro.models import transformer as JT
from repro.sharding import specs as JS
from repro.training import train_loop as JTL
from repro_torch.launch import mesh as TMESH

import torch_tp_ranks as RK

TOL, PARAM_TOL = 1e-5, 1e-4
LAYOUTS = RK.DATA_CUT_LAYOUTS
RUNS = RK.DATA_CUT_RUNS


def _jcfg(run):
    return JR.get_config(run, smoke=True)


def _unstack(tree, n):
    return {**{k: v for k, v in tree.items() if k != "layers"},
            "layers": [jax.tree_util.tree_map(lambda a: a[i], tree["layers"])
                       for i in range(n)]}


def _restack(p):
    return {**p, "layers": jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *p["layers"])}


def _names(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)] = \
            np.asarray(leaf)
    return out


def reference(trees):
    """Per run: the reference's prefill, two decode steps and three
    training steps (on batches 0, 1, 1) of the unsharded model."""
    out = {}
    for run in RUNS:
        jcfg = _jcfg(run)
        params = jax.tree_util.tree_map(jnp.asarray, trees[run])
        toks, batches = RK.run_data(run)
        res = {}
        jl, jc = JT.prefill(params, jnp.asarray(toks), jcfg)
        res["prefill"] = np.asarray(jl)
        cache = {k: jnp.asarray(RK.pad(v)) for k, v in jc.items()}
        pos, nxt, steps = np.asarray(RK.POSITIONS, np.int32), jnp.argmax(jl, -1), []
        for _ in range(2):
            jl, cache = JT.decode_step(params, nxt.astype(jnp.int32)[:, None], cache,
                                       jnp.asarray(pos), jcfg)
            nxt, pos = jnp.argmax(jl, -1), pos + 1
            steps.append((np.asarray(jl), np.asarray(nxt)))
        res["decode"] = steps
        tcfg = RK.data_cut_train_cfg(RK.port_config(run), steps=3)
        jtcfg = JTL.TrainConfig(**{**dataclasses.asdict(tcfg), "ckpt_dir": None})
        fn = lambda p, b, c=jcfg: JT.loss_fn(_restack(p), b["tokens"], b["labels"], c)[0]
        fresh = jax.tree_util.tree_map(jnp.array, trees[run])
        data = [jax.tree_util.tree_map(jnp.asarray, b) for b in batches + [batches[1]]]
        jtcfg2 = dataclasses.replace(jtcfg, steps=2)
        got, _, hist = JTL.train(_unstack(fresh, jcfg.n_layers), fn, iter(data[:2]), jtcfg2)
        res["params"] = _names(got)
        fresh = jax.tree_util.tree_map(jnp.array, trees[run])
        _, _, hist3 = JTL.train(_unstack(fresh, jcfg.n_layers), fn, iter(data), jtcfg)
        res["train"] = hist
        res["train3"] = hist3
        out[run] = res
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    init = jax.jit(JT.init_params, static_argnums=1)
    trees = {run: jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0), _jcfg(run)))
             for run in RUNS}
    ckpt = str(tmp_path_factory.mktemp("data_cut_ckpt"))
    box = {}

    def start():
        try:
            box["ranks"] = {layout: TMESH.spawn_ranks(
                RK.data_cut_rank_job, layout[0] * layout[1], "cpu", args=(trees, layout, ckpt))
                for layout in LAYOUTS + ((1, 2),)}
        except BaseException as e:
            box["error"] = e

    th = threading.Thread(target=start)
    th.start()
    try:
        ref = reference(trees)
    finally:
        th.join()
    if "error" in box:
        raise box["error"]
    return trees, ref, box["ranks"]


def by_layout(f):
    f = pytest.mark.parametrize("run", RUNS)(f)
    return pytest.mark.parametrize("layout", LAYOUTS,
                                   ids=[f"dp{d}-tp{t}" for d, t in LAYOUTS])(f)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _rows(a, out, dp):
    n = a.shape[0] // dp
    return a[out["coords"]["data"] * n:(out["coords"]["data"] + 1) * n]


def _ref_block(tree, spec, name, coords, shape):
    """The reference's parameter `name` (a port name) cut by its spec at the
    rank's mesh `coords`."""
    node = tree
    layer = None
    parts = name.split(".")
    if parts[0] == "layers":
        layer, parts = int(parts[1]), ["layers"] + parts[2:]
    for p in parts:
        node, spec = node[p], spec[p]
    a, dims = np.asarray(node), tuple(spec)
    if layer is not None:
        a, dims = a[layer], dims[1:]
    for dim, ax in enumerate(dims):
        if ax is None:
            continue
        n, c = 1, 0
        for axis in ("data", "model"):
            if axis in (ax if isinstance(ax, tuple) else (ax,)):
                n, c = n * shape[axis], c * shape[axis] + coords[axis]
        step = a.shape[dim] // n
        a = np.take(a, range(c * step, (c + 1) * step), axis=dim)
    return a


@by_layout
def test_blocks_are_the_reference_cut_by_its_specs(both, layout, run):
    trees, _, ranks = both
    shape = dict(zip(("data", "model"), layout))
    mesh = SimpleNamespace(shape=shape, axis_names=("data", "model"))
    cfg = _jcfg(run)
    for out in ranks[layout]:
        for mode, blocks in out["runs"][run]["blocks"].items():
            spec = JS.lm_param_specs(cfg, mesh, mode=mode)
            for name, got in blocks.items():
                want = _ref_block(trees[run], spec, name, out["coords"], shape)
                assert got.shape == want.shape and np.array_equal(got, want), (mode, name)
            # expert-ff over the data axis: 1 / dp of the whole-over-data block
            E, D, F = cfg.moe.n_experts // layout[1], cfg.d_model, cfg.moe.d_ff
            for w in ("w_up", "w_gate", "w_down"):
                assert blocks[f"layers.0.moe.{w}"].nbytes * layout[0] == E * D * F * 4
            rows = blocks["layers.0.wq"].shape[0]
            assert rows == (D // layout[0] if mode == "serve" else D)


@by_layout
def test_prefill_and_decode_match_the_unsharded_reference(both, layout, run):
    _, ref, ranks = both
    want = ref[run]
    for out in ranks[layout]:
        got = out["runs"][run]
        assert out["backend"] == "gloo"
        _close(got["prefill"], _rows(want["prefill"], out, layout[0]))
        for (gl, gt), (wl, wt) in zip(got["decode"], want["decode"]):
            _close(gl, _rows(wl, out, layout[0]))
            assert np.array_equal(gt, _rows(wt, out, layout[0]))


@by_layout
def test_two_train_steps_match_the_reference_train(both, layout, run):
    _, ref, ranks = both
    want = ref[run]
    got = ranks[layout][0]["runs"][run]
    for g, w in zip(got["train"], want["train"]):
        assert g["loss"] == pytest.approx(w["loss"], rel=TOL)
        assert g["gnorm"] == pytest.approx(w["gnorm"], rel=TOL)
    assert set(got["params"]) == set(want["params"])
    for name, w in want["params"].items():
        np.testing.assert_allclose(got["params"][name], w, rtol=0, atol=PARAM_TOL,
                                   err_msg=name)
    for out in ranks[layout][1:]:
        assert out["runs"][run]["train"] == got["train"]


@pytest.mark.parametrize("run", RUNS)
def test_a_checkpoint_written_at_dp2_tp2_restores_at_dp1_tp2(both, run):
    _, ref, ranks = both
    w = ref[run]["train3"][2]
    for out in ranks[(1, 2)]:
        (g,) = out["runs"][run]["resumed"]
        assert g["loss"] == pytest.approx(w["loss"], rel=TOL)
        assert g["gnorm"] == pytest.approx(w["gnorm"], rel=TOL)
