"""The LM archs' steps on a mesh of ranks, held against the reference's
UNSHARDED functions: every LM arch of the registry at reduced() size in
fp32, plus starcoder2 with a 16-token window (reduced() has none), on
gloo ranks at (dp, tp) = (1, 2), (2, 1) and (2, 2), and in this process on
an explicit (1, 1) mesh.

* prefill: the rows' last logits and the (L, B, S, Hkv, Dh) cache
  against `transformer.prefill` (each rank holds its rows and kv heads;
  atol = rtol = 1e-5, TOL);
* decode: two greedy steps at staggered positions against
  `transformer.decode_step`: tokens equal, logits within TOL;
* `loss_fn`: loss and nll (their mean over the data axis) within 1e-5
  relative;
* training: two steps of the port's loop (`train_loop.train` with the
  rank's `train_layout`, on the rank's rows of each batch) against two
  steps of the reference's `train`: AdamW, or Adafactor for kimi-k2, lr
  1e-3; the losses and gradient norms of both steps within 1e-5
  relative, the whole parameters gathered from the ranks within 1e-4
  absolute (PARAM_TOL: 5% of the 2e-3 that two steps at lr 1e-3 can move
  an element; AdamW's m / (sqrt(v) + 1e-8) turns the summation-order
  noise of a gradient near 1e-8 into a visible share of a step, as the
  unsharded port's own training tests note).  The reference trains the per-layer tree (its layers
  unstacked, restacked inside the loss): the function is the same, and
  Adafactor then factors and RMS-clips each layer's tensor as the port's
  per-layer parameters do.  One arch (rcllm-qwen3-8b) also trains with
  int8 and top-k (30%) compression; the gradient norm is that of the
  compressed gradients;
* an MoE batch that drops routes (capacity factor 0.5) at (2, 2): each
  rank's kept flags, kept slots, aux term and output rows equal the
  reference's whole-batch `moe_apply` (slots and flags exactly, the rest
  within TOL);
* tp = 1 on an explicit (1, 1) mesh is bitwise the unsharded path;
* `lm_opt_state_specs` equals the reference's spec data (AdamW,
  Adafactor; SGD has no state, where the reference's rule raises).

Each layout's ranks start once, one torch thread each, on a thread of a
module fixture while this process computes the reference
(`torch_tp_ranks.lm_rank_job`, which imports no JAX, is what they run).
The distributed-training example runs there too: two steps at (2, 2)
with int8 compression, then a resume at (1, 2) from its checkpoint."""
import dataclasses
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as JR
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.sharding import specs as JS
from repro.training import optimizer as JO
from repro.training import train_loop as JTL
from repro_torch.configs import registry as TR
from repro_torch.data.pipeline import rows_of
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.api import MeshConfig
from repro_torch.sharding import ctx as CTX
from repro_torch.sharding import specs as SPECS
from repro_torch.training import optimizer as TO
from repro_torch.training import train_loop as TTL

import torch_tp_ranks as RK

TOL, PARAM_TOL = 1e-5, 1e-4
LAYOUTS = [(1, 2), (2, 1), (2, 2)]
RUNS, DROP = RK.RUNS, RK.DROP


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(run):
    arch, replace = RUNS[run]
    return dataclasses.replace(JR.get_config(arch, smoke=True), **replace), RK.port_config(run)


# ------------------------------------------------------------- fixtures
def _unstack(tree, n_layers):
    layers = tree["layers"]
    return {**{k: v for k, v in tree.items() if k != "layers"},
            "layers": [jax.tree_util.tree_map(lambda a: a[i], layers)
                       for i in range(n_layers)]}


def _restack(p):
    return {**p, "layers": jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *p["layers"])}


def _port_names(tree):
    """A per-layer reference tree -> {port parameter name: numpy}."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)] = \
            np.asarray(leaf)
    return out


def reference_trees():
    """Per arch, the reference's init (numpy, layers stacked)."""
    init = jax.jit(JT.init_params, static_argnums=1)
    return {arch: jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0),
                                                          _configs(run)[0]))
            for run, (arch, _) in RUNS.items() if not _configs(run)[0].sliding_window}


EXAMPLE_ARGS = ["--arch", "moonshot-v1-16b-a3b", "--smoke", "--batch", "4", "--seq", "16",
                "--device", "cpu", "--compression", "int8"]


def _example():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "torch_train_lm_distributed.py"
    spec = importlib.util.spec_from_file_location("torch_train_lm_distributed", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example_mesh_runs(ckpt):
    """The distributed-training example on gloo ranks: two steps at
    (dp, tp) = (2, 2) writing checkpoints to `ckpt`, then at (1, 2) on to
    step 3 from the checkpoint of step 2."""
    ex = _example()
    first = ex.main(EXAMPLE_ARGS + ["--steps", "2", "--ckpt", ckpt,
                                    "--config", "mesh.tp=2,mesh.dp=2"])
    resumed = ex.main(EXAMPLE_ARGS + ["--steps", "3", "--ckpt", ckpt, "--config", "mesh.tp=2"])
    return first, resumed


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The reference's outputs and every layout's ranks' records: the
    ranks start (each layout once, in turn, then the distributed-training
    example's) on a thread while this process computes the reference."""
    trees = reference_trees()
    box = {}
    ckpt = str(tmp_path_factory.mktemp("mesh_ckpt"))

    def start():
        try:
            box["ranks"] = {layout: TMESH.spawn_ranks(
                RK.lm_rank_job, layout[0] * layout[1], "cpu", args=(trees, layout))
                for layout in LAYOUTS}
            box["example"] = _example_mesh_runs(ckpt)
        except BaseException as e:          # raised below, in the test's thread
            box["error"] = e

    th = threading.Thread(target=start)
    th.start()
    try:
        ref = reference_outputs(trees)
    finally:
        th.join()
    if "error" in box:
        raise box["error"]
    return (trees, ref), box["ranks"], (box["example"], ckpt)


@pytest.fixture(scope="module")
def reference(both):
    return both[0]


@pytest.fixture(scope="module")
def all_ranks(both):
    return both[1]


def reference_outputs(trees):
    """Per run: the reference's unsharded prefill, decode, loss and two
    training steps on `trees`."""
    out = {}
    prefill = jax.jit(JT.prefill, static_argnums=2)
    decode = jax.jit(JT.decode_step, static_argnums=4)
    loss_fn = jax.jit(JT.loss_fn, static_argnums=3)
    for run in RUNS:
        jcfg, cfg = _configs(run)
        arch = RUNS[run][0]
        params = jax.tree_util.tree_map(jnp.asarray, trees[arch])
        toks, batches = RK.run_data(run)
        res = {}
        jl, jc = prefill(params, jnp.asarray(toks), jcfg)
        res["prefill"] = (np.asarray(jl), np.asarray(jc["k"]), np.asarray(jc["v"]))
        cache = {k: jnp.asarray(RK.pad(v)) for k, v in jc.items()}
        pos, nxt, steps = np.asarray(RK.POSITIONS, np.int32), jnp.argmax(jl, -1), []
        for _ in range(2):
            jl, cache = decode(params, nxt.astype(jnp.int32)[:, None], cache,
                               jnp.asarray(pos), jcfg)
            nxt, pos = jnp.argmax(jl, -1), pos + 1
            steps.append((np.asarray(jl), np.asarray(nxt)))
        res["decode"] = steps
        b0 = batches[0]
        loss, nll = loss_fn(params, jnp.asarray(b0["tokens"]), jnp.asarray(b0["labels"]), jcfg)
        res["loss"] = (float(loss), float(nll))
        res["train"] = {}
        for comp, tcfg in RK.train_cfgs(run, cfg).items():
            jtcfg = JTL.TrainConfig(**dataclasses.asdict(tcfg))
            fn = lambda p, b, c=jcfg: JT.loss_fn(_restack(p), b["tokens"], b["labels"], c)[0]
            fresh = jax.tree_util.tree_map(jnp.array, trees[arch])   # train donates them
            got, _, hist = JTL.train(_unstack(fresh, jcfg.n_layers), fn,
                                     iter([jax.tree_util.tree_map(jnp.asarray, b)
                                           for b in batches]), jtcfg)
            res["train"][comp] = {"hist": hist, "params": _port_names(got)}
        out[run] = res
    return out


def by_layout(f):
    return pytest.mark.parametrize("layout", LAYOUTS, ids=[f"dp{d}-tp{t}" for d, t in LAYOUTS])(f)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _block(a, rank_out, layout, row_axis, head_axis=None):
    """The reference array's block that `rank_out`'s rank holds."""
    dp, tp = layout
    a = rows_of(np.moveaxis(a, row_axis, 0), rank_out["coords"]["data"], dp)
    a = np.moveaxis(a, 0, row_axis)
    if head_axis is not None:
        a = np.moveaxis(rows_of(np.moveaxis(a, head_axis, 0), rank_out["coords"]["model"],
                                tp), 0, head_axis)
    return a


# ---------------------------------------------------------------- tests
@by_layout
@pytest.mark.parametrize("run", list(RUNS))
def test_prefill_and_decode_match_the_unsharded_reference(reference, all_ranks, layout, run):
    outs = all_ranks[layout]
    want = reference[1][run]
    for out in outs:
        assert out["backend"] == "gloo"
        got = out["runs"][run]
        _close(got["prefill"][0], _block(want["prefill"][0], out, layout, 0))
        for i in (1, 2):
            _close(got["prefill"][i], _block(want["prefill"][i], out, layout, 1, 3))
        for (gl, gt), (wl, wt) in zip(got["decode"], want["decode"]):
            _close(gl, _block(wl, out, layout, 0))
            assert np.array_equal(gt, _block(wt, out, layout, 0))


@by_layout
@pytest.mark.parametrize("run", list(RUNS))
def test_loss_matches_the_unsharded_reference(reference, all_ranks, layout, run):
    outs = all_ranks[layout]
    for out in outs:
        got, want = out["runs"][run]["loss"], reference[1][run]["loss"]
        assert got == pytest.approx(want, rel=TOL)
    if TR.get_config(RUNS[run][0], smoke=True).moe is not None:
        assert want[0] != pytest.approx(want[1], rel=1e-7)           # the aux term


@by_layout
@pytest.mark.parametrize("run", list(RUNS))
def test_two_train_steps_match_the_reference_train(reference, all_ranks, layout, run):
    """Loss and global norm of both steps, and the whole parameters after
    them, against the reference's `train`; every rank reports the same
    history."""
    outs = all_ranks[layout]
    for comp, want in reference[1][run]["train"].items():
        got = outs[0]["runs"][run]["train"][comp]
        for g, w in zip(got["hist"], want["hist"]):
            assert g["loss"] == pytest.approx(w["loss"], rel=TOL), comp
            assert g["gnorm"] == pytest.approx(w["gnorm"], rel=TOL), comp
        assert set(got["params"]) == set(want["params"])
        for name, w in want["params"].items():
            np.testing.assert_allclose(got["params"][name], w, rtol=0, atol=PARAM_TOL,
                                       err_msg=f"{comp} {name}")
        for out in outs[1:]:
            assert out["runs"][run]["train"][comp]["hist"] == got["hist"]


def test_moe_drops_keep_the_reference_slots(reference, all_ranks):
    """At (2, 2) with capacity factor 0.5: every rank's kept flags and
    kept slots (its local slot + the earlier data ranks' routes) are the
    reference's whole-batch routing, its aux term and output rows too."""
    layout = (2, 2)
    outs = all_ranks[layout]
    trees = reference[0]
    _, cfg = _configs("moonshot-v1-16b-a3b")
    x, moe = RK.moe_drop_inputs(trees["moonshot-v1-16b-a3b"], cfg)
    seen = {}
    dispatch = JL.moe_dispatch

    def tap(x, slot_tok, slot_valid, dest_tk, keep_tk):
        seen.update(slot_tok=np.asarray(slot_tok), slot_valid=np.asarray(slot_valid),
                    dest_tk=np.asarray(dest_tk), keep_tk=np.asarray(keep_tk))
        return dispatch(x, slot_tok, slot_valid, dest_tk, keep_tk)

    JL.moe_dispatch = tap
    try:
        y, aux = JL.moe_apply(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, moe),
                              n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
                              capacity_factor=DROP["capacity_factor"], mlp_type=cfg.mlp_type)
    finally:
        JL.moe_dispatch = dispatch
    assert not seen["keep_tk"].all()                          # the batch drops routes
    T_loc = DROP["T"] // layout[0]
    slots = {}
    for out in outs:
        r, d = out["drop"], out["coords"]["data"]
        rows = slice(d * T_loc, (d + 1) * T_loc)
        assert r["C"] == seen["slot_tok"].shape[1]
        assert np.array_equal(r["keep_tk"], seen["keep_tk"][rows])
        e = r["expert_idx"]
        glob = r["dest_tk"] + r["base"][e]
        assert np.array_equal(np.where(r["keep_tk"], glob, -1),
                              np.where(seen["keep_tk"][rows], seen["dest_tk"][rows], -1))
        for ei, c in zip(*np.nonzero(r["slot_valid"])):
            slots[(ei, r["base"][ei] + c)] = r["slot_tok"][ei, c] + d * T_loc
        assert r["aux"] == pytest.approx(float(aux), rel=TOL)
        assert out["drop"]["aux_apply"] == pytest.approx(float(aux), rel=TOL)
        _close(out["drop"]["y"], np.asarray(y)[rows])
    want = {(e, c): t for (e, c), t in np.ndenumerate(seen["slot_tok"])
            if seen["slot_valid"][e, c]}
    assert slots == want


def test_tp1_mesh_is_bitwise_the_unsharded_path(reference):
    """Every step of one dense and one MoE run (Adafactor for kimi-k2) on
    an explicit (1, 1) mesh: bitwise the port's unsharded functions."""
    trees = reference[0]
    mesh = MeshConfig(mesh_shape=(1, 1)).build()
    for run in ("gemma-7b", "kimi-k2-1t-a32b"):
        with CTX.axes(mesh):
            meshed = RK.rank_run(run, trees[RUNS[run][0]], mesh)
        _, cfg = _configs(run)
        toks, batches = RK.run_data(run)
        whole = params_from_numpy(trees[RUNS[run][0]], cfg, device="cpu")
        logits, cache = TT.prefill(whole, torch.from_numpy(toks))
        assert np.array_equal(meshed["prefill"][0], logits.numpy())
        assert np.array_equal(meshed["prefill"][1], cache["k"].numpy())
        cache = {k: torch.from_numpy(RK.pad(v)) for k, v in cache.items()}
        pos, nxt = torch.tensor(RK.POSITIONS), logits.argmax(-1)[:, None]
        for got in meshed["decode"]:
            logits, cache = TT.decode_step(whole, nxt, cache, pos)
            nxt, pos = logits.argmax(-1)[:, None], pos + 1
            assert np.array_equal(got[0], logits.numpy())
        b0 = {k: torch.from_numpy(v) for k, v in batches[0].items()}
        loss, nll = TT.loss_fn(whole, b0["tokens"], b0["labels"])
        assert meshed["loss"] == (float(loss), float(nll))
        model, _, hist = TTL.train(whole, ST.lm_loss, iter(batches), RK.train_cfgs(run, cfg)[None])
        assert meshed["train"][None]["hist"] == hist
        for name, p in model.named_parameters():
            assert np.array_equal(meshed["train"][None]["params"][name], p.detach().numpy())


def test_distributed_example_trains_and_resumes_across_meshes(both, tmp_path, capsys):
    """The example at (2, 2) (int8 compression, checkpoints every step's
    end gathered to rank 0) gives the one-process run's losses; its
    checkpoint of step 2 restores at (1, 2), and in one process, and the
    third step's loss is the one-process resumed run's (within 1e-5)."""
    (first, resumed), ckpt = both[2]
    ex = _example()
    alone = tmp_path / "alone"
    want = ex.main(EXAMPLE_ARGS + ["--steps", "2", "--ckpt", str(alone)])
    want3 = ex.main(EXAMPLE_ARGS + ["--steps", "3", "--ckpt", str(alone)])
    assert first["mesh"]["tp"] == 2 and first["mesh"]["dp"] == 2
    assert first["loss"] == pytest.approx([h["loss"] for h in want], rel=TOL)
    assert first["gnorm"] == pytest.approx([h["gnorm"] for h in want], rel=TOL)
    assert resumed["mesh"]["tp"] == 2 and resumed["mesh"]["dp"] == 1
    assert len(resumed["loss"]) == len(want3) == 1
    assert resumed["loss"][0] == pytest.approx(want3[0]["loss"], rel=TOL)
    import shutil
    shutil.copytree(ckpt, tmp_path / "from_mesh")
    for f in (tmp_path / "from_mesh").glob("step_00000003*"):
        f.unlink()                                      # restore the mesh's step 2
    again = ex.main(EXAMPLE_ARGS + ["--steps", "3", "--ckpt", str(tmp_path / "from_mesh")])
    assert again[0]["loss"] == pytest.approx(want3[0]["loss"], rel=TOL)
    with pytest.raises(SystemExit, match="no one-card counterpart"):
        ex.main(["--lower-only"])
    capsys.readouterr()


def _same(port, ref):
    def flat(tree, leaf, path=()):
        if isinstance(tree, leaf):
            return {path: tuple(tree)}
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items()
                    for k2, v2 in flat(v, leaf, path + (k,)).items()}
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in flat(v, leaf, path + (i,)).items()}
    assert flat(port, SPECS.P) == flat(ref, JP)


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (16, 16)])
def test_opt_state_specs_equal_the_reference(shape):
    mesh = SimpleNamespace(shape=dict(zip(("data", "model"), shape)),
                           axis_names=("data", "model"))
    for arch in ("rcllm-qwen3-8b", "moonshot-v1-16b-a3b", "kimi-k2-1t-a32b"):
        tcfg, jcfg = TR.ARCHS[arch], JR.ARCHS[arch]
        tabs, jabs = SPECS.lm_abstract_params(tcfg), JT.abstract_params(jcfg)
        assert jax.tree_util.tree_map(lambda a: tuple(a.shape), jabs) == \
            SPECS.tree_map(lambda a: a.shape, tabs)
        tps, jps = SPECS.lm_param_specs(tcfg, mesh), JS.lm_param_specs(jcfg, mesh)
        for name in ("adamw", "adafactor"):
            got = SPECS.lm_opt_state_specs(TO.abstract_opt_state(name, tabs), tps, tabs, mesh)
            want = JS.lm_opt_state_specs(JO.abstract_opt_state(JO.get(name)[0], jabs), jps,
                                         jabs, mesh)
            assert tuple(got.step) == tuple(want.step)
            _same(got.inner, want.inner)
        assert SPECS.lm_opt_state_specs(TO.abstract_opt_state("sgd", tabs), tps, tabs,
                                        mesh).inner == ()
        with pytest.raises(ValueError):
            JS.lm_opt_state_specs(JO.abstract_opt_state(JO.get("sgd")[0], jabs), jps, jabs,
                                  mesh)
