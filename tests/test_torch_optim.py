"""The port's optimizers (`repro_torch.training.optimizer`) against the
JAX package's (`repro.training.optimizer`): the same numpy parameters and
the same numpy gradients into both, three updates, parameters and states
within 1e-6 (fp32; the two differ only in fp32 rounding of the same
formulas, and Adam's division by sqrt(v) keeps that small only when both
see the same gradients, which they do here).  Also the clip, the
factored Adafactor state shapes and a bf16 parameter's cast back."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import optimizer as JO
from repro_torch.training import optimizer as TO

TOL = 1e-6
SHAPES = {"a": (4, 3), "b": (5,), "c": (2, 3, 4), "d": (1, 6)}


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def _torch_params(tree):
    return [(k, torch.tensor(v).clone()) for k, v in sorted(tree.items())]


def _run_both(name, kw, grad_scale, steps=3, seed=0):
    rng = np.random.default_rng(seed)
    params = _tree(rng)
    grads = [_tree(rng, grad_scale) for _ in range(steps)]
    init, update = JO.get(name, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = init(jp)
    named = _torch_params(params)
    opt = TO.get(name, named, **kw)
    norms = []
    for g in grads:
        jp, js, jn = update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        for k, p in named:
            p.grad = torch.tensor(g[k])
        tn = opt.step()
        norms.append((float(jn), float(tn)))
    return jp, js, named, opt, norms


@pytest.mark.parametrize("name,kw", [("adamw", dict(lr=1e-2)),
                                     ("adamw", dict(lr=3e-3, weight_decay=0.0)),
                                     ("adafactor", dict(lr=1e-2)),
                                     ("sgd", dict(lr=5e-2))])
@pytest.mark.parametrize("grad_scale", [0.01, 3.0])   # below and above the clip
def test_three_updates_match_the_reference(name, kw, grad_scale):
    jp, js, named, opt, norms = _run_both(name, kw, grad_scale)
    for jn, tn in norms:
        assert tn == pytest.approx(jn, rel=TOL)
    for k, p in named:
        np.testing.assert_allclose(p.numpy(), np.asarray(jp[k]), rtol=TOL, atol=TOL)
    state = opt.opt_state()
    assert state.step == int(js.step) == 3
    for k, _ in named:
        if name == "adamw":
            want = {"m": js.inner["m"][k], "v": js.inner["v"][k]}
        elif name == "adafactor":
            want = js.inner[k]
        else:
            want = {}
        assert set(state.inner[k]) == set(want)
        for s, w in want.items():
            np.testing.assert_allclose(state.inner[k][s].numpy(), np.asarray(w),
                                       rtol=TOL, atol=TOL)


def test_adafactor_state_is_factored_for_matrices_only():
    named = [("m", torch.zeros(6, 4)), ("row", torch.zeros(1, 4)), ("vec", torch.zeros(7)),
             ("stack", torch.zeros(3, 5, 2))]
    st = TO.get("adafactor", named).opt_state().inner
    assert {k: tuple(v.shape) for k, v in st["m"].items()} == {"vr": (6,), "vc": (4,)}
    assert {k: tuple(v.shape) for k, v in st["row"].items()} == {"v": (1, 4)}
    assert {k: tuple(v.shape) for k, v in st["vec"].items()} == {"v": (7,)}
    assert {k: tuple(v.shape) for k, v in st["stack"].items()} == {"vr": (3, 5), "vc": (3, 2)}
    ref = JO.adafactor()[0]({k: jnp.zeros(v.shape) for k, v in named})
    for k, v in st.items():
        assert {s: tuple(t.shape) for s, t in v.items()} == \
            {s: tuple(t.shape) for s, t in ref.inner[k].items()}


@pytest.mark.parametrize("norm_scale", [0.5, 1.0, 40.0])
def test_clip_by_global_norm_matches_the_reference(norm_scale):
    rng = np.random.default_rng(3)
    tree = _tree(rng, norm_scale)
    jc, jn = JO.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, tree), 1.0)
    names = sorted(tree)
    tc, tn = TO.clip_by_global_norm([torch.tensor(tree[k]) for k in names], 1.0)
    assert float(tn) == pytest.approx(float(jn), rel=TOL)
    assert float(TO.global_norm([torch.tensor(tree[k]) for k in names])) == \
        pytest.approx(float(JO.global_norm(tree)), rel=TOL)
    for k, t in zip(names, tc):
        np.testing.assert_allclose(t.numpy(), np.asarray(jc[k]), rtol=TOL, atol=TOL)
    assert float(TO.global_norm(tc)) == pytest.approx(min(1.0, float(jn)), rel=1e-5)


def test_missing_gradient_counts_as_zero_and_bf16_casts_back():
    """A parameter no loss reached still decays (AdamW's weight decay on a
    zero gradient), as in the reference, whose gradient tree has zeros
    there; a bf16 parameter is updated in fp32 and rounded back."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    u = rng.standard_normal((4,)).astype(np.float32)
    g = rng.standard_normal((3, 4)).astype(np.float32)
    init, update = JO.adamw(lr=0.1, weight_decay=0.5)
    jp = {"u": jnp.asarray(u), "w": jnp.asarray(w, jnp.bfloat16)}
    jp, _, _ = update({"u": jnp.zeros(4), "w": jnp.asarray(g, jnp.bfloat16)}, init(jp), jp)
    named = [("u", torch.tensor(u)), ("w", torch.tensor(w).to(torch.bfloat16))]
    named[1][1].grad = torch.tensor(g).to(torch.bfloat16)
    TO.get("adamw", named, lr=0.1, weight_decay=0.5).step()
    np.testing.assert_allclose(named[0][1].numpy(), np.asarray(jp["u"]), rtol=TOL, atol=TOL)
    assert named[1][1].dtype == torch.bfloat16
    np.testing.assert_array_equal(named[1][1].float().numpy(),
                                  np.asarray(jp["w"]).astype(np.float32))


def test_large_parameters_update_in_row_blocks(monkeypatch):
    """The row-block split of a large parameter gives the same update."""
    rng = np.random.default_rng(7)
    w = rng.standard_normal((64, 8)).astype(np.float32)
    g = rng.standard_normal((64, 8)).astype(np.float32)
    out = []
    for chunk in (1 << 26, 40):
        monkeypatch.setattr(TO, "CHUNK", chunk)
        p = torch.tensor(w)
        opt = TO.get("adamw", [p], lr=1e-2)
        for _ in range(2):
            p.grad = torch.tensor(g)
            opt.step()
        out.append((p.clone(), opt.opt_state().inner["0"]["v"].clone()))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=0, atol=0)
    torch.testing.assert_close(out[0][1], out[1][1], rtol=0, atol=0)


def test_opt_state_round_trips():
    rng = np.random.default_rng(9)
    named = _torch_params(_tree(rng))
    opt = TO.get("adafactor", named)
    for _, p in named:
        p.grad = torch.ones_like(p)
    opt.step()
    st = opt.opt_state()
    fresh = TO.get("adafactor", _torch_params(_tree(rng)))
    fresh.load_opt_state(st)
    assert fresh.t == 1
    for k in st.inner:
        for s in st.inner[k]:
            torch.testing.assert_close(fresh.opt_state().inner[k][s], st.inner[k][s])


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor", "sgd"])
def test_optimizer_decreases_quadratic(opt_name):
    """The reference's own test: 50 steps at lr 0.1 at least halve
    |w|^2 + b^2."""
    w = torch.tensor([3.0, -2.0])
    b = torch.tensor(1.5)
    opt = TO.get(opt_name, [("w", w), ("b", b)], lr=0.1)

    def loss():
        return float((w ** 2).sum() + b ** 2)

    l0 = loss()
    for _ in range(50):
        w.grad, b.grad = 2 * w, 2 * b
        opt.step()
    assert loss() < 0.5 * l0
