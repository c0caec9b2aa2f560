"""Port parity for the LM architectures' building blocks: configs, the
registry's LM cells, parameter layouts, chunked prefill attention,
dense-cache decode attention and the sort-based MoE, against the JAX
package.

Everything runs in fp32 on the CPU.  Only the order of sums differs
between the packages (XLA's and torch's matrix products and reductions),
so values are held to atol = rtol = 1e-5 (TOL) on O(1) outputs, and the
MoE's integer routing must be equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.configs import registry as JR
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import base as TB
from repro_torch.configs import registry as TR
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_numpy

LM_ARCHS = [a for a in JR.ARCHS if JR.family_of(a) == "lm"]
TOL = 1e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


# ------------------------------------------------------------ configs
def _shared(port, ref):
    names = [f.name for f in dataclasses.fields(port)]
    assert set(names) <= {f.name for f in dataclasses.fields(ref)}
    return ({n: getattr(port, n) for n in names if n != "moe"},
            {n: getattr(ref, n) for n in names if n != "moe"})


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_configs_equal_the_reference(arch):
    """Every field the port keeps equals the reference's, at published
    size and at reduced() size; the MoE config field for field."""
    assert sorted(a for a in TR.ARCHS if TR.family_of(a) == "lm") == sorted(LM_ARCHS)
    for smoke in (False, True):
        port, ref = TR.get_config(arch, smoke), JR.get_config(arch, smoke)
        mine, theirs = _shared(port, ref)
        assert mine == theirs
        assert (port.moe is None) == (ref.moe is None) and port.is_moe == ref.is_moe
        if ref.moe is not None:
            assert dataclasses.asdict(port.moe) == dataclasses.asdict(ref.moe)
    assert [f.name for f in dataclasses.fields(TB.MoEConfig)] == \
        [f.name for f in dataclasses.fields(JB.MoEConfig)]
    assert TR.family_of(arch) == JR.family_of(arch) == "lm"


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_counts_equal_the_reference(arch):
    port, ref = TR.get_config(arch), JR.ARCHS[arch]
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    small, rsmall = TR.get_config(arch, True), JR.get_config(arch, True)
    assert small.param_count() == rsmall.param_count()
    assert small.active_param_count() == rsmall.active_param_count()


def test_lm_cells_equal_the_reference():
    assert {k: (v.name, v.step, v.dims) for k, v in TR.LM_SHAPES.items()} == \
        {k: (v.name, v.step, v.dims) for k, v in JR.LM_SHAPES.items()}
    for arch in TR.ARCHS:
        assert list(TR.shapes_of(arch)) == list(JR.shapes_of(arch))


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
def test_make_batch_has_the_reference_inputs(arch, shape):
    """Keys, dtypes and shapes of `input_specs` (published config; batch
    and seq replaced), tokens in the vocabulary, decode positions in
    [S/2, S-8]."""
    cfg = TR.get_config(arch)
    gen = torch.Generator().manual_seed(2)
    batch = TR.make_batch(cfg, shape, gen, "cpu", batch=3, seq=24)
    spec = JR.input_specs(arch, shape)
    assert set(batch) == set(spec)
    assert tuple(batch["tokens"].shape) == (3, 24 if shape == "prefill_32k" else 1)
    assert str(batch["tokens"].dtype) == "torch." + str(spec["tokens"].dtype)
    assert 0 <= int(batch["tokens"].min()) and int(batch["tokens"].max()) < cfg.vocab_size
    if "cache" in spec:
        for n in "kv":
            want = spec["cache"][n]
            assert tuple(batch["cache"][n].shape) == (want.shape[0], 3, 24) + want.shape[3:]
            assert batch["cache"][n].dtype == cfg.torch_dtype
            assert str(want.dtype) == cfg.dtype
        assert TR.lm_kv_cache_shape(cfg, 3, 24) == tuple(batch["cache"]["k"].shape)
        pos = batch["positions"]
        assert pos.dtype == torch.int32 and pos.shape == (3,)
        assert int(pos.min()) >= 12 and int(pos.max()) <= 16


def test_make_batch_refuses_the_training_cell():
    """Since the training slice make_batch fills train_4k (tokens and the
    same stream shifted by one as labels, `input_specs`' keys and dtypes)
    instead of refusing it; the cell it still refuses is the GNN's
    ogb_products, which needs more than one card."""
    cfg = TR.get_config("gemma-7b", True)
    batch = TR.make_batch(cfg, "train_4k", torch.Generator().manual_seed(0), "cpu",
                          batch=3, seq=24)
    spec = JR.input_specs("gemma-7b", "train_4k")
    assert set(batch) == set(spec)
    for k in batch:
        assert tuple(batch[k].shape) == (3, 24)
        assert str(batch[k].dtype) == "torch." + str(spec[k].dtype)
    assert torch.equal(batch["tokens"][:, 1:], batch["labels"][:, :-1])
    with pytest.raises(ValueError, match="multi-card"):
        TR.make_batch(TR.get_config("schnet", True), "ogb_products", torch.Generator(), "cpu")


def test_reduced_refuses_the_reference_config():
    with pytest.raises(TypeError):
        TB.reduced(JR.ARCHS["gemma-7b"])


# ------------------------------------------------------- parameters
def _ref_leaves(cfg):
    flat, _ = jax.tree_util.tree_flatten_with_path(JT.abstract_params(cfg))
    return {".".join(str(getattr(k, "key", k)) for k in path): a for path, a in flat}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_parameter_layout_equals_the_reference_at_published_width(arch):
    """The port's module at full width (on the meta device, no memory)
    holds the reference's leaves: per layer the stacked leaves' shape
    without the layer axis, in the reference's dtypes (router fp32)."""
    model = TT.Transformer(TR.get_config(arch), device="meta")
    ref = _ref_leaves(JR.ARCHS[arch])
    got = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            if parts[1] != "0":
                continue
            name = ".".join(["layers"] + parts[2:])
        got[name] = (tuple(p.shape), str(p.dtype).replace("torch.", ""))
    want = {}
    for name, a in ref.items():
        shape = tuple(a.shape[1:]) if name.startswith("layers.") else tuple(a.shape)
        want[name] = (shape, str(a.dtype))
    assert got == want
    assert len(model.layers) == JR.ARCHS[arch].n_layers


def test_seeded_moe_init_is_reproducible_at_the_reference_scales():
    cfg = dataclasses.replace(TR.get_config("moonshot-v1-16b-a3b", True), d_model=256)
    a = TT.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = TT.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    moe = a.layers[0].moe
    assert moe["router"].dtype == torch.float32
    assert abs(float(moe["router"].std()) - 256 ** -0.5) < 0.01
    assert abs(float(moe["w_up"].std()) - 256 ** -0.5) < 0.01
    assert abs(float(moe["w_down"].std()) - 64 ** -0.5) < 0.01
    assert not hasattr(a.layers[0], "mlp")


def test_convert_carries_the_moe_and_drops_the_tied_head():
    for arch in ("kimi-k2-1t-a32b", "gemma-7b"):
        jcfg, cfg = JR.get_config(arch, True), TR.get_config(arch, True)
        tree = jax.tree_util.tree_map(np.asarray, JT.init_params(jax.random.PRNGKey(5), jcfg))
        model = params_from_numpy(tree, cfg, device="cpu")
        if cfg.moe is not None:
            for i, blk in enumerate(model.layers):
                for n, p in blk.moe.items():
                    np.testing.assert_array_equal(p.numpy(), tree["layers"]["moe"][n][i])
            assert model.layers[0].moe["router"].dtype == torch.float32
        else:
            assert model.lm_head is None and "lm_head" not in tree


# ------------------------------------------------------------ attention
ATTN_CASES = {
    # name: (B, Sq, Skv, Hq, Hkv, D, causal, window, q0, valid, q_chunk, kv_chunk)
    "causal": (2, 40, 40, 4, 2, 16, True, None, 0, False, 16, 16),
    "causal-window": (2, 40, 40, 4, 2, 16, True, 7, 0, False, 16, 8),
    "causal-window-gqa4": (1, 37, 37, 8, 2, 8, True, 5, 0, False, 8, 16),
    "causal-valid-dead-row": (2, 24, 24, 4, 2, 16, True, None, 0, True, 16, 16),
    "window-valid": (2, 24, 24, 4, 1, 16, True, 4, 0, True, 8, 8),
    "offset-queries": (2, 9, 30, 4, 2, 16, True, 6, 21, False, 4, 16),
    "noncausal-window": (2, 20, 20, 4, 2, 16, False, 6, 0, False, 8, 16),
    "noncausal-valid": (2, 20, 28, 4, 4, 16, False, None, 0, True, 16, 16),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_chunked_attention_matches_the_reference(case):
    """q chunks against their causal / window band of keys equal the
    reference's tiled recurrence, padding included: q and kv lengths off
    the chunk multiples, GQA groups 1-4, kv_valid with a fully masked
    batch row (whose output is the mean of V over the padded keys)."""
    B, Sq, Skv, Hq, Hkv, D, causal, window, q0, valid, qc, kc = ATTN_CASES[case]
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    qpos = np.arange(q0, q0 + Sq, dtype=np.int32)
    kpos = np.arange(Skv, dtype=np.int32)
    kv_valid = None
    if valid:
        kv_valid = rng.random((B, Skv)) < 0.7
        kv_valid[-1] = False
    kw = dict(causal=causal, sliding_window=window, q_chunk=qc, kv_chunk=kc)
    want = JL.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kpos),
                                kv_valid=None if kv_valid is None else jnp.asarray(kv_valid),
                                **kw)
    got = TL.chunked_attention(_t(q), _t(k), _t(v), q_positions=_t(qpos), kv_positions=_t(kpos),
                               kv_valid=None if kv_valid is None else _t(kv_valid), **kw)
    assert got.shape == (B, Sq, Hq, D) and got.dtype == torch.float32
    _close(got.numpy(), want)
    if valid:
        dead = v[-1].sum(0) / (-(-Skv // kc) * kc)                  # (Hkv, D)
        _close(got[-1].numpy(), np.repeat(dead, Hq // Hkv, 0)[None].repeat(Sq, 0))


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_decode_attention_matches_the_reference(G, window):
    """Per-row lengths (one short of a window, one past it, one at the
    capacity) against the reference's masked matvec."""
    rng = np.random.default_rng(G)
    B, S, Hkv, D = 3, 33, 2, 16
    q = rng.standard_normal((B, 1, Hkv * G, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    lens = np.array([5, 20, 33], np.int32)
    want = JL.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(lens), sliding_window=window)
    got = TL.decode_attention(_t(q), _t(k), _t(v), _t(lens), sliding_window=window)
    assert got.shape == (B, 1, Hkv * G, D)
    _close(got.numpy(), want)


# ------------------------------------------------------------ MoE
def _capture_dispatch(monkeypatch):
    """Record the integer routing the reference's moe_apply hands its
    dispatch: slot_tok, slot_valid (E, C), dest_tk, keep_tk (T, K)."""
    seen = {}
    orig = JL.moe_dispatch

    def spy(x, slot_tok, slot_valid, dest_tk, keep_tk):
        seen.update(slot_tok=np.asarray(slot_tok), slot_valid=np.asarray(slot_valid),
                    dest_tk=np.asarray(dest_tk), keep_tk=np.asarray(keep_tk))
        return orig(x, slot_tok, slot_valid, dest_tk, keep_tk)
    monkeypatch.setattr(JL, "moe_dispatch", spy)
    return seen


MOE_CASES = {
    # name: (T, D, E, K, F, capacity_factor, mlp_type, router scale)
    "prefill-swiglu": (48, 32, 4, 2, 24, 1.0, "swiglu", 4.0),
    "prefill-geglu": (40, 32, 8, 2, 16, 1.25, "geglu", 4.0),
    "prefill-relu2": (40, 32, 8, 3, 16, 0.5, "relu2", 2.0),
    "prefill-gelu": (40, 32, 4, 2, 16, 0.75, "gelu", 2.0),
    # decode: T = B = 8, E = 64, K = 6 -> C = max(1, int(0.9375)) = 1
    "decode-64-experts": (8, 32, 64, 6, 16, 1.25, "swiglu", 4.0),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_matches_the_reference_and_drops_the_same_routes(case, monkeypatch):
    T, D, E, K, Fe, cf, mlp_type, scale = MOE_CASES[case]
    rng = np.random.default_rng(11)
    x = rng.standard_normal((T, D)).astype(np.float32)
    params = {"router": (rng.standard_normal((D, E)) * scale / D ** 0.5).astype(np.float32),
              "w_up": (rng.standard_normal((E, D, Fe)) / D ** 0.5).astype(np.float32),
              "w_down": (rng.standard_normal((E, Fe, D)) / Fe ** 0.5).astype(np.float32)}
    if mlp_type in ("swiglu", "geglu"):
        params["w_gate"] = (rng.standard_normal((E, D, Fe)) / D ** 0.5).astype(np.float32)
    kw = dict(n_experts=E, top_k=K, capacity_factor=cf, mlp_type=mlp_type)
    seen = _capture_dispatch(monkeypatch)
    want, want_aux = JL.moe_apply(jnp.asarray(x), {n: jnp.asarray(a) for n, a in params.items()},
                                  **kw)
    got, aux = TL.moe_apply(_t(x), {n: _t(a) for n, a in params.items()}, **kw)
    route = TL.moe_route(_t(x), _t(params["router"]), n_experts=E, top_k=K, capacity_factor=cf)
    C = max(1, int(cf * T * K / E))
    assert route["C"] == C == seen["slot_tok"].shape[1]
    assert not seen["keep_tk"].all(), "the case must drop routes"
    for name in ("slot_tok", "slot_valid", "dest_tk", "keep_tk"):
        np.testing.assert_array_equal(route[name].numpy(), seen[name], err_msg=name)
    np.testing.assert_array_equal(route["expert_idx"].numpy(), seen["dest_tk"] // C)
    _close(got.numpy(), want)
    _close(float(aux), float(want_aux))


def test_moe_top_k_breaks_ties_by_lower_expert_id(monkeypatch):
    """A zero router makes every probability equal: lax.top_k then picks
    experts 0..K-1 in order, and so must the port."""
    T, D, E, K = 6, 8, 8, 3
    x = np.random.default_rng(0).standard_normal((T, D)).astype(np.float32)
    route = TL.moe_route(_t(x), torch.zeros(D, E), n_experts=E, top_k=K, capacity_factor=1.25)
    np.testing.assert_array_equal(route["expert_idx"].numpy(), np.tile(np.arange(K), (T, 1)))
    seen = _capture_dispatch(monkeypatch)
    params = {"router": jnp.zeros((D, E)), "w_up": jnp.ones((E, D, 4)),
              "w_down": jnp.ones((E, 4, D)), "w_gate": jnp.ones((E, D, 4))}
    JL.moe_apply(jnp.asarray(x), params, n_experts=E, top_k=K, capacity_factor=1.25,
                 mlp_type="swiglu")
    np.testing.assert_array_equal(route["keep_tk"].numpy(), seen["keep_tk"])
    np.testing.assert_array_equal(route["slot_tok"].numpy(), seen["slot_tok"])


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cost_model_counts_active_experts_as_the_reference(arch):
    """The analytic cost model's prefill FLOPs and decode step (an MoE's
    top-k experts only) equal the reference's for every LM config."""
    from repro.core import cost_model as JC
    from repro_torch.core import cost_model as TC

    port, ref = TR.get_config(arch), JR.ARCHS[arch]
    hw = TC.H100_SXM
    jhw = JC.Hardware(**dataclasses.asdict(hw))
    assert TC.prefill_flops(port, 2048, 512) == JC.prefill_flops(ref, 2048, 512)
    assert TC.decode_step_time_s(port, hw, 8, 4096) == JC.decode_step_time_s(ref, jhw, 8, 4096)
