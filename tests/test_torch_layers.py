"""Port parity for the model core: layers, the weight bridge and the
full-recompute forward, JAX package vs `repro_torch` on the same numpy
inputs (fp32; torch's default fp32 matmul)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LMConfig as JaxLMConfig
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.core.rcllm import tiny_config
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_numpy

ATOL = 1e-5      # elementwise fp32 ops: rounding only
FWD_ATOL = 1e-4  # whole forward: summation order differs across frameworks


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed", range(3))
def test_rms_norm_matches_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 5, 24)).astype(np.float32)
    scale = rng.normal(size=(24,)).astype(np.float32) * 0.1
    want = np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6))
    got = TL.rms_norm(_t(x), _t(scale), 1e-6).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("seed", range(2))
def test_apply_rope_matches_jax(seed, theta):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 600, size=(2, 7))
    want = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = TL.apply_rope(_t(x), _t(pos), theta).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


def test_rope_realign_matches_jax():
    rng = np.random.default_rng(3)
    k = rng.normal(size=(4, 9, 2, 16)).astype(np.float32)
    delta = rng.integers(0, 300, size=(4,))
    want = np.asarray(JL.rope_realign(jnp.asarray(k), jnp.asarray(delta), 1e4))
    got = TL.rope_realign(_t(k), _t(delta), 1e4).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    # group property: realigning by p equals rotating to position p
    direct = TL.apply_rope(_t(k), _t(np.broadcast_to(delta[:, None], (4, 9))), 1e4)
    np.testing.assert_allclose(got, direct.numpy(), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "relu2", "gelu"])
def test_mlp_apply_matches_jax(mlp_type):
    p = JL.mlp_init(jax.random.PRNGKey(1), 24, 40, mlp_type, jnp.float32)
    x = np.random.default_rng(4).normal(size=(6, 24)).astype(np.float32)
    want = np.asarray(JL.mlp_apply(jnp.asarray(x), p, mlp_type))
    got = TL.mlp_apply(_t(x), {k: _t(v) for k, v in p.items()}, mlp_type).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


@pytest.fixture(scope="module")
def jax_tiny():
    """The weights `repro.core.rcllm.make_tiny_system(n_layers=2,
    d_model=32)` serves (its config, `T.init_params(PRNGKey(0))`),
    without building the caches."""
    cfg = JaxLMConfig(name="rcllm-tiny", n_layers=2, d_model=32,
                      n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                      vocab_size=4096, mlp_type="swiglu", dtype="float32",
                      attn_q_chunk=64, attn_kv_chunk=64, remat=False)
    return cfg, JT.init_params(jax.random.PRNGKey(0), cfg)


def test_params_from_numpy_round_trip(jax_tiny):
    _, params = jax_tiny
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = params_from_numpy(tree, tiny_config(2, 32), device="cpu")
    np.testing.assert_array_equal(model.embed.numpy(), tree["embed"])
    np.testing.assert_array_equal(model.lm_head.numpy(), tree["lm_head"])
    np.testing.assert_array_equal(model.final_norm.numpy(), tree["final_norm"])
    for i, blk in enumerate(model.layers):
        for name in ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(getattr(blk, name).numpy(),
                                          tree["layers"][name][i])
        assert set(blk.mlp) == set(tree["layers"]["mlp"])
        for name, p in blk.mlp.items():
            np.testing.assert_array_equal(p.numpy(), tree["layers"]["mlp"][name][i])
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("seq", [17, 64])
def test_forward_logits_match_jax(jax_tiny, seq):
    jcfg, params = jax_tiny
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                              tiny_config(2, 32), device="cpu")
    toks = np.random.default_rng(seq).integers(1, 4096, size=(2, seq)).astype(np.int32)
    want, _ = JT.forward(params, jnp.asarray(toks), jcfg)
    got = TT.forward(model, _t(toks).long(), kernels=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL, rtol=FWD_ATOL)


def test_init_params_is_seeded_and_scaled():
    cfg = tiny_config(2, 32)
    a = TT.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    b = TT.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    # the reference's init scales: N(0, 1/D) projections, zero norms
    assert abs(a.layers[0].wq.std().item() - 32 ** -0.5) < 0.02
    assert torch.count_nonzero(a.layers[0].attn_norm) == 0
