"""Port parity for the training path's gradients against the JAX package:

* attention: `layers.flash_attention` (forward `chunked_attention`,
  backward the tile-for-tile plain version of `_flash_bwd` on the CPU)
  against `jax.grad` through the reference's `chunked_attention` (its
  `_flash` custom VJP), causal, windowed and GQA (G = 1, 2, 3), ragged
  lengths over several tiles; and the plain backward against the
  reference's `_flash_bwd` fed the same residuals, in fp32 and bf16;
* `transformer.loss_fn` and its gradients for every LM arch of the
  registry at reduced() size (MoE aux term included), and remat on/off;
* the MoE's gradients through the port's gathers (autograd) against the
  reference's gather-only custom VJPs, with and without capacity drops;
(the recsys losses are in `test_torch_recsys_train.py`).

Same numpy inputs and the reference's weights (converted through numpy)
in both packages, fp32 on the CPU, where only the order of sums differs:
losses within 1e-5 relative, gradients within atol = rtol = 1e-5 (TOL)
unless a test states otherwise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import registry as TR
from repro_torch.kernels.flash_attention.ops import mha_flash_bwd
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_numpy
from repro_torch.training.train_loop import trainable

TOL = 1e-5
LM_ARCHS = [a for a in JR.ARCHS if JR.family_of(a) == "lm"]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ------------------------------------------------------------- attention
FLASH_CASES = {   # (B, Sq, Hq, Hkv, D, causal, window, q_chunk, kv_chunk)
    "causal_mha": (2, 40, 2, 2, 16, True, None, 16, 16),
    "causal_gqa2": (1, 50, 4, 2, 16, True, None, 16, 32),
    "causal_g3_window": (2, 37, 3, 1, 8, True, 9, 8, 16),
    "full_window": (1, 33, 6, 2, 16, False, 7, 16, 8),
    "causal_one_tile": (2, 12, 4, 1, 32, True, None, 64, 64),
}


def _flash_inputs(case, seed=0):
    B, S, Hq, Hkv, D = FLASH_CASES[case][:5]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    g = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    return q, k, v, g


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_gradients_match_jax_grad(case):
    """Value and (dq, dk, dv) of the port's differentiable attention
    equal `jax.grad` of sum(out * g) through the reference."""
    _, S, _, _, _, causal, window, qc, kc = FLASH_CASES[case]
    q, k, v, g = _flash_inputs(case)
    pos = np.arange(S, dtype=np.int32)

    def f(q, k, v):
        out = JL.chunked_attention(q, k, v, causal=causal, q_positions=jnp.asarray(pos),
                                   kv_positions=jnp.asarray(pos), sliding_window=window,
                                   q_chunk=qc, kv_chunk=kc)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = TL.flash_attention(tq, tk, tv, causal=causal, q_positions=pos, kv_positions=pos,
                             sliding_window=window, q_chunk=qc, kv_chunk=kc)
    (out * torch.from_numpy(g)).sum().backward()
    _close(out.detach(), jout)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        _close(got, want)


@pytest.mark.parametrize("dtype,tol", [("float32", TOL), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("case", ["causal_gqa2", "causal_g3_window"])
def test_flash_bwd_plain_version_matches_the_reference_bwd(case, dtype, tol):
    """`mha_flash_bwd` on the CPU against the reference's `_flash_bwd` on
    the same residuals (out and lse from the reference's forward, in the
    working dtype).  bf16: both round p and dS to bf16 at the same points,
    so the gradients differ by summation order and an occasional
    rounding flip: 2e-2 of max(1, max|grad|)."""
    _, S, _, _, _, causal, window, qc, kc = FLASH_CASES[case]
    q, k, v, g = _flash_inputs(case, seed=1)
    pos = np.arange(S, dtype=np.int32)
    jdt = jnp.dtype(dtype)
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    jout, jlse = JL._attn_impl(jq, jk, jv, causal=causal, q_positions=jnp.asarray(pos),
                               kv_positions=jnp.asarray(pos), sliding_window=window,
                               q_chunk=qc, kv_chunk=kc, return_lse=True)
    res = (jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos), jout, jlse)
    want = JL._flash_bwd(causal, window, qc, kc, False, res, jg)[:3]
    tdt = getattr(torch, dtype)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(tdt)

    B, Sq, Hq, D = q.shape
    got = mha_flash_bwd(t(jq), t(jk), t(jv), t(jout),
                        torch.from_numpy(np.array(jlse)).reshape(B, Sq, Hq), t(jg),
                        torch.from_numpy(pos), torch.from_numpy(pos), causal=causal,
                        window=window, q_chunk=qc, kv_chunk=kc)
    for a, b in zip(got, want):
        assert a.dtype == tdt
        b = np.asarray(b, np.float32)
        scale = max(1.0, float(np.abs(b).max())) if dtype == "bfloat16" else 1.0
        np.testing.assert_allclose(a.float().numpy(), b, rtol=tol, atol=tol * scale)


def test_chunked_attention_lse_matches_the_reference():
    q, k, v, _ = _flash_inputs("causal_g3_window", seed=2)
    S = q.shape[1]
    pos = np.arange(S, dtype=np.int32)
    _, jlse = JL._attn_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                            q_positions=jnp.asarray(pos), kv_positions=jnp.asarray(pos),
                            sliding_window=9, q_chunk=8, kv_chunk=16, return_lse=True)
    _, lse = TL.chunked_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                  causal=True, q_positions=pos, kv_positions=pos,
                                  sliding_window=9, q_chunk=8, kv_chunk=16, return_lse=True)
    _close(lse.numpy(), np.asarray(jlse).reshape(lse.shape))


# ------------------------------------------------------------- LM loss
def _lm_name(path) -> str:
    """A reference parameter path -> the port's parameter name (layer
    parameters are stacked on axis 0 in the reference)."""
    return ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_loss_and_gradients_match_the_reference(arch):
    jcfg = JR.get_config(arch, smoke=True)
    cfg = TR.get_config(arch, smoke=True)
    params = JT.init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(1, cfg.vocab_size, (2, 41)).astype(np.int32)
    x, y = toks[:, :-1], toks[:, 1:]

    def f(p):
        return JT.loss_fn(p, jnp.asarray(x), jnp.asarray(y), jcfg)

    (jloss, jnll), jgrads = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    with trainable(model) as named:
        loss, nll = TT.loss_fn(model, torch.from_numpy(x), torch.from_numpy(y))
        loss.backward()
        grads = {n: p.grad.clone() for n, p in named}
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=TOL)
    assert float(nll.detach()) == pytest.approx(float(jnll), rel=TOL)
    if cfg.moe is not None:
        assert float(loss.detach()) != pytest.approx(float(nll.detach()), rel=1e-7)  # aux
    flat, _ = jax.tree_util.tree_flatten_with_path(jgrads)
    seen = set()
    for path, g in flat:
        name = _lm_name(path)
        g = np.asarray(g)
        if name.startswith("layers."):
            tail = name.split(".", 1)[1]
            for i in range(cfg.n_layers):
                pname = f"layers.{i}.{tail}"
                _close(grads[pname].numpy(), g[i])
                seen.add(pname)
        else:
            _close(grads[name].numpy(), g)
            seen.add(name)
    assert seen == set(grads)


def test_lm_remat_gives_the_same_gradients():
    cfg = TR.get_config("moonshot-v1-16b-a3b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    out = []
    for remat in (False, True):
        model = TT.init_params(dataclasses.replace(cfg, remat=remat),
                               torch.Generator().manual_seed(0), device="cpu")
        batch = TR.make_batch(model.cfg, "train_4k", gen.manual_seed(1), "cpu", batch=2, seq=24)
        with trainable(model) as named:
            TT.loss_fn(model, batch["tokens"], batch["labels"])[0].backward()
            out.append([p.grad.clone() for _, p in named])
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("capacity_factor", [8.0, 0.25])
def test_moe_gradients_match_the_reference_custom_vjps(capacity_factor):
    """Autograd of the port's gathers against the reference's gather-only
    custom VJPs (`moe_dispatch`, `masked_perm_gather`): input and weight
    gradients of the MoE, with and without capacity drops."""
    cfg = TR.get_config("kimi-k2-1t-a32b", smoke=True)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((40, 64)).astype(np.float32)
    g = rng.standard_normal((40, 64)).astype(np.float32)
    mp = jax.tree_util.tree_map(np.asarray, JL.moe_init(jax.random.PRNGKey(3), 64, cfg.moe,
                                                        cfg.mlp_type, jnp.float32))
    kw = dict(n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
              capacity_factor=capacity_factor, mlp_type=cfg.mlp_type)

    def f(x, p):
        y, aux = JL.moe_apply(x, p, **kw)
        return jnp.sum(y * g) + aux

    jgx, jgp = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), mp)
    tx = torch.tensor(x, requires_grad=True)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in mp.items()}
    y, aux = TL.moe_apply(tx, tp, **kw)
    ((y * torch.from_numpy(g)).sum() + aux).backward()
    _close(tx.grad, jgx)
    for k in tp:
        _close(tp[k].grad, jgp[k])
