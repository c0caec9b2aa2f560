"""Port parity for the recsys training losses against the JAX package:
the recsys `train_loss` and its gradients for the four archs at reduced()
size, and Wide&Deep's wide bag sum through its autograd function (B5
forward, the K7 plain version backward) against JAX's autodiff of take +
sum.  Same numpy inputs and the reference's weights (converted through
numpy), fp32 on the CPU: losses within 1e-5 relative, gradients within
atol = rtol = 1e-5 (TOL), bf16 as stated."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.recsys import embedding as JE
from repro.recsys import models as JM
from repro_torch.configs import registry as TR
from repro_torch.kernels.embedding_bag import ops as EO
from repro_torch.recsys import models as TM
from repro_torch.recsys.convert import recsys_params_from_numpy
from repro_torch.training.train_loop import trainable

TOL = 1e-5
RECSYS_ARCHS = [a for a in JR.ASSIGNED if JR.family_of(a) == "recsys"]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _name(path) -> str:
    return ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


# ------------------------------------------------------------- recsys
def _np_train_batch(cfg, B, rng, n_neg=16):
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
            n_mask = max(1, T // 10)
            b = {"item_seq": items, "seq_mask": mask,
                 "mlm_positions": rng.integers(0, T, (B, n_mask)).astype(np.int32),
                 "mlm_labels": rng.integers(0, cfg.n_items, (B, n_mask)).astype(np.int32),
                 "neg_samples": rng.integers(0, cfg.n_items, n_neg).astype(np.int32)}
    if cfg.kind != "bert4rec":
        b["labels"] = rng.integers(0, 2, B).astype(np.float32)
    return b


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_train_loss_and_gradients_match_the_reference(arch):
    jcfg = JR.get_config(arch, smoke=True)
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    model = recsys_params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                     TR.get_config(arch, smoke=True), device="cpu")
    batch = _np_train_batch(jcfg, 12, np.random.default_rng(6))
    jloss, jgrads = jax.jit(jax.value_and_grad(JM.train_loss), static_argnums=2)(
        params, jax.tree_util.tree_map(jnp.asarray, batch), jcfg)
    with trainable(model) as named:
        loss = TM.train_loss(model, {k: torch.from_numpy(v) for k, v in batch.items()})
        loss.backward()
        grads = {n: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
                 for n, p in named}
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=TOL)
    flat, _ = jax.tree_util.tree_flatten_with_path(jgrads)
    assert {_name(p) for p, _ in flat} == set(grads)
    for path, g in flat:
        _close(grads[_name(path)].numpy(), g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_bag_gradient_matches_jax_autodiff(dtype):
    """The wide sum's gradient through its autograd function (plain K7 on
    the CPU) equals JAX's autodiff of the reference's take + sum, and the
    kernel wrapper's plain version accumulates repeated rows."""
    cfg = JR.get_config("wide-deep", smoke=True)
    rng = np.random.default_rng(8)
    rows = JE.mega_table_rows(cfg.field_vocabs)
    table = (rng.standard_normal((rows, 1)) * 0.05).astype(np.float32)
    ids = np.stack([rng.integers(0, v, 33) for v in cfg.field_vocabs], 1).astype(np.int32)
    ids[:5] = ids[0]                                     # repeated bags: rows collide
    w = rng.standard_normal(33).astype(np.float32)
    offsets = jnp.asarray(JE.field_offsets(cfg.field_vocabs))

    def f(t):
        return jnp.sum(JE.fielded_lookup(t, jnp.asarray(ids), offsets)[..., 0].sum(-1) * w)

    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(jax.grad(f)(jnp.asarray(table, jdt)), np.float32)
    tt = torch.from_numpy(table).to(dtype).requires_grad_(True)
    gids = torch.from_numpy(ids) + torch.as_tensor(JE.field_offsets(cfg.field_vocabs))
    (TM.WideBagSum.apply(tt, gids.to(torch.int32))[:, 0].float()
     * torch.from_numpy(w)).sum().backward()
    assert tt.grad.dtype == dtype and tt.grad.shape == (rows, 1)
    tol = TOL if dtype == torch.float32 else 2 ** -7 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(tt.grad.float().numpy(), want, rtol=TOL, atol=tol)
    direct = EO.bag_backward(gids.to(torch.int32),
                             torch.from_numpy(w)[:, None].to(dtype), rows)
    torch.testing.assert_close(direct, tt.grad, rtol=0, atol=0)
