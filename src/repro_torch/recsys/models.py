"""Recsys model family of the port: Wide&Deep, AutoInt, DIEN, BERT4Rec
(the JAX package's `recsys/models.py`), scoring and retrieval.

A model is the reference's parameter pytree as nested modules
(`ParamTree`: a dict becomes a module, a list an `nn.ModuleList`, an array
a frozen parameter), so `model.deep[0].w` reads as `params["deep"][0]["w"]`
and every product keeps the reference's layout.  The init functions draw
the reference's initialisers from an explicit `torch.Generator`; parity
tests instead convert the reference's own weights
(`recsys.convert.recsys_params_from_numpy`).

Wide&Deep's wide part, a fixed-fanout bag sum over a (rows, 1) table, is
the one call into a kernel (`kernels/embedding_bag`: B5 forward, K7 for
its gradient); the rest is plain PyTorch, as the JAX package leaves it
to XLA.  `train_loss` is the reference's: BCE with logits for the CTR
models, the sampled-softmax MLM loss for BERT4Rec.  The parameters take
gradients only where a caller turns them on
(`training.train_loop.trainable`).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import RecsysConfig
from repro_torch.kernels.embedding_bag.ops import bag_backward, bag_sum
from repro_torch.recsys import embedding as E

Batch = Dict[str, torch.Tensor]
NEG_INF = -1e30


class ParamTree(nn.Module):
    """A parameter pytree (dicts, lists, tensors) as nested modules."""

    def __init__(self, tree: Dict):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, dict):
                self.add_module(name, ParamTree(v))
            elif isinstance(v, list):
                self.add_module(name, nn.ModuleList(ParamTree(x) for x in v))
            else:
                self.register_parameter(name, nn.Parameter(v, requires_grad=False))


class RecsysModel(ParamTree):
    """One recsys model: its config and its parameter tree.  The CTR
    models also carry each field's start row in the mega-table."""

    def __init__(self, cfg: RecsysConfig, tree: Dict):
        super().__init__(tree)
        self.cfg = cfg
        if cfg.kind in ("wide_deep", "autoint"):
            offsets = torch.as_tensor(E.field_offsets(cfg.field_vocabs),
                                      device=self.device)
            self.register_buffer("offsets", offsets, persistent=False)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


# ---------------------------------------------------------------------------
# initialisation (the reference's scales, drawn from a torch.Generator)
# ---------------------------------------------------------------------------

class _Init:
    def __init__(self, generator: Optional[torch.Generator], device, dtype):
        self.gen, self.kw = generator, dict(device=device, dtype=dtype)

    def normal(self, shape: Tuple[int, ...], scale: float) -> torch.Tensor:
        return torch.empty(shape, **self.kw).normal_(generator=self.gen).mul_(scale)

    def zeros(self, *shape: int) -> torch.Tensor:
        return torch.zeros(shape, **self.kw)

    def mega_table(self, vocabs: Sequence[int], dim: int) -> torch.Tensor:
        return E.init_mega_table(self.gen, vocabs, dim, **self.kw)


def _mlp_init(ini: _Init, dims: Tuple[int, ...]) -> list:
    return [{"w": ini.normal((din, dout), din ** -0.5), "b": ini.zeros(dout)}
            for din, dout in zip(dims[:-1], dims[1:])]


def _mlp_apply(ps: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    for i, p in enumerate(ps):
        x = x @ p.w + p.b
        if i < len(ps) - 1:
            x = torch.relu(x)
    return x


def widedeep_init(ini: _Init, cfg: RecsysConfig) -> Dict:
    nf = len(cfg.field_vocabs)
    deep_in = cfg.n_dense + nf * cfg.embed_dim
    return {
        "table": ini.mega_table(cfg.field_vocabs, cfg.embed_dim),
        "wide_table": ini.mega_table(cfg.field_vocabs, 1),
        "wide_dense": ini.normal((cfg.n_dense, 1), 0.1),
        "deep": _mlp_init(ini, (deep_in,) + tuple(cfg.mlp_dims) + (1,)),
        "user_proj": ini.normal((cfg.mlp_dims[-1], cfg.embed_dim),
                                cfg.mlp_dims[-1] ** -0.5),
    }


def autoint_init(ini: _Init, cfg: RecsysConfig) -> Dict:
    nf = len(cfg.field_vocabs)
    d, da, H = cfg.embed_dim, cfg.d_attn, cfg.n_heads
    layers = []
    for i in range(cfg.n_attn_layers):
        din = d if i == 0 else da * H
        s = din ** -0.5
        layers.append({"wq": ini.normal((din, H, da), s), "wk": ini.normal((din, H, da), s),
                       "wv": ini.normal((din, H, da), s),
                       "wres": ini.normal((din, H * da), s)})
    out_dim = (nf + cfg.n_dense) * da * H
    return {
        "table": ini.mega_table(cfg.field_vocabs, d),
        "dense_emb": ini.normal((cfg.n_dense, d), 0.05),
        "attn": layers,
        "w_out": ini.normal((out_dim, 1), out_dim ** -0.5),
        "user_proj": ini.normal((out_dim, d), out_dim ** -0.5),
    }


def _gru_init(ini: _Init, d_in: int, d_h: int) -> Dict:
    s = (d_in + d_h) ** -0.5
    return {"wz": ini.normal((d_in + d_h, d_h), s), "wr": ini.normal((d_in + d_h, d_h), s),
            "wh": ini.normal((d_in + d_h, d_h), s),
            "bz": ini.zeros(d_h), "br": ini.zeros(d_h), "bh": ini.zeros(d_h)}


def dien_init(ini: _Init, cfg: RecsysConfig) -> Dict:
    d = cfg.embed_dim
    d_in = 2 * d                              # item + cate
    dh = cfg.gru_dim
    mlp_in = dh + 2 * d + 2 * d               # final interest + target + sum-pool
    return {
        "item_table": ini.normal((E.pad_rows(cfg.n_items), d), 0.05),
        "cate_table": ini.normal((E.pad_rows(cfg.n_cates), d), 0.05),
        "gru1": _gru_init(ini, d_in, dh),
        "gru2": _gru_init(ini, d_in if dh == d_in else dh, dh),
        "att_w": ini.normal((dh, 2 * d), dh ** -0.5),
        "mlp": _mlp_init(ini, (mlp_in,) + tuple(cfg.mlp_dims) + (1,)),
        "user_proj": ini.normal((dh, d), dh ** -0.5),
    }


def bert4rec_init(ini: _Init, cfg: RecsysConfig) -> Dict:
    d, H = cfg.embed_dim, cfg.n_heads
    dh = d // H
    blocks = [{
        "ln1": ini.zeros(d), "ln2": ini.zeros(d),
        "wq": ini.normal((d, H, dh), d ** -0.5), "wk": ini.normal((d, H, dh), d ** -0.5),
        "wv": ini.normal((d, H, dh), d ** -0.5), "wo": ini.normal((H, dh, d), d ** -0.5),
        "w1": ini.normal((d, 4 * d), d ** -0.5), "b1": ini.zeros(4 * d),
        "w2": ini.normal((4 * d, d), (4 * d) ** -0.5), "b2": ini.zeros(d),
    } for _ in range(cfg.n_blocks)]
    return {
        # +2 rows: PAD and MASK tokens (padded to shard boundary)
        "item_table": ini.normal((E.pad_rows(cfg.n_items + 2), d), 0.05),
        "pos_table": ini.normal((cfg.seq_len, d), 0.05),
        "blocks": blocks,
        "final_ln": ini.zeros(d),
    }


INIT = {"wide_deep": widedeep_init, "autoint": autoint_init,
        "dien": dien_init, "bert4rec": bert4rec_init}


def init_params(cfg: RecsysConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> RecsysModel:
    """Random weights at the reference's init scales, drawn from an
    explicit `torch.Generator` (which must live on `device`; none on the
    "meta" device, where only the shapes are built)."""
    ini = _Init(generator, device, getattr(torch, cfg.dtype))
    return RecsysModel(cfg, INIT[cfg.kind](ini, cfg))


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

class WideBagSum(torch.autograd.Function):
    """Wide&Deep's wide sum: forward `bag_sum` (B5), gradient with
    respect to the table `bag_backward` (K7); the ids take none."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return bag_sum(table, ids)

    @staticmethod
    def backward(ctx, d_out: torch.Tensor):
        ids, = ctx.saved_tensors
        return bag_backward(ids, d_out.contiguous(), ctx.rows), None


def widedeep_forward(m: RecsysModel, batch: Batch, return_user: bool = False):
    ids = batch["sparse_ids"] + m.offsets[None, :]                   # (B, F) global rows
    emb = E.lookup(m.table, ids)                                     # (B, F, d)
    B = emb.shape[0]
    hidden = torch.cat([batch["dense"], emb.reshape(B, -1)], dim=-1)
    for p in m.deep[:-1]:
        hidden = torch.relu(hidden @ p.w + p.b)
    deep_logit = (hidden @ m.deep[-1].w + m.deep[-1].b)[:, 0]
    wide = WideBagSum.apply(m.wide_table, ids)[:, 0]                 # B5 (K7 backward)
    wide = wide + (batch["dense"] @ m.wide_dense)[:, 0]
    logit = deep_logit + wide
    if return_user:
        return logit, hidden @ m.user_proj
    return logit


def autoint_forward(m: RecsysModel, batch: Batch, return_user: bool = False):
    emb = E.fielded_lookup(m.table, batch["sparse_ids"], m.offsets)  # (B, F, d)
    dense_emb = batch["dense"][..., None] * m.dense_emb[None]       # (B, 13, d)
    x = torch.cat([emb, dense_emb], dim=1)                          # (B, F+13, d)
    for lp in m.attn:
        q = torch.einsum("bfd,dhe->bfhe", x, lp.wq)
        k = torch.einsum("bfd,dhe->bfhe", x, lp.wk)
        v = torch.einsum("bfd,dhe->bfhe", x, lp.wv)
        s = torch.einsum("bfhe,bghe->bhfg", q, k) / (lp.wq.shape[-1] ** 0.5)
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhfg,bghe->bfhe", a, v)
        B, Fn = x.shape[:2]
        x = torch.relu(o.reshape(B, Fn, -1) + x @ lp.wres)
    flat = x.reshape(x.shape[0], -1)
    logit = (flat @ m.w_out)[:, 0]
    if return_user:
        return logit, flat @ m.user_proj
    return logit


def _gru_cell(p: ParamTree, h: torch.Tensor, x: torch.Tensor,
              att: Optional[torch.Tensor] = None) -> torch.Tensor:
    xh = torch.cat([x, h], dim=-1)
    z = torch.sigmoid(xh @ p.wz + p.bz)
    r = torch.sigmoid(xh @ p.wr + p.br)
    hh = torch.tanh(torch.cat([x, r * h], dim=-1) @ p.wh + p.bh)
    if att is not None:                     # AUGRU: attention scales the update gate
        z = z * att[:, None]
    return (1 - z) * h + z * hh


def dien_forward(m: RecsysModel, batch: Batch, return_user: bool = False):
    it = E.lookup(m.item_table, batch["hist_items"])                # (B, T, d)
    ct = E.lookup(m.cate_table, batch["hist_cates"])
    x = torch.cat([it, ct], dim=-1)                                 # (B, T, 2d)
    mask = batch["hist_mask"].to(x.dtype)                           # (B, T)
    tgt = torch.cat([E.lookup(m.item_table, batch["target_item"]),
                     E.lookup(m.cate_table, batch["target_cate"])], dim=-1)  # (B, 2d)
    B, T, _ = x.shape
    live = mask[..., None] > 0                                      # (B, T, 1)

    # interest extraction: a masked step keeps h (the reference's lax.scan)
    h, hs = x.new_zeros((B, m.cfg.gru_dim)), []
    for t in range(T):
        h = torch.where(live[:, t], _gru_cell(m.gru1, h, x[:, t]), h)
        hs.append(h)
    hs = torch.stack(hs, dim=1)                                     # (B, T, dh)

    # attention of the target on the interest states
    att_logits = torch.einsum("btd,de,be->bt", hs, m.att_w, tgt)
    att = torch.softmax(torch.where(mask > 0, att_logits, NEG_INF), dim=-1)

    # interest evolution (AUGRU)
    h = x.new_zeros((B, m.cfg.gru_dim))
    for t in range(T):
        h = torch.where(live[:, t], _gru_cell(m.gru2, h, hs[:, t], att=att[:, t]), h)

    pooled = (x * mask[..., None]).sum(1) / torch.clamp(mask.sum(1), min=1)[:, None]
    logit = _mlp_apply(m.mlp, torch.cat([h, tgt, pooled], dim=-1))[:, 0]
    if return_user:
        return logit, h @ m.user_proj
    return logit


def _ln(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * (1.0 + scale)


def bert4rec_encode(m: RecsysModel, batch: Batch) -> torch.Tensor:
    x = E.lookup(m.item_table, batch["item_seq"]) + m.pos_table[None]   # (B, T, d)
    mask = batch["seq_mask"]                                            # (B, T) bool
    bias = torch.where(mask[:, None, None, :], 0.0, NEG_INF).to(x.dtype)  # (B,1,1,T)
    for bp in m.blocks:
        h = _ln(x, bp.ln1)
        q = torch.einsum("btd,dhe->bthe", h, bp.wq)
        k = torch.einsum("btd,dhe->bthe", h, bp.wk)
        v = torch.einsum("btd,dhe->bthe", h, bp.wv)
        s = torch.einsum("bthe,bshe->bhts", q, k) / (q.shape[-1] ** 0.5) + bias
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhts,bshe->bthe", a, v)
        x = x + torch.einsum("bthe,hed->btd", o, bp.wo)
        h = _ln(x, bp.ln2)
        # jax.nn.gelu defaults to the tanh approximation
        x = x + F.gelu(h @ bp.w1 + bp.b1, approximate="tanh") @ bp.w2 + bp.b2
    return _ln(x, m.final_ln)                                           # (B, T, d)


def _last_valid(m: RecsysModel, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """BERT4Rec's encoding and its row at each sequence's last valid
    position."""
    h = bert4rec_encode(m, batch)
    last = torch.clamp(batch["seq_mask"].sum(-1) - 1, min=0)
    return h, h[torch.arange(h.shape[0], device=h.device), last]


FORWARD = {"wide_deep": widedeep_forward, "autoint": autoint_forward,
           "dien": dien_forward}


@torch.no_grad()
def score(m: RecsysModel, batch: Batch) -> torch.Tensor:
    """CTR logit (B,): the serve_p99 / serve_bulk step."""
    if m.cfg.kind == "bert4rec":
        h, hu = _last_valid(m, batch)
        # score against the *observed* items (cheap serving proxy score)
        return torch.einsum("bd,bd->b", hu, h[:, 0])
    return FORWARD[m.cfg.kind](m, batch)


@torch.no_grad()
def user_repr(m: RecsysModel, batch: Batch) -> torch.Tensor:
    if m.cfg.kind == "bert4rec":
        return _last_valid(m, batch)[1]
    return FORWARD[m.cfg.kind](m, batch, return_user=True)[1]


@torch.no_grad()
def retrieval_scores(m: RecsysModel, batch: Batch) -> torch.Tensor:
    """One query against n_candidates items as a single batched dot (the
    retrieval_cand step): (B, n_candidates)."""
    u = user_repr(m, batch)                                             # (B, d)
    table = m.item_table if m.cfg.kind in ("dien", "bert4rec") else m.table
    cand = E.lookup(table, batch["candidate_ids"])                      # (N, d)
    return torch.einsum("bd,nd->bn", u, cand)


# ---------------------------------------------------------------------------
# training losses
# ---------------------------------------------------------------------------

def bert4rec_mlm_loss(m: RecsysModel, batch: Batch) -> torch.Tensor:
    """Sampled-softmax MLM at the given masked positions: each masked
    position's encoding against its label item and the shared negatives
    (the reference's `bert4rec_mlm_loss`; a dense softmax over 1M items
    is infeasible at batch 65,536)."""
    h = bert4rec_encode(m, batch)                                      # (B, T, d)
    pos = batch["mlm_positions"].long()                                # (B, M)
    hm = torch.gather(h, 1, pos[..., None].expand(-1, -1, h.shape[-1]))  # (B, M, d)
    pos_emb = E.lookup(m.item_table, batch["mlm_labels"])              # (B, M, d)
    neg_emb = E.lookup(m.item_table, batch["neg_samples"])             # (N, d)
    pos_logit = torch.einsum("bmd,bmd->bm", hm, pos_emb)
    neg_logit = torch.einsum("bmd,nd->bmn", hm, neg_emb)
    logz = torch.logsumexp(torch.cat([pos_logit[..., None], neg_logit], dim=-1), dim=-1)
    return (logz - pos_logit).mean()


def train_loss(m: RecsysModel, batch: Batch) -> torch.Tensor:
    """The reference's `train_loss`: BERT4Rec's MLM loss, else the mean
    BCE with logits in the stable form max(z, 0) - z y + log1p(exp(-|z|))."""
    if m.cfg.kind == "bert4rec":
        return bert4rec_mlm_loss(m, batch)
    logit = FORWARD[m.cfg.kind](m, batch)
    y = batch["labels"]
    return torch.mean(torch.clamp(logit, min=0) - logit * y
                      + torch.log1p(torch.exp(-logit.abs())))
