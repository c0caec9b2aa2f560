"""Decoder-only transformer as an `nn.Module`, in the JAX package's
parameter layouts (`repro/models/transformer.py:init_params`):
wq (D, H, Dh), wk/wv (D, Hkv, Dh), wo (H, Dh, D), w_gate/w_up (D, F),
w_down (F, D), so every einsum reads as the reference's does.

`forward` is the full-recompute oracle; its causal attention goes
through the flash-attention wrapper (the hand-written kernel on a CUDA
tensor, its plain version on a CPU tensor)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import LMConfig
from repro_torch.kernels.flash_attention.ops import mha_flash
from repro_torch.models import layers as L


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One pre-norm layer: attention (GQA) + dense MLP."""

    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        D, dh, dt = cfg.d_model, cfg.resolved_head_dim, cfg.torch_dtype
        kw = dict(dtype=dt, device=device)
        self.attn_norm = _frozen(torch.zeros(D, **kw))
        self.mlp_norm = _frozen(torch.zeros(D, **kw))
        self.wq = _frozen(torch.empty(D, cfg.n_heads, dh, **kw))
        self.wk = _frozen(torch.empty(D, cfg.n_kv_heads, dh, **kw))
        self.wv = _frozen(torch.empty(D, cfg.n_kv_heads, dh, **kw))
        self.wo = _frozen(torch.empty(cfg.n_heads, dh, D, **kw))
        names = ["w_up", "w_down"]
        if cfg.mlp_type in ("swiglu", "geglu"):
            names.append("w_gate")
        shapes = {"w_up": (D, cfg.d_ff), "w_gate": (D, cfg.d_ff),
                  "w_down": (cfg.d_ff, D)}
        self.mlp = nn.ParameterDict(
            {n: _frozen(torch.empty(shapes[n], **kw)) for n in names})


class Transformer(nn.Module):
    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.torch_dtype, device=device)
        self.embed = _frozen(torch.empty(cfg.vocab_size, cfg.d_model, **kw))
        self.layers = nn.ModuleList([Block(cfg, device) for _ in range(cfg.n_layers)])
        self.final_norm = _frozen(torch.zeros(cfg.d_model, **kw))
        self.lm_head = (None if cfg.tie_embeddings else
                        _frozen(torch.empty(cfg.d_model, cfg.vocab_size, **kw)))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed[tokens].to(self.cfg.torch_dtype)
        if self.cfg.tie_embeddings:
            x = x * (self.cfg.d_model ** 0.5)
        return x

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens)


def init_params(cfg: LMConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Transformer:
    """Random weights with the reference's init scales, drawn from an
    explicit `torch.Generator` (which must live on `device`).  torch does
    not reproduce JAX's PRNG: parity tests build weights in JAX and
    convert them (`models.convert.params_from_numpy`)."""
    model = Transformer(cfg, device=device)
    D, dh = cfg.d_model, cfg.resolved_head_dim
    std = D ** -0.5

    def normal_(p: torch.Tensor, s: float) -> None:
        p.normal_(generator=generator).mul_(s)

    with torch.no_grad():
        normal_(model.embed, 1.0)
        for blk in model.layers:
            normal_(blk.wq, std)
            normal_(blk.wk, std)
            normal_(blk.wv, std)
            normal_(blk.wo, (cfg.n_heads * dh) ** -0.5)
            for name, p in blk.mlp.items():
                normal_(p, cfg.d_ff ** -0.5 if name == "w_down" else std)
        if model.lm_head is not None:
            normal_(model.lm_head, std)
    return model


def attention_block(x: torch.Tensor, lp: Block, cfg: LMConfig) -> torch.Tensor:
    """Causal self-attention over (B, S, D) at positions 0..S-1."""
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)
    h = L.rms_norm(x, lp.attn_norm, cfg.norm_eps)
    q = torch.einsum("bsd,dhe->bshe", h, lp.wq)
    k = torch.einsum("bsd,dhe->bshe", h, lp.wk)
    v = torch.einsum("bsd,dhe->bshe", h, lp.wv)
    q = L.apply_rope(q, pos, cfg.rope_theta)
    k = L.apply_rope(k, pos, cfg.rope_theta)
    o = mha_flash(q, k, v.contiguous(), causal=True)
    return torch.einsum("bshe,hed->bsd", o, lp.wo)


@torch.no_grad()
def forward(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) -> logits (B, S, V)."""
    cfg = model.cfg
    x = model.embed_tokens(tokens)
    for lp in model.layers:
        x = x + attention_block(x, lp, cfg)
        x = x + L.mlp_apply(L.rms_norm(x, lp.mlp_norm, cfg.norm_eps), lp.mlp,
                            cfg.mlp_type)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return x @ model.head()
