"""Decoder-only transformer as an `nn.Module`, in the JAX package's
parameter layouts (`repro/models/transformer.py:init_params`):
wq (D, H, Dh), wk/wv (D, Hkv, Dh), wo (H, Dh, D), w_gate/w_up (D, F),
w_down (F, D), so every einsum reads as the reference's does.

`forward` is the RcLLM full-recompute oracle; its causal attention goes
through the flash-attention wrapper (the hand-written kernel on a CUDA
tensor, its plain version on a CPU tensor).

`prefill` and `decode_step` are the LM architectures' serving steps, the
counterparts of the reference's `transformer.prefill` / `decode_step`
(dense or MoE blocks, sliding window, tied embeddings), over a dense KV
cache {k, v}: (L, B, S, Hkv, Dh) of post-RoPE keys.  Their attention is
plain torch (`layers.chunked_attention`, `layers.decode_attention`), as
the reference's is jnp.

`forward_train` and `loss_fn` are the training path (the reference's
`forward` and `loss_fn`): differentiable, attention through
`layers.flash_attention` (kernel K6 in the backward on the card), each
layer recomputed in the backward under `cfg.remat`.  The parameters take
gradients only where a caller turns them on
(`training.train_loop.trainable`)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.kernels.flash_attention.ops import mha_flash
from repro_torch.models import layers as L


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One pre-norm layer: attention (GQA) + a dense MLP (`mlp`) or, when
    `cfg.moe` is set, experts (`moe`: router (D, E) fp32 whatever the
    model's dtype, w_gate / w_up (E, D, F), w_down (E, F, D))."""

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
        if cfg.moe is None:
            shapes = {"w_up": (D, cfg.d_ff), "w_gate": (D, cfg.d_ff),
                      "w_down": (cfg.d_ff, D)}
            self.mlp = nn.ParameterDict(
                {n: _frozen(torch.empty(shapes[n], **kw)) for n in names})
        else:
            E, Fe = cfg.moe.n_experts, cfg.moe.d_ff
            shapes = {"w_up": (E, D, Fe), "w_gate": (E, D, Fe), "w_down": (E, Fe, D)}
            router = torch.empty(D, E, dtype=torch.float32, device=device)
            self.moe = nn.ParameterDict(
                {"router": _frozen(router),
                 **{n: _frozen(torch.empty(shapes[n], **kw)) for n in names}})


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
            if cfg.moe is None:
                for name, p in blk.mlp.items():
                    normal_(p, cfg.d_ff ** -0.5 if name == "w_down" else std)
            else:
                for name, t in L.moe_init(generator, D, cfg.moe, cfg.mlp_type,
                                          cfg.torch_dtype, device).items():
                    blk.moe[name].copy_(t)
        if model.lm_head is not None:
            normal_(model.lm_head, std)
    return model


def qkv(x: torch.Tensor, lp: Block, cfg: LMConfig,
        positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, D) at `positions` (broadcastable to (B, S)) -> q, k (both
    rotated), v: (B, S, H, Dh)."""
    h = L.rms_norm(x, lp.attn_norm, cfg.norm_eps)
    q = torch.einsum("bsd,dhe->bshe", h, lp.wq)
    k = torch.einsum("bsd,dhe->bshe", h, lp.wk)
    v = torch.einsum("bsd,dhe->bshe", h, lp.wv)
    return (L.apply_rope(q, positions, cfg.rope_theta),
            L.apply_rope(k, positions, cfg.rope_theta), v)


def attention_block(x: torch.Tensor, lp: Block, cfg: LMConfig) -> torch.Tensor:
    """Causal self-attention over (B, S, D) at positions 0..S-1."""
    q, k, v = qkv(x, lp, cfg, torch.arange(x.shape[1], device=x.device))
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


# ------------------------------------------------------- LM serving steps
Cache = Dict[str, torch.Tensor]


def prefill_attention_block(x: torch.Tensor, lp: Block, cfg: LMConfig,
                            positions: torch.Tensor):
    """The reference's `_attention_block`: causal (and windowed) chunked
    attention over x (B, S, D).  -> (output (B, S, D), (k, v))."""
    q, k, v = qkv(x, lp, cfg, positions)
    o = L.chunked_attention(q, k, v, causal=True, q_positions=positions,
                            kv_positions=positions, sliding_window=cfg.sliding_window,
                            q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk)
    return torch.einsum("bshe,hed->bsd", o, lp.wo), (k, v)


def ffn_block(x: torch.Tensor, lp: Block, cfg: LMConfig):
    """The reference's `_ffn_block`: pre-norm dense MLP, or the MoE over
    the B*S tokens.  -> (output (B, S, D), aux (0 for a dense MLP))."""
    h = L.rms_norm(x, lp.mlp_norm, cfg.norm_eps)
    if cfg.moe is not None:
        B, S, D = h.shape
        y, aux = L.moe_apply(h.reshape(B * S, D), lp.moe, n_experts=cfg.moe.n_experts,
                             top_k=cfg.moe.top_k, capacity_factor=cfg.moe.capacity_factor,
                             mlp_type=cfg.mlp_type)
        return y.reshape(B, S, D), aux
    return L.mlp_apply(h, lp.mlp, cfg.mlp_type), 0.0


def _last_logits(model: Transformer, x: torch.Tensor) -> torch.Tensor:
    return L.rms_norm(x, model.final_norm, model.cfg.norm_eps) @ model.head()


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """Prompt prefill (the reference's `transformer.prefill`): tokens
    (B, S) -> the last position's logits (B, V) and the cache {k, v}:
    (L, B, S, Hkv, Dh), post-RoPE, in the model's dtype.  The head runs on
    the last row only (the reference slices it from (B, S, V) logits,
    16.8 GB in bf16 at S = 32768 and V = 256000); normalisation is per
    row, so the two agree."""
    cfg = model.cfg
    B, S = tokens.shape
    x = model.embed_tokens(tokens)
    positions = torch.arange(S, device=x.device)
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.resolved_head_dim)
    cache = {"k": x.new_empty(shape), "v": x.new_empty(shape)}
    for i, lp in enumerate(model.layers):
        a, (k, v) = prefill_attention_block(x, lp, cfg, positions)
        cache["k"][i], cache["v"][i] = k, v
        x = x + a
        del a, k, v
        x = x + ffn_block(x, lp, cfg)[0]
    return _last_logits(model, x[:, -1]), cache


@torch.no_grad()
def decode_step(model: Transformer, tokens: torch.Tensor, cache: Cache,
                positions: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """One decode step (the reference's `transformer.decode_step`): tokens
    (B, 1) at `positions` (B,), the rows' current lengths, against
    cache {k, v}: (L, B, S, Hkv, Dh).  -> (logits (B, V), cache).

    The new k / v are written at `positions` IN PLACE into the caller's
    cache tensors, and the same dict is returned: the reference's
    functional update would hold two caches at once."""
    cfg = model.cfg
    B = tokens.shape[0]
    x = model.embed_tokens(tokens[:, 0])[:, None]                  # (B, 1, D)
    pos = positions.to(x.device, torch.long)
    rows = torch.arange(B, device=x.device)
    for i, lp in enumerate(model.layers):
        q, k, v = qkv(x, lp, cfg, pos[:, None])
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        k_cache[rows, pos] = k[:, 0]
        v_cache[rows, pos] = v[:, 0]
        o = L.decode_attention(q, k_cache, v_cache, pos + 1,
                               sliding_window=cfg.sliding_window)
        x = x + torch.einsum("bshe,hed->bsd", o, lp.wo)
        x = x + ffn_block(x, lp, cfg)[0]
    return _last_logits(model, x[:, 0]), cache


# ------------------------------------------------------- training path
def _train_layer(x: torch.Tensor, lp: Block, cfg: LMConfig,
                 positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer of the reference's scan body: causal (and windowed)
    attention through `flash_attention`, then the FFN.  -> (x, aux)."""
    q, k, v = qkv(x, lp, cfg, positions)
    o = L.flash_attention(q, k, v, causal=True, q_positions=positions,
                          kv_positions=positions, sliding_window=cfg.sliding_window,
                          q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk)
    x = x + torch.einsum("bshe,hed->bsd", o, lp.wo)
    y, aux = ffn_block(x, lp, cfg)
    return x + y, torch.as_tensor(aux, dtype=torch.float32, device=x.device)


def forward_train(model: Transformer, tokens: torch.Tensor,
                  rows: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's `forward`: tokens (B, S) -> (logits (B, S, V), the
    summed MoE aux term), differentiable.  With `rows` (B,) only those
    positions' logits, (B, V): the head is per row, so they equal the
    rows of the full logits."""
    cfg = model.cfg
    x = model.embed_tokens(tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in model.layers:
        if cfg.remat and torch.is_grad_enabled():
            x, a = checkpoint(_train_layer, x, lp, cfg, positions, use_reentrant=False)
        else:
            x, a = _train_layer(x, lp, cfg, positions)
        aux = aux + a
    if rows is not None:
        x = x[torch.arange(x.shape[0], device=x.device), rows]
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return x @ model.head(), aux


def loss_fn(model: Transformer, tokens: torch.Tensor,
            labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's `loss_fn`: next-token cross entropy on fp32 logits
    plus 0.01 x the MoE aux term.  -> (loss, nll)."""
    logits, aux = forward_train(model, tokens)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = (logz - gold).mean()
    return nll + 0.01 * aux, nll
