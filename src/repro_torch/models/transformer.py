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
(`training.train_loop.trainable`).

A model built with ``tp > 1`` is one rank's shard of the model
(`sharding.specs.shard_lm_params`): ``n_heads / tp`` query heads,
``n_kv_heads / tp`` kv heads, ``d_ff / tp`` MLP columns (an MoE: ``E /
tp`` experts and the whole router) and ``vocab_size / tp`` rows of the
embedding and columns of the head.  Every path sums the attention output
projection's and the MLP's (or the rank's experts') partial products
over the ranks (`sharding.ctx.all_reduce`), enters those blocks through
`sharding.ctx.copy_to_tp` (whose backward sums the input's gradient),
looks tokens up in its vocabulary rows and sums the ranks' lookups
(exact: one rank holds each token).  The serving paths gather the ranks'
logit slices into the whole vocabulary (`logits`); the training path
keeps them and `loss_fn` takes a vocabulary-parallel log-sum-exp.  It
runs inside ``sharding.ctx.axes(mesh)`` of a mesh whose model axis has
``tp`` ranks.  With ``tp == 1`` nothing is reduced.

Where ``tp`` does not divide the kv heads (`sharding.specs.kv_dh_cut`) a
shard holds every kv head's ``head_dim / tp`` columns of wk / wv: `qkv`
gathers k and v over the model axis into whole heads, then rotates them
(RoPE pairs column i with i + Dh/2, on other ranks before the gather),
and attention reads the kv heads the rank's query heads read (`own_kv`:
whole GQA groups, so the flash kernels, K6 and the plain attention see
an ordinary GQA call).  The serving steps' dense cache then splits the
sequence (`sharding.specs.lm_cache_spec`): over ``model``, or over every
axis where every data rank holds the whole batch (a decode batch the data
axis does not divide; ``dp_batch=False``), also where the kv heads divide
(the shards' heads are then gathered), each rank holding a block
of positions with every kv head whole (`seq_axes`).  `prefill` returns
the rank's block; `decode_step` writes a row's new k / v on the rank
whose block holds its position, attends every query head (gathered) to
its block with the block's global positions, merges the blocks by their
log-sum-exp (`sharding.ctx.merge_attention`, flash-decoding) and keeps
its own heads for ``wo``.

A shard may also be cut over the data axes (``dp > 1``: an MoE's
expert-ff columns, ``d_ff / dp`` of w_gate / w_up and rows of w_down;
with ``din``, serve mode's d_model rows of wq / wk / wv and columns of
wo, ``d_model / dp``): each layer gathers those weights over the data
axes just before its products (`sharding.ctx.gather_data`; the experts
a chunk at a time, `layers.moe_apply`) and drops them after, so no whole
copy lives between layers.

Under data parallelism the steps take the rank's rows of a batch cut over
the data axis (``dp_batch=True``, the default; False where every data
rank holds the whole batch, as a decode batch the data axis does not
divide): the MoE's capacity, slots and aux term are then the whole
batch's (`layers.moe_route`), and `loss_fn` returns the rank's share."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.kernels.flash_attention.ops import mha_flash
from repro_torch.kernels.flash_attention.ref import mha_flash_ref
from repro_torch.models import layers as L
from repro_torch.sharding import ctx as CTX
from repro_torch.sharding.specs import kv_dh_cut


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One pre-norm layer: attention (GQA) + a dense MLP (`mlp`) or, when
    `cfg.moe` is set, experts (`moe`: router (D, E) fp32 whatever the
    model's dtype, w_gate / w_up (E, D, F), w_down (E, F, D))."""

    def __init__(self, cfg: LMConfig, device=None, tp: int = 1, tp_rank: int = 0,
                 dp: int = 1, din: bool = False):
        super().__init__()
        D, dh, dt = cfg.d_model, cfg.resolved_head_dim, cfg.torch_dtype
        kw = dict(dtype=dt, device=device)
        H, F = cfg.n_heads // tp, cfg.d_ff // tp
        # the data-axis cuts (the module docstring): d_model of the
        # attention's weights, an MoE's expert-ff columns
        self.din_cut = din and dp > 1
        self.ff_cut = cfg.moe is not None and dp > 1
        Din = D // dp if self.din_cut else D
        # a Dh-cut shard: every kv head, dh / tp columns; `kv_keep` the kv
        # heads its query heads read
        self.kv_cut = kv_dh_cut(cfg, tp)
        Hkv, dk = (cfg.n_kv_heads, dh // tp) if self.kv_cut else (cfg.n_kv_heads // tp, dh)
        group = cfg.n_heads // cfg.n_kv_heads
        first = tp_rank * H // group
        self.kv_keep = slice(first, first + max(1, H // group)) if self.kv_cut else None
        self.attn_norm = _frozen(torch.zeros(D, **kw))
        self.mlp_norm = _frozen(torch.zeros(D, **kw))
        self.wq = _frozen(torch.empty(Din, H, dh, **kw))
        self.wk = _frozen(torch.empty(Din, Hkv, dk, **kw))
        self.wv = _frozen(torch.empty(Din, Hkv, dk, **kw))
        self.wo = _frozen(torch.empty(H, dh, Din, **kw))
        names = ["w_up", "w_down"]
        if cfg.mlp_type in ("swiglu", "geglu"):
            names.append("w_gate")
        if cfg.moe is None:
            shapes = {"w_up": (D, F), "w_gate": (D, F), "w_down": (F, D)}
            self.mlp = nn.ParameterDict(
                {n: _frozen(torch.empty(shapes[n], **kw)) for n in names})
        else:
            E, Fe = cfg.moe.n_experts // tp, cfg.moe.d_ff // dp
            shapes = {"w_up": (E, D, Fe), "w_gate": (E, D, Fe), "w_down": (E, Fe, D)}
            router = torch.empty(D, cfg.moe.n_experts, dtype=torch.float32, device=device)
            self.moe = nn.ParameterDict(
                {"router": _frozen(router),
                 **{n: _frozen(torch.empty(shapes[n], **kw)) for n in names}})


class Transformer(nn.Module):
    """The whole model, or with ``tp > 1`` rank ``tp_rank``'s shard of it
    (the module docstring)."""

    def __init__(self, cfg: LMConfig, device=None, tp: int = 1, tp_rank: int = 0,
                 dp: int = 1, din: bool = False):
        super().__init__()
        self.cfg = cfg
        self.tp, self.tp_rank = int(tp), int(tp_rank)
        V = cfg.vocab_size // self.tp
        kw = dict(dtype=cfg.torch_dtype, device=device)
        self.embed = _frozen(torch.empty(V, cfg.d_model, **kw))
        self.layers = nn.ModuleList([Block(cfg, device, self.tp, self.tp_rank, dp, din)
                                     for _ in range(cfg.n_layers)])
        self.final_norm = _frozen(torch.zeros(cfg.d_model, **kw))
        self.lm_head = (None if cfg.tie_embeddings else
                        _frozen(torch.empty(cfg.d_model, V, **kw)))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        if CTX.tp_size() != self.tp:
            raise ValueError(f"a model split over {self.tp} ranks runs inside a mesh whose "
                             f"model axis has {self.tp} ranks, not {CTX.tp_size()} "
                             "(sharding.ctx.axes)")
        if self.tp == 1:
            x = self.embed[tokens].to(self.cfg.torch_dtype)
        else:
            # this rank's vocabulary rows; the ranks' lookups summed
            V = self.embed.shape[0]
            local = tokens - self.tp_rank * V
            own = (local >= 0) & (local < V)
            x = self.embed[local.clamp(0, V - 1)].to(self.cfg.torch_dtype)
            x = CTX.all_reduce(torch.where(own[..., None], x, torch.zeros_like(x)))
        if self.cfg.tie_embeddings:
            x = x * (self.cfg.d_model ** 0.5)
        return x

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """The head over normalised rows x (..., D) -> (..., vocab_size):
        a shard's vocabulary slices gathered from every rank (fp32)."""
        out = x @ self.head()
        return out if self.tp == 1 else CTX.gather_vocab(out, self.cfg.vocab_size)

    def whole(self, what: str) -> None:
        """Raise unless this is the whole model: `what` reads every vocabulary
        row or head, which a shard does not hold."""
        if self.tp != 1:
            raise ValueError(f"{what} needs the whole model, and this is rank "
                             f"{self.tp_rank}'s shard of {self.tp}: pass what it reads "
                             "from the whole model instead")

    def forward(self, tokens: torch.Tensor, kernels: bool) -> torch.Tensor:
        return forward(self, tokens, kernels)


def init_params(cfg: LMConfig, generator: Optional[torch.Generator] = None,
                device="cuda", tp: int = 1, tp_rank: int = 0,
                keep: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None,
                dp: int = 1, din: bool = False) -> Transformer:
    """Random weights with the reference's init scales, drawn from an
    explicit `torch.Generator` (which must live on `device`).  torch does
    not reproduce JAX's PRNG: parity tests build weights in JAX and
    convert them (`models.convert.params_from_numpy`).

    With `keep`, the model is rank `tp_rank`'s shard of `tp` (and of the
    data-axis cuts `dp` / `din`): each parameter is drawn whole, with the
    same draws as the whole model's, and ``keep(name, full)`` returns the
    rank's block of it (`sharding.specs.init_sharded_params`), so the rank
    holds one whole parameter at a time."""
    if (tp != 1 or dp != 1) and keep is None:
        raise ValueError("a shard's parameters are cut from whole draws: pass keep")
    model = Transformer(cfg, device=device, tp=tp, tp_rank=tp_rank, dp=dp, din=din)
    whole = model if keep is None else Transformer(cfg, device="meta")
    D, dh = cfg.d_model, cfg.resolved_head_dim
    std = D ** -0.5

    def normal_(name: str, s: float) -> None:
        p = model.get_parameter(name)
        full = p if keep is None else torch.empty(
            whole.get_parameter(name).shape, dtype=p.dtype, device=device)
        full.normal_(generator=generator).mul_(s)
        if keep is not None:
            p.copy_(keep(name, full))

    with torch.no_grad():
        normal_("embed", 1.0)
        for i, blk in enumerate(model.layers):
            normal_(f"layers.{i}.wq", std)
            normal_(f"layers.{i}.wk", std)
            normal_(f"layers.{i}.wv", std)
            normal_(f"layers.{i}.wo", (cfg.n_heads * dh) ** -0.5)
            if cfg.moe is None:
                for name in blk.mlp:
                    normal_(f"layers.{i}.mlp.{name}",
                            cfg.d_ff ** -0.5 if name == "w_down" else std)
            else:
                # the reference's `moe_init` draws: router (D, E) fp32, then
                # w_up, w_down, w_gate, at D^-1/2 but w_down's F^-1/2
                names = ["router", "w_up", "w_down"] + (["w_gate"] if "w_gate" in blk.moe
                                                        else [])
                for name in names:
                    normal_(f"layers.{i}.moe.{name}",
                            cfg.moe.d_ff ** -0.5 if name == "w_down" else std)
        if model.lm_head is not None:
            normal_("lm_head", std)
    return model


def qkv(x: torch.Tensor, lp: Block, cfg: LMConfig,
        positions) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, D) at `positions` (broadcastable to (B, S)) -> q, k (both
    rotated), v: (B, S, H, Dh).  A Dh-cut shard's k and v have every kv
    head whole: gathered over the model axis (backward a reduce-scatter),
    then rotated."""
    h = CTX.copy_to_tp(L.rms_norm(x, lp.attn_norm, cfg.norm_eps))
    q = torch.einsum("bsd,dhe->bshe", h, _din(lp, lp.wq, 0))
    k = torch.einsum("bsd,dhe->bshe", h, _din(lp, lp.wk, 0))
    v = torch.einsum("bsd,dhe->bshe", h, _din(lp, lp.wv, 0))
    if lp.kv_cut:
        k, v = CTX.gather_last(k), CTX.gather_last(v)
    return (L.apply_rope(q, positions, cfg.rope_theta),
            L.apply_rope(k, positions, cfg.rope_theta), v)


def _din(lp: Block, w: torch.Tensor, dim: int) -> torch.Tensor:
    """`w` with its d_model dimension `dim` whole: gathered over the data
    axes where the shard holds its block of it (serve mode of an MoE)."""
    return CTX.gather_data(w, dim) if lp.din_cut else w


def out_proj(o: torch.Tensor, lp: Block) -> torch.Tensor:
    """The attention output (B, S, H, Dh) through ``wo``, the shards'
    partial products summed over the model axis."""
    return CTX.all_reduce(torch.einsum("bshe,hed->bsd", o, _din(lp, lp.wo, 2)))


def own_kv(lp: Block, k: torch.Tensor, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kv heads this rank's query heads read (all of `qkv`'s but on a
    Dh-cut shard)."""
    if lp.kv_cut:
        return k[:, :, lp.kv_keep], v[:, :, lp.kv_keep]
    return k, v


def attention_block(x: torch.Tensor, lp: Block, cfg: LMConfig,
                    kernels: bool) -> torch.Tensor:
    """Causal self-attention over (B, S, D) at positions 0..S-1; `kernels`
    False runs the flash kernel's plain version on any device."""
    q, k, v = qkv(x, lp, cfg, torch.arange(x.shape[1], device=x.device))
    k, v = own_kv(lp, k, v)
    o = (mha_flash if kernels else mha_flash_ref)(q, k, v.contiguous(), causal=True)
    return out_proj(o, lp)


@torch.no_grad()
def forward(model: Transformer, tokens: torch.Tensor, kernels: bool) -> torch.Tensor:
    """tokens: (B, S) -> logits (B, S, V)."""
    cfg = model.cfg
    x = model.embed_tokens(tokens)
    for lp in model.layers:
        x = x + attention_block(x, lp, cfg, kernels)
        x = x + CTX.all_reduce(L.mlp_apply(L.rms_norm(x, lp.mlp_norm, cfg.norm_eps),
                                           lp.mlp, cfg.mlp_type))
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return model.logits(x)


# ------------------------------------------------------- LM serving steps
Cache = Dict[str, torch.Tensor]


def prefill_attention_block(x: torch.Tensor, lp: Block, cfg: LMConfig,
                            positions: np.ndarray):
    """The reference's `_attention_block`: causal (and windowed) chunked
    attention over x (B, S, D) at `positions` (host numpy: the attention
    plans its chunks from them).  -> (output (B, S, D), (k, v) as `qkv`
    gives them)."""
    q, k, v = qkv(x, lp, cfg, positions)
    ka, va = own_kv(lp, k, v)
    o = L.chunked_attention(q, ka, va, causal=True, q_positions=positions,
                            kv_positions=positions, sliding_window=cfg.sliding_window,
                            q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk)
    return out_proj(o, lp), (k, v)


def ffn_block(x: torch.Tensor, lp: Block, cfg: LMConfig, dp_batch: bool = True):
    """The reference's `_ffn_block`: pre-norm dense MLP, or the MoE over
    the B*S tokens.  -> (output (B, S, D), aux (0 for a dense MLP))."""
    h = L.rms_norm(x, lp.mlp_norm, cfg.norm_eps)
    if cfg.moe is not None:
        B, S, D = h.shape
        y, aux = L.moe_apply(h.reshape(B * S, D), lp.moe, n_experts=cfg.moe.n_experts,
                             top_k=cfg.moe.top_k, capacity_factor=cfg.moe.capacity_factor,
                             mlp_type=cfg.mlp_type, dp_batch=dp_batch, ff_cut=lp.ff_cut,
                             remat=cfg.remat)
        return y.reshape(B, S, D), aux
    return CTX.all_reduce(L.mlp_apply(CTX.copy_to_tp(h), lp.mlp, cfg.mlp_type)), 0.0


def _last_logits(model: Transformer, x: torch.Tensor) -> torch.Tensor:
    return model.logits(L.rms_norm(x, model.final_norm, model.cfg.norm_eps))


def kv_heads(model: Transformer) -> int:
    """The kv heads the model holds (a shard: its own; a Dh-cut shard
    every one)."""
    return model.layers[0].wk.shape[1]


def seq_axes(model: Transformer, dp_batch: bool = True) -> tuple:
    """The mesh axes a serving step's dense cache splits its sequence over
    (`sharding.specs.lm_cache_spec`): every axis for a decode batch that
    the data axis does not divide (not `dp_batch`), ``model`` where the
    shard cuts the kv heads' Dh, else none."""
    if CTX.current() is None:
        return ()
    if not dp_batch and CTX.dp_size() > 1:
        return CTX.every_axis()
    return ("model",) if model.layers[0].kv_cut else ()


def _every_kv_head(lp: Block, k: torch.Tensor, v: torch.Tensor):
    """A shard's kv heads (B, S, Hkv / tp, Dh) -> every kv head, gathered
    over the model axis (a Dh-cut shard's `qkv` has them all already)."""
    if lp.kv_cut:
        return k, v
    return CTX.all_gather(k, "model", 2), CTX.all_gather(v, "model", 2)


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor,
            dp_batch: bool = True) -> Tuple[torch.Tensor, Cache]:
    """Prompt prefill (the reference's `transformer.prefill`): tokens
    (B, S) -> the last position's logits (B, V) and the cache {k, v}:
    (L, B, S, Hkv, Dh), post-RoPE, in the model's dtype (a shard: its
    Hkv / tp heads, and the whole vocabulary's logits; a rank of a
    sequence split over `seq_axes`: its block of positions with every kv
    head, gathered where the shard holds some).  The
    head runs on the last row only (the reference slices it from (B, S,
    V) logits, 16.8 GB in bf16 at S = 32768 and V = 256000);
    normalisation is per row, so the two agree."""
    cfg = model.cfg
    B, S = tokens.shape
    x = model.embed_tokens(tokens)
    positions = np.arange(S)
    axes = seq_axes(model, dp_batch)
    n, c = CTX.block_of(axes)
    if S % n:
        raise ValueError(f"a prompt of {S} tokens does not split into {n} cache blocks")
    blk = slice(c * (S // n), (c + 1) * (S // n))
    heads = cfg.n_kv_heads if axes else kv_heads(model)
    shape = (cfg.n_layers, B, S // n, heads, cfg.resolved_head_dim)
    cache = {"k": x.new_empty(shape), "v": x.new_empty(shape)}
    for i, lp in enumerate(model.layers):
        a, (k, v) = prefill_attention_block(x, lp, cfg, positions)
        if axes:                         # the heads of every position, then the block
            k, v = _every_kv_head(lp, k, v)
        cache["k"][i], cache["v"][i] = k[:, blk], v[:, blk]
        x = x + a
        del a, k, v
        x = x + ffn_block(x, lp, cfg, dp_batch)[0]
    return _last_logits(model, x[:, -1]), cache


@torch.no_grad()
def decode_step(model: Transformer, tokens: torch.Tensor, cache: Cache,
                positions: torch.Tensor, dp_batch: bool = True) -> Tuple[torch.Tensor, Cache]:
    """One decode step (the reference's `transformer.decode_step`): tokens
    (B, 1) at `positions` (B,), the rows' current lengths, against
    cache {k, v}: (L, B, S, Hkv, Dh) (a rank of a split sequence: its
    block of positions, `seq_axes`).  -> (logits (B, V), cache).

    The new k / v are written at `positions` IN PLACE into the caller's
    cache tensors, and the same dict is returned: the reference's
    functional update would hold two caches at once."""
    cfg = model.cfg
    B = tokens.shape[0]
    x = model.embed_tokens(tokens[:, 0])[:, None]                  # (B, 1, D)
    pos = positions.to(x.device, torch.long)
    rows = torch.arange(B, device=x.device)
    axes = seq_axes(model, dp_batch)
    for i, lp in enumerate(model.layers):
        q, k, v = qkv(x, lp, cfg, pos[:, None])
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        if axes:
            o = _split_decode(model, lp, q, k, v, k_cache, v_cache, pos, rows, axes)
        else:
            k_cache[rows, pos] = k[:, 0]
            v_cache[rows, pos] = v[:, 0]
            o = L.decode_attention(q, k_cache, v_cache, pos + 1,
                                   sliding_window=cfg.sliding_window)
        x = x + out_proj(o, lp)
        x = x + ffn_block(x, lp, cfg, dp_batch)[0]
    return _last_logits(model, x[:, 0]), cache


def _split_decode(model: Transformer, lp: Block, q, k, v, k_cache, v_cache, pos, rows,
                  axes: tuple) -> torch.Tensor:
    """One layer's decode attention on a rank's block of a cache split over
    `axes` (the module docstring).  -> the rank's heads' output (B, 1,
    H / tp, Dh)."""
    _, c = CTX.block_of(axes)
    Sb = k_cache.shape[1]
    k, v = _every_kv_head(lp, k, v)
    local = pos - c * Sb
    own = ((local >= 0) & (local < Sb))[:, None, None]
    at = local.clamp(0, Sb - 1)
    k_cache[rows, at] = torch.where(own, k[:, 0], k_cache[rows, at])
    v_cache[rows, at] = torch.where(own, v[:, 0], v_cache[rows, at])
    m, s, o = L.decode_attention_partial(CTX.all_gather(q, "model", 2), k_cache, v_cache,
                                         pos + 1, offset=c * Sb,
                                         sliding_window=model.cfg.sliding_window)
    o = CTX.merge_attention(m, s, o, axes)                           # (B, H, Dh) fp32
    H = lp.wq.shape[1]
    return o[:, None, model.tp_rank * H:(model.tp_rank + 1) * H].to(q.dtype)


# ------------------------------------------------------- training path
def _train_layer(x: torch.Tensor, lp: Block, cfg: LMConfig, positions: np.ndarray,
                 dp_batch: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer of the reference's scan body: causal (and windowed)
    attention through `flash_attention` at `positions` (host numpy), then
    the FFN.  -> (x, aux)."""
    q, k, v = qkv(x, lp, cfg, positions)
    k, v = own_kv(lp, k, v)
    o = L.flash_attention(q, k, v, causal=True, q_positions=positions,
                          kv_positions=positions, sliding_window=cfg.sliding_window,
                          q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk)
    x = x + out_proj(o, lp)
    y, aux = ffn_block(x, lp, cfg, dp_batch)
    return x + y, torch.as_tensor(aux, dtype=torch.float32, device=x.device)


def _remat_layer(mesh, *args) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_train_layer` inside `mesh`: the backward recomputes a remat layer
    on autograd's device thread, which does not see the caller's mesh
    context, and the layer's collectives must run there too."""
    if mesh is None:
        return _train_layer(*args)
    with CTX.axes(mesh):
        return _train_layer(*args)


def forward_train(model: Transformer, tokens: torch.Tensor,
                  rows: Optional[torch.Tensor] = None,
                  dp_batch: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's `forward`: tokens (B, S) -> (logits (B, S, V), the
    summed MoE aux term), differentiable.  With `rows` (B,) only those
    positions' logits, (B, V): the head is per row, so they equal the
    rows of the full logits.  A shard returns its vocabulary slice of the
    logits, (..., V / tp), for `loss_fn`'s vocabulary-parallel loss."""
    cfg = model.cfg
    x = model.embed_tokens(tokens)
    positions = np.arange(tokens.shape[1])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in model.layers:
        if cfg.remat and torch.is_grad_enabled():
            x, a = checkpoint(_remat_layer, CTX.current(), x, lp, cfg, positions, dp_batch,
                              use_reentrant=False)
        else:
            x, a = _train_layer(x, lp, cfg, positions, dp_batch)
        aux = aux + a
    if rows is not None:
        x = x[torch.arange(x.shape[0], device=x.device), rows]
    x = CTX.copy_to_tp(L.rms_norm(x, model.final_norm, cfg.norm_eps))
    return x @ model.head(), aux


def loss_fn(model: Transformer, tokens: torch.Tensor, labels: torch.Tensor,
            dp_batch: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's `loss_fn`: next-token cross entropy on fp32 logits
    plus 0.01 x the MoE aux term.  -> (loss, nll).

    A shard computes it vocabulary-parallel: the max over its logit slice
    reduced by MAX over the model axis, the sum of exponentials and the
    gold logit (from the rank that owns the label) summed over it; the
    (B, S, V) logits are never gathered.  fp32 throughout, so it differs
    from the whole vocabulary's `logsumexp` only in the order of sums.
    Under data parallelism both are the means over the rank's rows (the
    aux term is already the whole batch's); their mean over the data axis
    is the batch's."""
    logits, aux = forward_train(model, tokens, dp_batch=dp_batch)
    logits = logits.float()
    if model.tp == 1:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    else:
        V = logits.shape[-1]
        m = CTX.max_over_tp(logits.detach().amax(-1))
        logz = m + torch.log(CTX.all_reduce((logits - m[..., None]).exp().sum(-1)))
        local = labels.long() - model.tp_rank * V
        own = (local >= 0) & (local < V)
        gold = torch.gather(logits, -1, local.clamp(0, V - 1)[..., None])[..., 0]
        gold = CTX.all_reduce(torch.where(own, gold, torch.zeros_like(gold)))
    nll = (logz - gold).mean()
    return nll + 0.01 * aux, nll
