"""Model configurations for the port: the JAX package's `MoEConfig`,
`RecsysConfig` and `GNNConfig` field for field, the subset of its
`LMConfig` the port reads (dense or MoE, sliding window, attention
chunks, `remat` and `optimizer` for training, and the serving path's
attention backend and decode kernel, whose values name the port's
routes; the mesh knobs stay with the reference), and `reduced()` for all
three families."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

# The serving path's execution knobs (`core.engine.attn_uses_kernels`,
# `decode_uses_paged`).  `LMConfig` owns the fields; the serving API
# validates against the same tuples.
ATTN_BACKENDS = ("auto", "plain", "cuda")
DECODE_KERNELS = ("auto", "gather", "paged")


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden dim
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclass(frozen=True)
class LMConfig:
    """Decoder-only transformer LM (dense or MoE)."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                      # dense MLP hidden (ignored if moe set)
    vocab_size: int
    head_dim: Optional[int] = None  # default: d_model // n_heads
    mlp_type: str = "swiglu"        # swiglu | geglu | relu2 | gelu
    moe: Optional[MoEConfig] = None
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    # prefill attention tiles (`models.layers.chunked_attention`)
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    # training: recompute each layer in the backward pass
    # (`transformer.forward_train`), and the train step's optimizer
    # (`training.optimizer.get`: adamw | adafactor)
    remat: bool = True
    optimizer: str = "adamw"
    # serving attention backend: "cuda" runs the hand-written kernels of
    # the offline build, the cached-KV assembly and the selective layers
    # (flash, block gather, selective), "plain" their plain PyTorch
    # versions on the model's device, "auto" the kernels for a CUDA model
    # and the plain versions for a CPU one.  Layer 0's Eq. 3 scoring is
    # plain torch under every backend (it needs the probabilities)
    attn_backend: str = "auto"
    # serving decode: "auto" follows the backend, "paged" pins the
    # paged-decode kernel and "gather" its plain version (which gathers
    # the pages), whatever the backend: a decode-only difference cannot
    # hide behind a prefill one
    decode_kernel: str = "auto"

    def __post_init__(self):
        # frozen: dataclasses.replace re-runs this, so no invalid knob can
        # come in through a replace
        if self.attn_backend not in ATTN_BACKENDS:
            raise ValueError(f"attn_backend={self.attn_backend!r} not in {ATTN_BACKENDS}")
        if self.decode_kernel not in DECODE_KERNELS:
            raise ValueError(f"decode_kernel={self.decode_kernel!r} not in {DECODE_KERNELS}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    def _count(self, experts: int) -> int:
        """Parameters with `experts` of each layer's experts counted."""
        dh = self.resolved_head_dim
        attn = self.d_model * (self.n_heads * dh) * 2                 # wq, wo
        attn += self.d_model * (self.n_kv_heads * dh) * 2             # wk, wv
        n_mats = 3 if self.mlp_type in ("swiglu", "geglu") else 2
        if self.moe is not None:
            ffn = experts * n_mats * self.d_model * self.moe.d_ff
            ffn += self.d_model * self.moe.n_experts                  # router
        else:
            ffn = n_mats * self.d_model * self.d_ff
        per_layer = attn + ffn + 2 * self.d_model
        embed = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + embed + self.d_model

    def param_count(self) -> int:
        """Total parameters (embedding included)."""
        return self._count(self.moe.n_experts if self.moe is not None else 0)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only top-k experts count)."""
        return self._count(self.moe.top_k if self.moe is not None else 0)


@dataclass(frozen=True)
class RecsysConfig:
    """Sparse-embedding CTR / sequential recommendation models."""
    name: str
    kind: str                       # wide_deep | autoint | dien | bert4rec
    embed_dim: int
    n_dense: int = 13
    # CTR models: per-field vocab sizes (huge sparse tables)
    field_vocabs: Tuple[int, ...] = ()
    mlp_dims: Tuple[int, ...] = ()
    # autoint
    n_attn_layers: int = 0
    n_heads: int = 0
    d_attn: int = 0
    # dien
    seq_len: int = 0
    gru_dim: int = 0
    # bert4rec
    n_blocks: int = 0
    n_items: int = 0
    n_cates: int = 0
    dtype: str = "float32"
    use_pallas: bool = False
    # RcLLM analogue: sharded embedding store w/ affinity routing
    rcllm_enabled: bool = False

    def table_rows(self) -> int:
        rows = sum(self.field_vocabs)
        rows += self.n_items + self.n_cates
        return rows


@dataclass(frozen=True)
class GNNConfig:
    """SchNet-style interaction network."""
    name: str
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    n_atom_types: int = 100
    readout: str = "sum"
    dtype: str = "float32"
    rcllm_enabled: bool = False


def reduced(cfg):
    """A CPU-sized variant of a config on the same code path, as the
    reference's `reduced()`.  LM: 2 layers, d_model 64, 4 / 2 heads of
    16, d_ff 128, vocabulary 512, fp32, attention chunks of 32, no
    sliding window, no remat; an MoE keeps its capacity factor with 4
    experts, top-2, d_ff 64.  Recsys: vocabularies capped at 1000, items
    at 1000, categories at 50 and the sequence at 16; every width stays.
    GNN: 2 interactions, 16 hidden, 8 radial functions."""
    if isinstance(cfg, LMConfig):
        moe = None
        if cfg.moe is not None:
            moe = MoEConfig(n_experts=4, top_k=2, d_ff=64,
                            capacity_factor=cfg.moe.capacity_factor)
        return dataclasses.replace(
            cfg, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=512, moe=moe, dtype="float32",
            attn_q_chunk=32, attn_kv_chunk=32, sliding_window=None,
            remat=False)
    if isinstance(cfg, GNNConfig):
        return dataclasses.replace(cfg, n_interactions=2, d_hidden=16, n_rbf=8)
    if not isinstance(cfg, RecsysConfig):
        raise TypeError(type(cfg))
    return dataclasses.replace(
        cfg,
        field_vocabs=tuple(min(v, 1000) for v in cfg.field_vocabs),
        n_items=min(cfg.n_items, 1000) if cfg.n_items else 0,
        n_cates=min(cfg.n_cates, 50) if cfg.n_cates else 0,
        seq_len=min(cfg.seq_len, 16) if cfg.seq_len else 0)
