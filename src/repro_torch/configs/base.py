"""Model configurations for the port: the dense-LM subset of the JAX
package's `configs/base.py:LMConfig` (no MoE and no mesh knobs yet) and
its `RecsysConfig`, field for field, with `reduced()` for the recsys
family."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class LMConfig:
    """Decoder-only transformer LM (dense)."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default: d_model // n_heads
    mlp_type: str = "swiglu"        # swiglu | geglu | relu2 | gelu
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def param_count(self) -> int:
        """Total parameters (embedding included)."""
        dh = self.resolved_head_dim
        attn = self.d_model * (self.n_heads * dh) * 2
        attn += self.d_model * (self.n_kv_heads * dh) * 2
        n_mats = 3 if self.mlp_type in ("swiglu", "geglu") else 2
        per_layer = attn + n_mats * self.d_model * self.d_ff + 2 * self.d_model
        embed = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + embed + self.d_model


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


def reduced(cfg: RecsysConfig) -> RecsysConfig:
    """A CPU-sized variant of a recsys config on the same code path:
    vocabularies capped at 1000, items at 1000, categories at 50 and the
    sequence at 16; every width stays."""
    if not isinstance(cfg, RecsysConfig):
        raise TypeError(type(cfg))
    return dataclasses.replace(
        cfg,
        field_vocabs=tuple(min(v, 1000) for v in cfg.field_vocabs),
        n_items=min(cfg.n_items, 1000) if cfg.n_items else 0,
        n_cates=min(cfg.n_cates, 50) if cfg.n_cates else 0,
        seq_len=min(cfg.seq_len, 16) if cfg.seq_len else 0)
