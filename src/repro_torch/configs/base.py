"""Model configuration for the port (the dense-LM subset of the JAX
package's `configs/base.py:LMConfig`; no MoE and no mesh knobs yet)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

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
