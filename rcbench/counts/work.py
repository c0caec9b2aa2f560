"""Operations and bytes that the window's requests need, counted from
their shapes (prompt length, recompute set, rows gathered, decode
context), never from the launches, so a count reads the same work
whatever implements it.  Each input byte is counted once and each output
byte once, as the port's kernel table counts them (`PERF.md`).

`Shape` holds what the counts read of a configuration; the arena and
the cached rows are fp32, queries, values and outputs of B2 and B3 in
the served dtype."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from rcbench.counts import peaks

F32 = 4


@dataclass(frozen=True)
class Shape:
    n_layers: int
    d_model: int
    d_ff: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    vocab: int
    mlp_mats: int          # 3 for a gated MLP, 2 otherwise
    act_bytes: int = 2     # the served dtype

    @staticmethod
    def of(config: dict) -> "Shape":
        return Shape(config["num_hidden_layers"], config["hidden_size"],
                     config["intermediate_size"], config["num_attention_heads"],
                     config["num_key_value_heads"], config["head_dim"], config["vocab_size"],
                     3 if config["hidden_act"] == "silu" else 2,
                     2 if config["torch_dtype"] in ("bfloat16", "float16") else 4)

    @property
    def layer_params(self) -> int:
        """Matrix parameters of one layer: wq, wk, wv, wo and the MLP."""
        attn = 2 * self.d_model * self.n_heads * self.head_dim
        attn += 2 * self.d_model * self.n_kv_heads * self.head_dim
        return attn + self.mlp_mats * self.d_model * self.d_ff

    @property
    def kv_row(self) -> int:
        """Bytes of one token's K or V at one layer in the fp32 arena."""
        return self.n_kv_heads * self.head_dim * F32


def bound_s(flops: float, nbytes: float, flops_peak: float = peaks.BF16_FLOPS) -> float:
    """The least time the chip could take: the larger of operations over
    the peak rate and bytes over HBM bandwidth."""
    return max(flops / flops_peak, nbytes / peaks.HBM_BYTES)


def attended(r_pos: Sequence[int]) -> int:
    """Keys a causal query set attends: sum over queries at p of p + 1."""
    return int(np.sum(np.asarray(r_pos, np.int64) + 1))


def b2(s: Shape, n: int, r_pos: Sequence[int]):
    """Selective attention (B2) of one request over layers 1..L-1: queries
    at the recompute positions `r_pos` (served dtype), keys (fp32) and
    values (served dtype) of all `n` prompt tokens.  -> (flops, bytes)."""
    R, L1 = len(r_pos), s.n_layers - 1
    hd = s.n_heads * s.head_dim
    flops = 4 * hd * attended(r_pos) * L1
    nbytes = L1 * (2 * R * hd * s.act_bytes
                   + n * s.n_kv_heads * s.head_dim * (F32 + s.act_bytes))
    return flops, nbytes


def b3(s: Shape, ctx: Sequence[int]):
    """Paged decode attention (B3) of one decode step over all layers: one
    query row per entry of `ctx`, each reading its `ctx` resident K and V
    slots (fp32) once.  -> (flops, bytes)."""
    c = int(np.sum(np.asarray(ctx, np.int64)))
    hd = s.n_heads * s.head_dim
    flops = 4 * hd * c * s.n_layers
    nbytes = s.n_layers * (2 * len(ctx) * hd * s.act_bytes + 2 * c * s.kv_row)
    return flops, nbytes


def b4_pass(s: Shape, n_rows: int, n_distinct: int, layers: int):
    """Block gather (B4) of one selective pass: `n_distinct` cached rows
    read (K and V) and `n_rows` rows written as rotated K, V and raw K, at
    each of `layers` layers.  -> (0, bytes)."""
    return 0, layers * (2 * n_distinct + 3 * n_rows) * s.kv_row


def b4_copy(s: Shape, n_rows: int, n_distinct: int):
    """B4's layer-0 copy of a prompt's cached rows (K and V) for Eq. 3.
    -> (0, bytes)."""
    return 0, (2 * n_distinct + 2 * n_rows) * s.kv_row


def prefill_flops(s: Shape, n: int, r_pos: Sequence[int]) -> float:
    """Model FLOPs of one RcLLM prefill: layer 0 over every prompt token,
    layers 1..L-1 over the recompute set, attention over the live keys,
    and the head at the last position."""
    hd = s.n_heads * s.head_dim
    f = 2 * n * s.layer_params + 4 * hd * n * (n + 1) // 2
    f += (s.n_layers - 1) * (2 * len(r_pos) * s.layer_params + 4 * hd * attended(r_pos))
    return float(f + 2 * s.d_model * s.vocab)


def decode_flops(s: Shape, ctx: int) -> float:
    """Model FLOPs of one decode token over a context of `ctx` tokens (the
    new one included), the head included."""
    hd = s.n_heads * s.head_dim
    return float(s.n_layers * (2 * s.layer_params + 4 * hd * ctx) + 2 * s.d_model * s.vocab)
