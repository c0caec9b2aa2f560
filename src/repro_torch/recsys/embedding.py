"""Embedding substrate of the recsys family (the JAX package's
`recsys/embedding.py`).

Every per-field table is concatenated into one mega-table padded to a
shard boundary, so one array serves every field.  Lookups are plain
gathers and the ragged bag is plain PyTorch (`index_add_`,
`scatter_reduce_`); the fixed-fanout bag of Wide&Deep's wide part goes
through the embedding-bag kernel (`kernels/embedding_bag`) instead.

On a mesh a table of ROW_PAD rows or more is split by rows over every
axis (`sharding.specs.recsys_param_specs`), and `shard_lookup` is the
lookup: a rank gathers its data group's ids, looks up the rows of its
window (zeros elsewhere, `window_rows`) and the ranks' partials are
summed, each data rank keeping its own rows (`sharding.ctx.sum_lookups`).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.sharding import ctx as CTX

ROW_PAD = 4096   # tables padded to a shard boundary (any mesh <= 4096 chips)
MEGA_TABLE_STD = 0.05


def pad_rows(n: int) -> int:
    return ((n + ROW_PAD - 1) // ROW_PAD) * ROW_PAD


def field_offsets(vocabs: Sequence[int]) -> np.ndarray:
    """Start row of each field inside the concatenated mega-table."""
    return np.concatenate([[0], np.cumsum(np.asarray(vocabs))[:-1]]).astype(np.int32)


def mega_table_rows(vocabs: Sequence[int]) -> int:
    return pad_rows(int(np.sum(np.asarray(vocabs))))


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain row gather: (rows, dim)[ids] -> ids.shape + (dim,)."""
    return table[ids.long()]


def gather_ids(ids: torch.Tensor, dp_batch: bool) -> torch.Tensor:
    """The data group's ids: `ids` (this data rank's rows of a batch cut
    over the data axis, `dp_batch`) gathered over it in rank order; ids
    that every rank holds alike come back as they are."""
    return CTX.all_gather(ids, "data", 0) if dp_batch else ids


def window_rows(table: torch.Tensor, ids: torch.Tensor, row0: int) -> torch.Tensor:
    """A rank's share of a lookup: `table` holds global rows row0 .. row0 +
    rows - 1; each id's row where it lies in them, zeros elsewhere (the
    gradient reaches only the window's rows)."""
    local = ids.long() - row0
    own = (local >= 0) & (local < table.shape[0])
    x = table[local.clamp(0, table.shape[0] - 1)]
    return torch.where(own[..., None], x, torch.zeros_like(x))


def shard_lookup(table: torch.Tensor, ids: torch.Tensor, row0: int,
                 dp_batch: bool = True) -> torch.Tensor:
    """`lookup` of a table split by rows over every axis, from this rank's
    block (first global row `row0`): ids are this data rank's rows
    (`dp_batch`) or the same on every rank.  -> ids.shape + (dim,), each
    data rank's own rows."""
    return CTX.sum_lookups(window_rows(table, gather_ids(ids, dp_batch), row0), dp_batch)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, segment_ids: torch.Tensor,
                  num_segments: int, *, mode: str = "sum",
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """EmbeddingBag(sum|mean|max) over ragged bags.

    ids, segment_ids: flat (nnz,) tensors; bag b = rows where
    segment_ids == b.  An empty bag sums to 0 and has max -inf, as
    `jax.ops.segment_sum` / `segment_max` give; `mean` divides by
    max(count, 1)."""
    rows = lookup(table, ids)                                 # (nnz, dim)
    if weights is not None:
        rows = rows * weights[:, None]
    seg = segment_ids.long()
    shape = (num_segments, rows.shape[1])
    if mode in ("sum", "mean"):
        s = rows.new_zeros(shape).index_add_(0, seg, rows)
        if mode == "sum":
            return s
        n = rows.new_zeros((num_segments,)).index_add_(0, seg, rows.new_ones(seg.shape))
        return s / torch.clamp(n, min=1.0)[:, None]
    if mode == "max":
        return rows.new_full(shape, float("-inf")).scatter_reduce_(
            0, seg[:, None].expand_as(rows), rows, "amax", include_self=True)
    raise ValueError(mode)


def fielded_lookup(table: torch.Tensor, sparse_ids: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """CTR-style lookup: sparse_ids (B, F) of per-field local ids ->
    (B, F, dim) via the mega-table."""
    return lookup(table, sparse_ids + offsets[None, :])


def init_mega_table(generator: Optional[torch.Generator], vocabs: Sequence[int],
                    dim: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(mega_table_rows(vocabs), dim) normal * 0.05, drawn from
    `generator` on its device (or on `device`)."""
    if device is None:
        device = generator.device
    t = torch.empty((mega_table_rows(vocabs), dim), dtype=dtype, device=device)
    return t.normal_(generator=generator).mul_(MEGA_TABLE_STD)
