"""Plain PyTorch versions of the fixed-fanout embedding bag and of its
gradient.  The sum is the contract of the JAX package's Pallas kernel
(`kernels/embedding_bag/kernel.py`), which takes each bag's rows,
accumulates them in fp32 whatever the table's dtype, and rounds once to
the table's dtype at the end.  The gradient is what autodiff of the
reference's `jnp.take` + sum gives: each bag's output gradient added to
every row the bag read, in fp32, rounded once."""
from __future__ import annotations

import torch


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table: (rows, d); ids: (B, F) global row ids -> (B, d) bag sums in
    the table's dtype."""
    return table[ids.long()].float().sum(dim=1).to(table.dtype)


def bag_backward_ref(ids: torch.Tensor, d_out: torch.Tensor, rows: int) -> torch.Tensor:
    """ids (B, F) global row ids, d_out (B, d) -> d_table (rows, d) in
    d_out's dtype: d_table[ids[b, f]] += d_out[b], summed in fp32 (one
    `index_add_` per field)."""
    grad = torch.zeros((rows, d_out.shape[1]), dtype=torch.float32, device=d_out.device)
    src = d_out.float()
    for f in range(ids.shape[1]):
        grad.index_add_(0, ids[:, f].long(), src)
    return grad.to(d_out.dtype)
