"""Plain PyTorch versions of the fixed-fanout embedding bag and of its
gradient.  The sum is the contract of the JAX package's Pallas kernel
(`kernels/embedding_bag/kernel.py`), which takes each bag's rows,
accumulates them in fp32 whatever the table's dtype, and rounds once to
the table's dtype at the end.  The gradient is what autodiff of the
reference's `jnp.take` + sum gives: each bag's output gradient added to
every row the bag read, in fp32, rounded once.

Both take the kernels' row window: the table holds global rows row0 ..
row0 + rows - 1 and an id outside them adds nothing."""
from __future__ import annotations

import torch


def _window(ids: torch.Tensor, rows: int, row0: int):
    """(ids as rows of the window, clamped into it; which lie in it)."""
    local = ids.long() - row0
    own = (local >= 0) & (local < rows)
    return local.clamp(0, rows - 1), own


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """table: (rows, d), global rows row0 ..; ids: (B, F) global row ids ->
    (B, d) bag sums of the window's rows in the table's dtype."""
    local, own = _window(ids, table.shape[0], row0)
    x = table[local].float()
    return torch.where(own[..., None], x, torch.zeros_like(x)).sum(dim=1).to(table.dtype)


def bag_backward_ref(ids: torch.Tensor, d_out: torch.Tensor, rows: int,
                     row0: int = 0) -> torch.Tensor:
    """ids (B, F) global row ids, d_out (B, d) -> d_table (rows, d) of the
    window's rows in d_out's dtype: d_table[ids[b, f] - row0] += d_out[b]
    for the ids in the window, summed in fp32 (one `index_add_` per
    field)."""
    grad = torch.zeros((rows, d_out.shape[1]), dtype=torch.float32, device=d_out.device)
    src = d_out.float()
    local, own = _window(ids, rows, row0)
    zero = torch.zeros_like(src)
    for f in range(ids.shape[1]):
        grad.index_add_(0, local[:, f], torch.where(own[:, f, None], src, zero))
    return grad.to(d_out.dtype)
