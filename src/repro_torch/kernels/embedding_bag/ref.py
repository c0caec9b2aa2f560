"""Plain PyTorch version of the fixed-fanout embedding bag: the contract
of the JAX package's Pallas kernel (`kernels/embedding_bag/kernel.py`),
which takes each bag's rows, accumulates them in fp32 whatever the
table's dtype, and rounds once to the table's dtype at the end."""
from __future__ import annotations

import torch


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table: (rows, d); ids: (B, F) global row ids -> (B, d) bag sums in
    the table's dtype."""
    return table[ids.long()].float().sum(dim=1).to(table.dtype)
