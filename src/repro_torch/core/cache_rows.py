"""The offline caches' pre-RoPE KV, resident on the serving device.

Both cache pools (§III-B) — the candidate-item blocks and the semantic
review prototypes — register their host rows here at build time
(`item_cache.build_item_store`, `semantic_cache.materialize_kv`), and
`to_device` packs them into one device pool per K and V in the layout the
block-gather kernel reads: (L, n_rows, 1, Hkv, Dh), so layer l is a pool
of `n_rows` pages of ONE token each.  Items are ~25 tokens and not
page-aligned and a prototype is a single token, so a one-token page lets
an assembly plan address every cached token directly: the plan becomes a
block table of row ids (`assembly.plan_block_table`), and assembly plus
RoPE realignment is one kernel launch per layer, with nothing crossing
PCIe per request.  Row 0 is all zeros: recomputed and missed tokens point
at it, which reproduces the host assembly's zero rows.
"""
from __future__ import annotations

import copy
from typing import List, Optional

import numpy as np
import torch

ZERO_ROW = 0


class CacheRows:
    """Row registry (host, while the caches are built) and device pool."""

    def __init__(self, n_layers: int, n_kv_heads: int, head_dim: int):
        self.row_shape = (n_layers, n_kv_heads, head_dim)
        self._k: List[np.ndarray] = [np.zeros((1,) + self.row_shape, np.float32)]
        self._v: List[np.ndarray] = [self._k[0]]
        self.n_rows = 1
        self.k: Optional[torch.Tensor] = None
        self.v: Optional[torch.Tensor] = None

    def add(self, k: np.ndarray, v: np.ndarray) -> int:
        """Register (S, L, Hkv, Dh) pre-RoPE rows.  -> their first row id."""
        if self.k is not None:
            raise RuntimeError("rows added after the pool moved to the device")
        if k.shape[1:] != self.row_shape or v.shape != k.shape:
            raise ValueError(f"rows {k.shape}/{v.shape}: need (S,) + {self.row_shape}")
        first = self.n_rows
        self._k.append(np.asarray(k, np.float32))
        self._v.append(np.asarray(v, np.float32))
        self.n_rows += len(k)
        return first

    def to_device(self, device) -> "CacheRows":
        """Pack every registered row into the device pools (once)."""
        if self.k is None:
            for name, parts in (("k", self._k), ("v", self._v)):
                host = torch.from_numpy(np.concatenate(parts))     # (n, L, H, D)
                pool = host.to(device).permute(1, 0, 2, 3).contiguous()
                setattr(self, name, pool.unsqueeze(2))             # (L, n, 1, H, D)
            self._k = self._v = []
        return self

    def with_rows(self, k: torch.Tensor, v: torch.Tensor) -> "CacheRows":
        """A device pool holding this pool's rows followed by `k`/`v`
        ((L, t, 1, Hkv, Dh) on its device): the new rows start at this
        pool's `n_rows`.  This pool is left as it is."""
        out = copy.copy(self)
        out.k, out.v = torch.cat([self.k, k], dim=1), torch.cat([self.v, v], dim=1)
        out.n_rows = self.n_rows + k.shape[1]
        return out

    @property
    def nbytes(self) -> int:
        return 0 if self.k is None else 2 * self.k.numel() * self.k.element_size()
