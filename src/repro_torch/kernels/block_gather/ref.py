"""Plain PyTorch version of the paged block gather with RoPE realignment
(the JAX package's `kernels/block_gather/ref.py`).

Physical pages are gathered by a block table into logical order; when
`rotate`, the pre-RoPE keys are rotated to their target positions
(half-split RoPE in fp32, cast back to the pool dtype) and values are
copied.  A slot may carry trailing (Hkv, Dh) heads: each head rotates
over its own Dh, at its slot's position.  `block_gather_layers_ref`
gathers a stack of layer planes by one table at once.
"""
from __future__ import annotations

from typing import Optional

import torch


def rope_freqs(d: int, theta: float, device=None) -> torch.Tensor:
    """(d/2,) fp32 rotation frequencies 1 / theta**(i / (d/2))."""
    half = d // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def rope_rotate(k: torch.Tensor, positions: torch.Tensor,
                theta: float) -> torch.Tensor:
    """k: (..., d) pre-RoPE keys; positions broadcastable to k[..., 0]."""
    half = k.shape[-1] // 2
    ang = positions[..., None].float() * rope_freqs(k.shape[-1], theta, k.device)
    cos, sin = torch.cos(ang), torch.sin(ang)
    k1, k2 = k[..., :half].float(), k[..., half:].float()
    out = torch.cat([k1 * cos - k2 * sin, k1 * sin + k2 * cos], dim=-1)
    return out.to(k.dtype)


def gather_pages(pool: torch.Tensor, idx: torch.Tensor,
                 pool2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pages of `pool` by `idx`; entries idx >= pool.shape[0] read page
    idx - pool.shape[0] of `pool2`."""
    n1 = pool.shape[0]
    if pool2 is None:
        return pool[idx]
    in2 = idx >= n1
    out = pool[torch.where(in2, torch.zeros_like(idx), idx)]
    if bool(in2.any()):
        out[in2] = pool2[idx[in2] - n1]
    return out


def block_gather_ref(pool_k: torch.Tensor, pool_v: torch.Tensor,
                     block_table: torch.Tensor, positions: torch.Tensor, *,
                     rope_theta: float = 10_000.0, rotate: bool = True,
                     pool2_k: Optional[torch.Tensor] = None,
                     pool2_v: Optional[torch.Tensor] = None):
    """pool_k/pool_v: (n_pages, page, d) or (n_pages, page, Hkv, Dh), keys
    pre-RoPE; block_table: (n_logical,) physical page per logical page,
    entries from n_pages on reading page (entry - n_pages) of
    `pool2_k`/`pool2_v` when given; positions: (n_logical, page) target
    positions.  -> (k, v) of shape (n_logical, page, ...) in the pool
    dtypes."""
    idx = block_table.long()
    k = gather_pages(pool_k, idx, pool2_k)
    v = gather_pages(pool_v, idx, pool2_v)
    if rotate:
        pos = positions.reshape(tuple(positions.shape) + (1,) * (k.dim() - 3))
        k = rope_rotate(k, pos, rope_theta)
    return k, v


def block_gather_layers_ref(pool_k: torch.Tensor, pool_v: torch.Tensor,
                            block_table: torch.Tensor, positions: torch.Tensor, *,
                            rope_theta: float = 10_000.0, rotate: bool = True,
                            keep_raw: bool = False, pool2_k: Optional[torch.Tensor] = None,
                            pool2_v: Optional[torch.Tensor] = None):
    """`block_gather_ref` of every layer plane at once.  pool_k/pool_v:
    (L, n_pages, page, ...) stacks of layer planes (pool2_k/pool2_v
    likewise, (L, n_pages2, page, ...)); block_table/positions as
    `block_gather_ref` takes them.  -> (k, v), with `keep_raw` (k, v,
    keys before rotation), each (L, n_logical, page, ...) and contiguous.
    Bitwise one `block_gather_ref` call per layer: the angles depend on
    the positions alone, and every other operation is elementwise."""
    idx = block_table.long()
    per_page = lambda t: None if t is None else t.transpose(0, 1)
    k = gather_pages(per_page(pool_k), idx, per_page(pool2_k)).transpose(0, 1).contiguous()
    v = gather_pages(per_page(pool_v), idx, per_page(pool2_v)).transpose(0, 1).contiguous()
    raw = k
    if rotate:
        pos = positions.reshape(tuple(positions.shape) + (1,) * (k.dim() - 4))
        k = rope_rotate(k, pos, rope_theta)
    return (k, v, raw) if keep_raw else (k, v)
