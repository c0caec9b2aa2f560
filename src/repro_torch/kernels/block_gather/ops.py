"""Block-gather wrapper: cached pre-RoPE KV pages gathered by a block
table into logical order, keys optionally rotated to their target
positions.  A second pool (the serving arena's layer plane, where the
block store keeps shared prefix rows) can be addressed by the same table.

A CPU tensor runs the plain version (`ref.block_gather_ref`); a CUDA
tensor launches the hand-written kernel (`gather.cu`) or raises.
`assemble_kv.launches` counts kernel launches and nothing else;
`assemble_kv.pool2_launches` those of them given a second pool."""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch import kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels.block_gather.ref import block_gather_ref, gather_pages, rope_freqs

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"rt_block_gather": [_P] * 10 + [_I, _I, ctypes.c_longlong] + [_I] * 8 + [_P]}
_FREQS: Dict[Tuple[int, float, torch.device], torch.Tensor] = {}


def device_freqs(d: int, theta: float, device: torch.device) -> torch.Tensor:
    """The plain version's frequencies, computed once per (d, theta,
    device) by the same PyTorch expression, so kernel and plain version
    rotate by bitwise the same angles."""
    key = (d, float(theta), device)
    f = _FREQS.get(key)
    if f is None:
        f = _FREQS[key] = rope_freqs(d, theta, device).contiguous()
    return f


def assemble_kv(pool_k: torch.Tensor, pool_v: torch.Tensor,
                block_table: torch.Tensor, positions: torch.Tensor, *,
                rope_theta: float = 10_000.0, rotate: bool = True,
                keep_raw: bool = False, pool2_k: Optional[torch.Tensor] = None,
                pool2_v: Optional[torch.Tensor] = None):
    """pool_k/pool_v: (n_pages, page, d) or (n_pages, page, Hkv, Dh)
    physical pools, keys pre-RoPE; block_table: (n_logical,) int32;
    positions: (n_logical, page) int32 target positions (read only when
    `rotate`).  -> (k, v), each (n_logical, page, ...) in its pool's
    dtype; with `keep_raw` (needs `rotate`) also the gathered keys before
    rotation, written by the same launch: (k, v, k_raw).

    `pool2_k`/`pool2_v` (optional, together): a second pool of n_pages2
    pages of the same page shape and dtype, read by table entries in
    [n_pages, n_pages + n_pages2) (entry - n_pages).  Its pages may lie
    any fixed number of elements apart (a layer plane of the serving
    arena, `PagedKVPool.plane`), each page itself contiguous."""
    if keep_raw and not rotate:
        raise ValueError("keep_raw returns the unrotated keys beside rotated ones: "
                         "it needs rotate=True")
    if (pool2_k is None) != (pool2_v is None):
        raise ValueError("pool2_k and pool2_v go together")
    two = pool2_k is not None
    if two and (tuple(pool2_k.shape[1:]) != tuple(pool_k.shape[1:])
                or pool2_v.shape != pool2_k.shape or pool2_k.dtype != pool_k.dtype
                or pool2_v.dtype != pool_v.dtype):
        raise ValueError(f"second pools {tuple(pool2_k.shape)}/{tuple(pool2_v.shape)}: "
                         f"need pages of the first pools' shape {tuple(pool_k.shape[1:])} "
                         "and dtypes")
    extra = (pool2_k, pool2_v) if two else ()
    if not K.on_cuda(pool_k, pool_v, block_table, positions, *extra):
        k, v = block_gather_ref(pool_k, pool_v, block_table, positions,
                                rope_theta=rope_theta, rotate=rotate,
                                pool2_k=pool2_k, pool2_v=pool2_v)
        if not keep_raw:
            return k, v
        return k, v, gather_pages(pool_k, block_table.long(), pool2_k)
    if pool_k.dim() not in (3, 4) or pool_v.shape != pool_k.shape:
        raise ValueError(f"pools {tuple(pool_k.shape)}/{tuple(pool_v.shape)}: need "
                         "equal shapes (n_pages, page, d) or (n_pages, page, Hkv, Dh)")
    n_pages, page = pool_k.shape[:2]
    H, D = (1, pool_k.shape[2]) if pool_k.dim() == 3 else tuple(pool_k.shape[2:])
    n_logical = block_table.shape[0] if block_table.dim() == 1 else -1
    if block_table.dim() != 1 or tuple(positions.shape) != (n_logical, page):
        raise ValueError(f"block_table {tuple(block_table.shape)} / positions "
                         f"{tuple(positions.shape)}: need (n_logical,) / (n_logical, {page})")
    if D % 2 or D > 4096:
        raise ValueError(f"head dim {D}: need an even Dh <= 4096")
    for name, t in (("pool_k", pool_k), ("pool_v", pool_v)):
        K.check_cuda_operand(name, t)
    n_pages2, stride2 = 0, 0
    if two:
        for name, t in (("pool2_k", pool2_k), ("pool2_v", pool2_v)):
            if not t[:1].is_contiguous():
                raise ValueError(f"{name}: each page must be contiguous")
        if pool2_k.stride(0) != pool2_v.stride(0) or pool2_k.stride(0) < pool_k[0].numel():
            raise ValueError(f"second pools' page strides {pool2_k.stride(0)}/"
                             f"{pool2_v.stride(0)}: need one stride of at least a page")
        n_pages2, stride2 = pool2_k.shape[0], pool2_k.stride(0)
    for name, t in (("block_table", block_table), ("positions", positions)):
        K.check_cuda_operand(name, t, (torch.int32,))
    shape = (n_logical,) + tuple(pool_k.shape[1:])
    k_out = torch.empty(shape, dtype=pool_k.dtype, device=pool_k.device)
    v_out = torch.empty(shape, dtype=pool_v.dtype, device=pool_v.device)
    k_raw = torch.empty_like(k_out) if keep_raw else None
    if n_logical == 0:
        return (k_out, v_out, k_raw) if keep_raw else (k_out, v_out)
    freqs = device_freqs(D, rope_theta, pool_k.device)
    nk, nv = 16 // pool_k.element_size(), 16 // pool_v.element_size()
    vec = int((D // 2) % nk == 0 and (H * D) % nv == 0 and all(
        t.data_ptr() % 16 == 0 for t in (pool_k, pool_v, k_out, v_out, *extra))
        and (stride2 * pool_k.element_size()) % 16 == 0)
    lib = _build.library("block_gather", _SIGNATURES)
    with K.on_device(pool_k):
        err = lib.rt_block_gather(
            K.ptr(pool_k), K.ptr(pool_v), K.ptr(pool2_k), K.ptr(pool2_v),
            K.ptr(block_table), K.ptr(positions), K.ptr(freqs), K.ptr(k_out),
            K.ptr(v_out), K.ptr(k_raw), n_pages, n_pages2, stride2,
            n_logical, page, H, D, int(rotate), K.dtype_code("pool_k", pool_k),
            K.dtype_code("pool_v", pool_v), vec, K.stream_of(pool_k))
    _build.check(lib, err, "block_gather")
    assemble_kv.launches += 1
    assemble_kv.pool2_launches += two
    return (k_out, v_out, k_raw) if keep_raw else (k_out, v_out)


assemble_kv.launches = 0
assemble_kv.pool2_launches = 0
