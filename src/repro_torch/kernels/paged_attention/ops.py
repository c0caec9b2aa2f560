"""Paged-decode attention wrapper: (N, Hq, Dh) single-token queries over
the paged arena, one call per layer.

A CPU tensor runs the plain version (`ref.paged_decode_ref`); a CUDA
tensor launches the hand-written kernel (`paged_decode.cu`) or raises.
GQA is by index inside the kernel: no group padding, no copies.
`paged_decode_mha.launches` counts kernel launches and nothing else."""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import paged_decode_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"rt_paged_decode": [_P] * 6 + [_I] * 8 + [_F, _F, _I, _I, _P]}


def paged_decode_mha(q: torch.Tensor, arena_k: torch.Tensor,
                     arena_v: torch.Tensor, page_ids: torch.Tensor,
                     slot_pos: torch.Tensor, *, layer: int,
                     rope_theta: float = 10_000.0) -> torch.Tensor:
    """q: (N, Hq, Dh) post-RoPE decode queries; arena_k/arena_v:
    (P, page, L, Hkv, Dh) paged pool, keys pre-RoPE; page_ids: (N, Pmax)
    int32; slot_pos: (N, Pmax, page) int32 logical position per slot or -1
    (see `serving.kv_pool.page_views`).  -> (N, Hq, Dh)."""
    if not K.on_cuda(q, arena_k, arena_v, page_ids, slot_pos):
        return paged_decode_ref(q, arena_k, arena_v, page_ids, slot_pos,
                                layer=layer, rope_theta=rope_theta)
    N, Hq, D = q.shape
    P, page, L, Hkv, Da = arena_k.shape
    if arena_v.shape != arena_k.shape or arena_v.dtype != arena_k.dtype or Da != D:
        raise ValueError(f"arenas {tuple(arena_k.shape)}/{tuple(arena_v.shape)} vs q {tuple(q.shape)}")
    if Hq % Hkv or Hq // Hkv > 16 or D > 128 or D % 2:
        raise ValueError(f"Hq={Hq} Hkv={Hkv} D={D}: need Hkv | Hq, Hq/Hkv <= 16, even D <= 128")
    pmax = page_ids.shape[1] if page_ids.dim() == 2 else -1
    if page_ids.shape != (N, pmax) or slot_pos.shape != (N, pmax, page):
        raise ValueError(f"page_ids {tuple(page_ids.shape)} / slot_pos {tuple(slot_pos.shape)}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside 0..{L - 1}")
    for name, t in (("q", q), ("arena_k", arena_k), ("arena_v", arena_v)):
        K.check_cuda_operand(name, t)
    for name, t in (("page_ids", page_ids), ("slot_pos", slot_pos)):
        K.check_cuda_operand(name, t, (torch.int32,))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.library("paged_decode", _SIGNATURES)
    with K.on_device(q):
        err = lib.rt_paged_decode(
            K.ptr(q), K.ptr(arena_k), K.ptr(arena_v), K.ptr(page_ids),
            K.ptr(slot_pos), K.ptr(out), N, Hq, Hkv, D, page, L, int(layer),
            pmax, float(rope_theta), 1.0 / D ** 0.5, K.dtype_code("q", q),
            K.dtype_code("arena", arena_k), K.stream_of(q))
    _build.check(lib, err, "paged_decode")
    paged_decode_mha.launches += 1
    return out


paged_decode_mha.launches = 0
