"""Public flash-attention wrapper: (B, S, H, D) GQA layout.

A CPU tensor runs the plain version (`ref.mha_flash_ref`); a CUDA tensor
launches the route of the hand-written kernel (`flash.cu`) that `_route`
names, or raises.  `mha_flash.launches` counts kernel launches of either
route and nothing else; `mha_flash.tc_launches` counts those of the
tensor-core route."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import mha_flash_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"rt_flash_attention": [_P] * 5 + [_I] * 8 + [_F] + [_I] * 3 + [_P],
               "rt_flash_attention_tc": [_P] * 5 + [_I] * 8 + [_F, _P]}
_MASK_DTYPES = (torch.bool, torch.int8, torch.uint8)
# what the tensor-core route takes besides bf16 q, k and v
TC_HEAD_DIMS = (64, 128)
TC_GROUPS = (1, 2, 4, 8)


def _route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, nb: int) -> str:
    """Which kernel route takes these operands, from dtypes and shapes
    alone: "tc" (tensor cores) for bf16 q, k and v, D in TC_HEAD_DIMS,
    G = Hq / Hkv in TC_GROUPS and NB | B*Hkv (the G heads of a kv group
    read one kv_valid row; NB = 1 without kv_valid); "simt" (the
    CUDA-core kernel) for every other float32/bfloat16 case with
    Hkv | Hq, D <= 128 and NB | B*Hq.  Raises for what neither route
    takes."""
    B, Sq, Hq, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} vs q {tuple(q.shape)}")
    Hkv = k.shape[2]
    if Hq % Hkv or D > 128:
        raise ValueError(f"Hq={Hq} Hkv={Hkv} D={D}: need Hkv | Hq and D <= 128")
    for name, t in (("q", q), ("k", k), ("v", v)):
        K.dtype_code(name, t)
    if nb < 1 or (B * Hq) % nb:
        raise ValueError(f"NB={nb} kv_valid rows: need NB | B*Hq = {B * Hq}")
    if (q.dtype == k.dtype == v.dtype == torch.bfloat16 and D in TC_HEAD_DIMS
            and Hq // Hkv in TC_GROUPS and (B * Hkv) % nb == 0):
        return "tc"
    return "simt"


def mha_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              kv_valid: Optional[torch.Tensor] = None,
              causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) with Hkv dividing Hq;
    kv_valid: optional (NB, Skv) mask of attendable keys (NB dividing
    B*Hq; the engine passes one row per batch row).  A CUDA call takes the
    route `_route` names.  -> (B, Sq, Hq, D)."""
    operands = (q, k, v) if kv_valid is None else (q, k, v, kv_valid)
    if not K.on_cuda(*operands):
        return mha_flash_ref(q, k, v, kv_valid=kv_valid, causal=causal)
    B, Sq, Hq, D = q.shape
    nb = 1 if kv_valid is None else kv_valid.shape[0]
    route = _route(q, k, v, nb)
    Skv, Hkv = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        K.check_cuda_operand(name, t)
    if kv_valid is not None:
        K.check_cuda_operand("kv_valid", kv_valid, _MASK_DTYPES)
        if kv_valid.shape != (nb, Skv):
            raise ValueError(f"kv_valid shape {tuple(kv_valid.shape)}: want (NB, {Skv}), NB | {B * Hq}")
    out = torch.empty_like(q)
    if out.numel() == 0 or Skv == 0:
        return out.zero_()
    lib = _build.library("flash", _SIGNATURES)
    args = (K.ptr(q), K.ptr(k), K.ptr(v), K.ptr(kv_valid), K.ptr(out),
            B, Sq, Skv, Hq, Hkv, D, nb, int(causal), 1.0 / D ** 0.5)
    with K.on_device(q):
        if route == "tc":
            err = lib.rt_flash_attention_tc(*args, K.stream_of(q))
        else:
            err = lib.rt_flash_attention(*args, K.dtype_code("q", q), K.dtype_code("k", k),
                                         K.dtype_code("v", v), K.stream_of(q))
    _build.check(lib, err, f"flash_attention ({route})")
    mha_flash.launches += 1
    mha_flash.tc_launches += int(route == "tc")
    return out


mha_flash.launches = 0
mha_flash.tc_launches = 0
