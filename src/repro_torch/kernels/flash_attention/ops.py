"""Public flash-attention wrapper: (B, S, H, D) GQA layout.

A CPU tensor runs the plain version (`ref.mha_flash_ref`); a CUDA tensor
launches the hand-written kernel (`flash.cu`) or raises.  `mha_flash.
launches` counts kernel launches and nothing else."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import mha_flash_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"rt_flash_attention": [_P, _P, _P, _P, _P] + [_I] * 8 + [_F]
               + [_I] * 3 + [_P]}
_MASK_DTYPES = (torch.bool, torch.int8, torch.uint8)


def mha_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              kv_valid: Optional[torch.Tensor] = None,
              causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) with Hkv dividing Hq;
    kv_valid: optional (NB, Skv) mask of attendable keys (NB dividing
    B*Hq; the engine passes one row per batch row).  -> (B, Sq, Hq, D)."""
    operands = (q, k, v) if kv_valid is None else (q, k, v, kv_valid)
    if not K.on_cuda(*operands):
        return mha_flash_ref(q, k, v, kv_valid=kv_valid, causal=causal)
    B, Sq, Hq, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} vs q {tuple(q.shape)}")
    Skv, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv or D > 128:
        raise ValueError(f"Hq={Hq} Hkv={Hkv} D={D}: need Hkv | Hq and D <= 128")
    for name, t in (("q", q), ("k", k), ("v", v)):
        K.check_cuda_operand(name, t)
    nb = 1
    if kv_valid is not None:
        K.check_cuda_operand("kv_valid", kv_valid, _MASK_DTYPES)
        nb = kv_valid.shape[0]
        if kv_valid.shape != (nb, Skv) or (B * Hq) % nb:
            raise ValueError(f"kv_valid shape {tuple(kv_valid.shape)}: want (NB, {Skv}), NB | {B * Hq}")
    out = torch.empty_like(q)
    if out.numel() == 0 or Skv == 0:
        return out.zero_()
    lib = _build.library("flash", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.rt_flash_attention(
            K.ptr(q), K.ptr(k), K.ptr(v), K.ptr(kv_valid), K.ptr(out),
            B, Sq, Skv, Hq, Hkv, D, nb, int(causal), 1.0 / D ** 0.5,
            K.dtype_code("q", q), K.dtype_code("k", k), K.dtype_code("v", v),
            K.stream_of(q))
    _build.check(lib, err, "flash_attention")
    mha_flash.launches += 1
    return out


mha_flash.launches = 0
