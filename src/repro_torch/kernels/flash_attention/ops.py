"""Public flash-attention wrappers: (B, S, H, D) GQA layout.

`mha_flash` (kernel B1): a CPU tensor runs the plain version
(`ref.mha_flash_ref`); a CUDA tensor launches the route of the
hand-written kernel (`flash.cu`) that `_route` names, or raises.
`mha_flash.launches` counts kernel launches of either route and nothing
else; `mha_flash.tc_launches` counts those of the tensor-core route.

`mha_flash_bwd` (kernel K6, `flash_bwd.cu`): the training path's
attention gradient; a CPU tensor runs `ref.flash_bwd_ref`, a CUDA tensor
the kernel or raises.  `mha_flash_bwd.launches` counts its calls that
launched the kernel."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_bwd_ref, mha_flash_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"rt_flash_attention": [_P] * 5 + [_I] * 8 + [_F] + [_I] * 3 + [_P],
               "rt_flash_attention_tc": [_P] * 5 + [_I] * 8 + [_F, _P]}
_BWD_SIGNATURES = {"rt_flash_bwd": [_P] * 12 + [_I] * 8 + [_F, _I, _P]}
# what the backward kernel takes: D up to 256, any G = Hq / Hkv
BWD_MAX_HEAD_DIM = 256
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


def mha_flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                  lse: torch.Tensor, dout: torch.Tensor, q_positions: torch.Tensor,
                  kv_positions: torch.Tensor, *, causal: bool = True,
                  window: Optional[int] = None, q_chunk: int = 512,
                  kv_chunk: int = 1024):
    """Gradients of attention with respect to q, k and v (the JAX
    package's `_flash_bwd`): q, out, dout (B, Sq, Hq, D); k, v (B, Skv,
    Hkv, D), Hkv | Hq; lse (B, Sq, Hq) fp32, the forward's log-sum-exp;
    positions (Sq,) / (Skv,) absolute; a causal mask and an optional
    sliding window.  -> (dq, dk, dv) in the inputs' dtype.  On the card
    every float operand must be contiguous and of one dtype (fp32 or
    bf16), D <= 256; q_chunk and kv_chunk shape only the plain version's
    tiles (the order of its sums)."""
    tensors = (q, k, v, out, lse, dout, q_positions, kv_positions)
    if not K.on_cuda(*tensors):
        return flash_bwd_ref(q, k, v, out, lse, dout, q_positions, kv_positions,
                             causal=causal, window=window, q_chunk=q_chunk,
                             kv_chunk=kv_chunk)
    B, Sq, Hq, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} vs q {tuple(q.shape)}")
    Skv, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv or D > BWD_MAX_HEAD_DIM or min(B, Sq, Skv, Hq) < 1:
        raise ValueError(f"Hq={Hq} Hkv={Hkv} D={D}: need Hkv | Hq, D <= "
                         f"{BWD_MAX_HEAD_DIM}, non-empty operands")
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != (B, Sq, Hq):
        raise ValueError(f"out {tuple(out.shape)} / dout {tuple(dout.shape)} / lse "
                         f"{tuple(lse.shape)}: want {tuple(q.shape)} and {(B, Sq, Hq)}")
    if window is not None and window < 1:
        raise ValueError(f"window {window}: need >= 1 or None")
    code = K.dtype_code("q", q)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout)):
        K.check_cuda_operand(name, t, (q.dtype,))
    K.check_cuda_operand("lse", lse, (torch.float32,))
    K.check_cuda_operand("q_positions", q_positions, (torch.int32,))
    K.check_cuda_operand("kv_positions", kv_positions, (torch.int32,))
    if q_positions.shape != (Sq,) or kv_positions.shape != (Skv,):
        raise ValueError(f"positions {tuple(q_positions.shape)} / {tuple(kv_positions.shape)}:"
                         f" want ({Sq},) / ({Skv},)")
    delta = torch.empty((B, Sq, Hq), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _build.library("flash_bwd", _BWD_SIGNATURES)
    with K.on_device(q):
        err = lib.rt_flash_bwd(*(K.ptr(t) for t in (q, k, v, out, dout, lse, delta,
                                                     q_positions, kv_positions, dq, dk, dv)),
                               B, Sq, Skv, Hq, Hkv, D, int(causal),
                               0 if window is None else int(window), 1.0 / D ** 0.5, code,
                               K.stream_of(q))
    _build.check(lib, err, "flash_bwd")
    mha_flash_bwd.launches += 1
    return dq, dk, dv


mha_flash_bwd.launches = 0
