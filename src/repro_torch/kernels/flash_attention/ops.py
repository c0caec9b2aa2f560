"""Public flash-attention wrappers: (B, S, H, D) GQA layout.

`mha_flash` (kernel B1): a CPU tensor runs the plain version
(`ref.mha_flash_ref`); a CUDA tensor launches the route of the
hand-written kernel (`flash.cu`) that `_route` names, or raises.
`mha_flash.launches` counts kernel launches of any route and nothing
else; `mha_flash.tc_launches` counts those of the tensor-core route and
`mha_flash.small_launches` those of the small-head route.

`mha_flash_bwd` (kernel K6, `flash_bwd.cu`): the training path's
attention gradient; a CPU tensor runs `ref.flash_bwd_ref`, a CUDA tensor
launches the kernels of the route `_bwd_route` names, or raises.
`mha_flash_bwd.launches` counts its calls that launched a route,
`mha_flash_bwd.tc_launches` those of the tensor-core route and
`mha_flash_bwd.small_launches` those of the small-head route."""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch import kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_bwd_ref, mha_flash_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"rt_flash_attention": [_P] * 5 + [_I] * 8 + [_F] + [_I] * 3 + [_P],
               "rt_flash_attention_small": [_P] * 5 + [_I] * 8 + [_F] + [_I] * 3 + [_P],
               "rt_flash_attention_tc": [_P] * 5 + [_I] * 8 + [_F, _P]}
_BWD_SIGNATURES = {"rt_flash_bwd": [_P] * 13 + [_I] * 8 + [_F] + [_I] * 2 + [_P]}
# what the backward kernels take: D up to 256, any G = Hq / Hkv; the
# small-head route takes D up to BWD_SMALL_HEAD_DIM, the tensor-core route
# bf16 q, k and v at BWD_TC_HEAD_DIMS
BWD_MAX_HEAD_DIM = 256
BWD_SMALL_HEAD_DIM = 32
BWD_TC_HEAD_DIMS = (64, 128, 256)
_BWD_ROUTE_CODES = {"simt": 0, "tc": 1, "small": 2}   # flash_bwd.cu's `route`
BWD_TILE = 64   # rows of the tensor-core route's query and key tiles
_MASK_DTYPES = (torch.bool, torch.int8, torch.uint8)
# what the tensor-core route takes besides bf16 q, k and v
TC_HEAD_DIMS = (64, 128)
TC_GROUPS = (1, 2, 4, 8)
# the small-head route takes every head dim up to this, in any dtypes
SMALL_HEAD_DIM = 32


def _route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, nb: int) -> str:
    """Which kernel route takes these operands, from dtypes and shapes
    alone: "small" (a row to a few threads on the CUDA cores) for
    D <= SMALL_HEAD_DIM; "tc" (tensor cores) for bf16 q, k and v, D in
    TC_HEAD_DIMS, G = Hq / Hkv in TC_GROUPS and NB | B*Hkv (the G heads of
    a kv group read one kv_valid row; NB = 1 without kv_valid); "simt" (the
    CUDA-core kernel) for every other float32/bfloat16 case.  Every route
    takes Hkv | Hq, D <= 128 and NB | B*Hq; raises for what none takes."""
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
    if D <= SMALL_HEAD_DIM:
        return "small"
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
    return _flash_launch(None, q, k, v, kv_valid=kv_valid, causal=causal)


def _flash_launch(route: Optional[str], q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  kv_valid: Optional[torch.Tensor], causal: bool) -> torch.Tensor:
    """`mha_flash` on the card: the kernel launched on the route `_route`
    names, or on `route` where that route also takes these operands
    ("simt" takes every one), to time one route against another."""
    B, Sq, Hq, D = q.shape
    nb = 1 if kv_valid is None else kv_valid.shape[0]
    chosen = _route(q, k, v, nb)
    if route is None:
        route = chosen
    elif route not in ("simt", chosen):
        raise ValueError(f"route {route!r}: these operands take {chosen!r} or 'simt'")
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
            launch = lib.rt_flash_attention_small if route == "small" else lib.rt_flash_attention
            err = launch(*args, K.dtype_code("q", q), K.dtype_code("k", k),
                         K.dtype_code("v", v), K.stream_of(q))
    _build.check(lib, err, f"flash_attention ({route})")
    mha_flash.launches += 1
    mha_flash.tc_launches += int(route == "tc")
    mha_flash.small_launches += int(route == "small")
    return out


mha_flash.launches = 0
mha_flash.tc_launches = 0
mha_flash.small_launches = 0


def _bwd_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Which route of the attention backward takes these operands, from
    dtypes and shapes alone: "small" (a row per thread on the CUDA cores)
    for D <= BWD_SMALL_HEAD_DIM; "tc" (tensor cores) for bf16 q, k and v
    with D in BWD_TC_HEAD_DIMS and any G = Hq / Hkv; "simt" (the CUDA-core
    kernels) for every other D <= 256, float32 or bfloat16.  Raises for
    what none takes."""
    B, Sq, Hq, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} vs q {tuple(q.shape)}")
    Hkv = k.shape[2]
    if Hkv < 1 or Hq % Hkv or D > BWD_MAX_HEAD_DIM:
        raise ValueError(f"Hq={Hq} Hkv={Hkv} D={D}: need Hkv | Hq and D <= {BWD_MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        K.dtype_code(name, t)
    if D <= BWD_SMALL_HEAD_DIM:
        return "small"
    if q.dtype == k.dtype == v.dtype == torch.bfloat16 and D in BWD_TC_HEAD_DIMS:
        return "tc"
    return "simt"


def live_pairs(q_positions, kv_positions, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs `ref.band_mask` keeps at these host positions
    (numpy), counted without building the (Sq, Skv) mask."""
    kpos = np.sort(np.asarray(kv_positions, dtype=np.int64))
    q = np.asarray(q_positions, dtype=np.int64)
    if causal:
        hi = np.searchsorted(kpos, q, side="right")
        lo = 0 if window is None else np.searchsorted(kpos, q - window, side="right")
    else:
        hi = len(kpos) if window is None else np.searchsorted(kpos, q + window, side="left")
        lo = 0 if window is None else np.searchsorted(kpos, q - window, side="right")
    return int(np.sum(hi - lo))


def mha_flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                  lse: torch.Tensor, dout: torch.Tensor, q_positions: torch.Tensor,
                  kv_positions: torch.Tensor, *, causal: bool = True,
                  window: Optional[int] = None, q_chunk: int = 512,
                  kv_chunk: int = 1024, host_positions=None):
    """Gradients of attention with respect to q, k and v (the JAX
    package's `_flash_bwd`): q, out, dout (B, Sq, Hq, D); k, v (B, Skv,
    Hkv, D), Hkv | Hq; lse (B, Sq, Hq) fp32, the forward's log-sum-exp;
    positions (Sq,) / (Skv,) absolute; a causal mask and an optional
    sliding window.  -> (dq, dk, dv) in the inputs' dtype.  On the card
    every float operand must be contiguous and of one dtype (fp32 or
    bf16), D <= 256, and the call takes the route `_bwd_route` names;
    q_chunk and kv_chunk shape only the plain version's tiles (the order
    of its sums).  `host_positions`: the positions as host arrays,
    which only the dry run's shape-only branch reads (it counts the live
    pairs of the bound's formula from them)."""
    tensors = (q, k, v, out, lse, dout, q_positions, kv_positions)
    if K.shape_only(*tensors):
        if host_positions is None:
            raise ValueError("a shape-only call counts its live pairs from host_positions")
        B, _, Hq, D = q.shape
        live = live_pairs(*host_positions, causal, window)
        K.record_work("flash_bwd", 10 * D * live * B * Hq,
                      K.nbytes(*tensors) + K.nbytes(q, k, v))
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if not K.on_cuda(*tensors):
        return flash_bwd_ref(q, k, v, out, lse, dout, q_positions, kv_positions,
                             causal=causal, window=window, q_chunk=q_chunk,
                             kv_chunk=kv_chunk)
    return _flash_bwd_launch(None, *tensors, causal=causal, window=window)


def _flash_bwd_launch(route: Optional[str], q, k, v, out, lse, dout, q_positions,
                      kv_positions, *, causal: bool, window: Optional[int]):
    """`mha_flash_bwd` on the card: its kernels launched on the route
    `_bwd_route` names, or on `route` where that route also takes these
    operands ("simt" takes every one), to time one route against
    another."""
    chosen = _bwd_route(q, k, v)
    if route is None:
        route = chosen
    elif route not in ("simt", chosen):
        raise ValueError(f"route {route!r}: these operands take {chosen!r} or 'simt'")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if min(B, Sq, Skv, Hq) < 1:
        raise ValueError(f"q {tuple(q.shape)} k {tuple(k.shape)}: need non-empty operands")
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
    dev = q.device
    if route == "tc":
        nqt, nkt = -(-Sq // BWD_TILE), -(-Skv // BWD_TILE)
        scratch = torch.empty((2, B, Hq, nqt * BWD_TILE), dtype=torch.float32, device=dev)
        ranges = torch.empty((nqt + nkt, 2), dtype=torch.int32, device=dev)
    else:
        scratch, ranges = torch.empty((B, Sq, Hq), dtype=torch.float32, device=dev), None
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _build.library("flash_bwd", _BWD_SIGNATURES)
    with K.on_device(q):
        err = lib.rt_flash_bwd(*(K.ptr(t) for t in (q, k, v, out, dout, lse, scratch, ranges,
                                                     q_positions, kv_positions, dq, dk, dv)),
                               B, Sq, Skv, Hq, Hkv, D, int(causal),
                               0 if window is None else int(window), 1.0 / D ** 0.5, code,
                               _BWD_ROUTE_CODES[route], K.stream_of(q))
    _build.check(lib, err, f"flash_bwd ({route})")
    mha_flash_bwd.launches += 1
    mha_flash_bwd.tc_launches += int(route == "tc")
    mha_flash_bwd.small_launches += int(route == "small")
    return dq, dk, dv


mha_flash_bwd.launches = 0
mha_flash_bwd.tc_launches = 0
mha_flash_bwd.small_launches = 0
