"""Selective-attention wrapper and its host-side block-liveness map.

A CPU tensor runs the plain version (`ref.selective_mha_ref`); a CUDA
tensor launches the route of the hand-written kernel (`selective.cu`)
that `_route` names, or raises.  `selective_mha.launches` counts kernel
launches of any route and nothing else; `selective_mha.tc_launches`
counts those of the tensor-core route and `selective_mha.small_launches`
those of the small-head route."""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch import kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels.selective_attention.ref import selective_mha_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"rt_selective_attention": [_P] * 7 + [_I] * 12 + [_F]
               + [_I] * 3 + [_P],
               "rt_selective_attention_small": [_P] * 7 + [_I] * 12 + [_F]
               + [_I] * 3 + [_P],
               "rt_selective_attention_tc": [_P] * 7 + [_I] * 12 + [_F, _I, _P]}
# what the tensor-core route takes besides bf16 q and v
TC_HEAD_DIMS = (64, 128)
TC_GROUPS = (1, 2, 4, 8)
TC_ROWS = 64        # rows of a tensor-core tile: 64 / G queries x G heads
TC_KEYS = 64        # keys per tensor-core tile
# the small-head route takes every head dim up to this, in any dtypes
SMALL_HEAD_DIM = 32


def _route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, nb: int) -> str:
    """Which kernel route takes these operands, from dtypes and shapes
    alone: "small" (a row to a few threads on the CUDA cores) for
    D <= SMALL_HEAD_DIM; "tc" (tensor cores) for bf16 q and v, bf16 or
    fp32 k, D in TC_HEAD_DIMS, G = Hq / Hkv in TC_GROUPS and NB | B*Hkv
    (the G heads of a kv group read one mask row); "simt" (the CUDA-core
    kernel) for every other float32/bfloat16 case.  Every route takes
    Hkv | Hq, D <= 128 and NB | B*Hq; raises for what none takes."""
    B, R, Hq, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} vs q {tuple(q.shape)}")
    Hkv = k.shape[2]
    if Hq % Hkv or D > 128:
        raise ValueError(f"Hq={Hq} Hkv={Hkv} D={D}: need Hkv | Hq and D <= 128")
    for name, t in (("q", q), ("k", k), ("v", v)):
        K.dtype_code(name, t)
    if nb < 1 or (B * Hq) % nb:
        raise ValueError(f"NB={nb} mask rows: need NB | B*Hq = {B * Hq}")
    if D <= SMALL_HEAD_DIM:
        return "small"
    if (q.dtype == v.dtype == torch.bfloat16 and D in TC_HEAD_DIMS
            and Hq // Hkv in TC_GROUPS and (B * Hkv) % nb == 0):
        return "tc"
    return "simt"


def block_liveness(q_positions, hh_mask, *, window: int,
                   q_block: int = 128, kv_block: int = 128) -> np.ndarray:
    """Host-side block-liveness map (a numpy copy of the JAX package's
    `selective_attention/kernel.py:block_liveness`).

    q_positions: (R,) or (NB, R) int absolute query positions (pad = -1);
    hh_mask: (S,) or (NB, S) heavy-hitter/recomputed key bitmap.  Tile
    (qi, kj) is live iff any query in it can see any key in the tile
    (window hit, or any HH key causally visible).  -> (NB, nq, nk) int32.
    """
    qp = np.asarray(q_positions)
    hh = np.asarray(hh_mask)
    if qp.ndim == 1:
        qp = qp[None]
    if hh.ndim == 1:
        hh = hh[None]
    nb, r = qp.shape
    s_len = hh.shape[1]
    r_p = ((r + q_block - 1) // q_block) * q_block
    s_p = ((s_len + kv_block - 1) // kv_block) * kv_block
    qp = np.pad(qp.astype(np.int64), ((0, 0), (0, r_p - r)),
                constant_values=-1)
    hh = np.pad(hh.astype(np.int8), ((0, 0), (0, s_p - s_len)))
    nq, nk = r_p // q_block, s_p // kv_block
    live = np.zeros((nb, nq, nk), np.int32)
    for bi in range(nb):
        qpos_r = qp[bi].reshape(nq, q_block)
        hh_r = hh[bi].reshape(nk, kv_block)
        for qi in range(nq):
            qmax = int(qpos_r[qi].max())
            qmin_valid = qpos_r[qi][qpos_r[qi] >= 0]
            qmin = int(qmin_valid.min()) if len(qmin_valid) else -1
            if qmin < 0 and qmax < 0:
                continue
            for kj in range(nk):
                k_lo, k_hi = kj * kv_block, (kj + 1) * kv_block - 1
                if k_lo > qmax:
                    continue                         # fully acausal
                # window liveness: ∃ q∈[qmin,qmax], k∈[k_lo,k_hi] with
                # 0 ≤ q−k < window ⟺ [qmin−window+1, qmax] ∩ [k_lo, k_hi] ≠ ∅
                # (conservative superset for non-contiguous q positions)
                win_hit = k_hi > qmin - window and k_lo <= qmax
                hh_hit = bool(hh_r[kj].any())
                if win_hit or hh_hit:
                    live[bi, qi, kj] = 1
    return live


def flop_reduction(r: int, s: int, n_hh: int, window: int) -> float:
    """Analytic attention FLOPs of R = `r` recomputed queries, each over
    its window plus `n_hh` heavy-hitter keys, as a share of full
    attention over `s` tokens (the paper's ~r * n^2 saving)."""
    return r * min(window + n_hh, s) / (s * s)


def check_live_tiles(route: str, group: int, q_block: int, kv_block: int) -> None:
    """Raise unless `route` can honour (q_block, kv_block) liveness tiles:
    each of its query tiles must lie inside one liveness row and each of
    its key tiles inside one liveness column (tensor cores: 64 / G queries
    and 64 keys; SIMT: 16 queries and 32 keys).  The small-head route
    takes tiles of any size: a block ORs every liveness entry its rows and
    key tile touch."""
    tile_q, tile_k = {"tc": (TC_ROWS // group, TC_KEYS), "simt": (16, 32),
                      "small": (1, 1)}[route]
    if q_block < 1 or kv_block < 1 or q_block % tile_q or kv_block % tile_k:
        raise ValueError(f"liveness tiles ({q_block}, {kv_block}) must be multiples of "
                         f"({tile_q}, {tile_k}) for the {route} route")


def selective_mha(q: torch.Tensor, q_positions, k: torch.Tensor,
                  v: torch.Tensor, hh_mask, *, live=None, window: int = 256,
                  q_block: int = 64, kv_block: int = 64) -> torch.Tensor:
    """q: (B, R, Hq, D); k, v: (B, S, Hkv, D); q_positions: (R,) or
    (NB, R) int; hh_mask: (S,) or (NB, S); NB divides B*Hq.  `live`: the
    (NB, nq, nk) map from `block_liveness` over (q_block, kv_block) tiles,
    computed here from the positions and mask when omitted.  The CPU
    path ignores it (dead tiles contribute nothing).  A CUDA call takes
    the route `_route` names.  -> (B, R, Hq, D)."""
    if not K.on_cuda(q, k, v):
        return selective_mha_ref(q, torch.as_tensor(q_positions, device=q.device), k, v,
                                 torch.as_tensor(hh_mask, device=q.device), window=window)
    return _selective_launch(None, q, q_positions, k, v, hh_mask, live=live, window=window,
                             q_block=q_block, kv_block=kv_block)


def _selective_launch(route, q: torch.Tensor, q_positions, k: torch.Tensor, v: torch.Tensor,
                      hh_mask, *, live, window: int, q_block: int,
                      kv_block: int) -> torch.Tensor:
    """`selective_mha` on the card: the kernel launched on the route
    `_route` names, or on `route` where that route also takes these
    operands ("simt" takes every one), to time one route against
    another."""
    B, R, Hq, D = q.shape
    # in the kernel's dtypes; the engine passes them so, and then nothing
    # is copied or converted here
    qp = K.as_operand(q_positions, torch.int32, q.device)
    hh = K.as_operand(hh_mask, torch.uint8, q.device)
    qp = qp if qp.dim() == 2 else qp[None]
    hh = hh if hh.dim() == 2 else hh[None]
    nb = qp.shape[0]
    chosen = _route(q, k, v, nb)
    if route is None:
        route = chosen
    elif route not in ("simt", chosen):
        raise ValueError(f"route {route!r}: these operands take {chosen!r} or 'simt'")
    S, Hkv = k.shape[1], k.shape[2]
    if qp.shape != (nb, R) or hh.shape != (nb, S):
        raise ValueError(f"q_positions {tuple(qp.shape)} / hh_mask {tuple(hh.shape)}: "
                         f"want ({nb}, {R}) / ({nb}, {S}) with NB | {B * Hq}")
    check_live_tiles(route, Hq // Hkv, q_block, kv_block)
    if live is None:
        live = block_liveness(qp.cpu().numpy(), hh.cpu().numpy(), window=window,
                              q_block=q_block, kv_block=kv_block)
    live = K.as_operand(live, torch.int32, q.device)
    if live.dim() == 2:
        live = live[None]
    nq, nk = -(-R // q_block), -(-S // kv_block)
    if live.shape != (nb, nq, nk):
        raise ValueError(f"live shape {tuple(live.shape)}: want ({nb}, {nq}, {nk})")
    for name, t in (("q", q), ("k", k), ("v", v), ("live", live)):
        K.check_cuda_operand(name, t)
    out = torch.empty_like(q)
    if out.numel() == 0 or S == 0:
        return out.zero_()
    lib = _build.library("selective", _SIGNATURES)
    args = (K.ptr(q), K.ptr(qp), K.ptr(k), K.ptr(v), K.ptr(hh), K.ptr(live), K.ptr(out),
            B, R, S, Hq, Hkv, D, nb, int(window), q_block, kv_block, nq, nk, 1.0 / D ** 0.5)
    with K.on_device(q):
        if route == "tc":
            err = lib.rt_selective_attention_tc(*args, K.dtype_code("k", k), K.stream_of(q))
        else:
            launch = (lib.rt_selective_attention_small if route == "small"
                      else lib.rt_selective_attention)
            err = launch(*args, K.dtype_code("q", q), K.dtype_code("k", k),
                         K.dtype_code("v", v), K.stream_of(q))
    _build.check(lib, err, f"selective_attention ({route})")
    selective_mha.launches += 1
    selective_mha.tc_launches += int(route == "tc")
    selective_mha.small_launches += int(route == "small")
    return out


selective_mha.launches = 0
selective_mha.tc_launches = 0
selective_mha.small_launches = 0
