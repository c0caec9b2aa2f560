"""Paged-decode attention wrapper: (N, Hq, Dh) single-token queries over
the paged arena, one call per layer.

A CPU tensor runs the plain version (`ref.paged_decode_ref`); a CUDA
tensor launches the hand-written kernel (`paged_decode.cu`) or raises.
GQA is by index inside the kernel: no group padding, no copies.  The
kernel splits each row's page columns into runs of `split_pages(...)`
columns, one block per (split, kv head, request), and merges the splits
in the same launch.  `paged_decode_mha.launches` counts kernel launches
and nothing else; `paged_decode_mha.last_splits` is the (pages per
split, splits) of the last launch."""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch import kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels.block_gather.ops import device_freqs
from repro_torch.kernels.paged_attention.ref import paged_decode_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"rt_paged_decode": [_P] * 10 + [_I] * 10 + [_F, _I, _I, _I, _P]}

H100_SMS = 132
BLOCKS_PER_SM = 4        # the kernel's occupancy at the served call (128 registers a thread)
MAX_SPLITS = 32          # the kernel's merge of the splits gives each split one lane
MAX_SPLIT_SLOTS = 4096   # a block stages its split's slot positions in shared memory

_WORKSPACE: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def split_pages(n: int, hkv: int, pmax: int, page: int,
                sms: int = H100_SMS) -> Tuple[int, int]:
    """(pages per split, splits) for a call over N rows, Hkv kv heads and
    Pmax page columns of `page` slots, from the shapes alone: enough splits
    that the grid of N x Hkv x splits blocks fills the card about once at
    BLOCKS_PER_SM blocks per SM.  Splits are consecutive runs of page
    columns; the last may be shorter."""
    if min(n, hkv, pmax, page, sms) < 1 or page > MAX_SPLIT_SLOTS:
        raise ValueError(f"N={n} Hkv={hkv} Pmax={pmax} page={page} sms={sms}: need "
                         f"positive sizes and page <= {MAX_SPLIT_SLOTS}")
    want = max(1, BLOCKS_PER_SM * sms // (n * hkv))
    splits = min(want, pmax, MAX_SPLITS)
    pps = min(-(-pmax // splits), MAX_SPLIT_SLOTS // page)
    splits = -(-pmax // pps)
    if splits > MAX_SPLITS:
        raise ValueError(f"Pmax={pmax} pages of {page} slots: more than "
                         f"{MAX_SPLITS * MAX_SPLIT_SLOTS} slots per row")
    return pps, splits


def _workspace(n_floats: int, n_tickets: int, device: torch.device,
               stream: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split partials (fp32) and the tickets (int32, zero between
    launches: the kernel's last block of each group resets its own) for
    launches on one stream, grown as calls need."""
    key = (device.index, stream)
    ws, tickets = _WORKSPACE.get(key, (None, None))
    if ws is None or ws.numel() < n_floats:
        ws = torch.empty(n_floats, dtype=torch.float32, device=device)
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=device)
    _WORKSPACE[key] = (ws, tickets)
    return ws, tickets


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
    if Hq % Hkv or Hq // Hkv > 16 or D > 128 or D % 2 or D < 2:
        raise ValueError(f"Hq={Hq} Hkv={Hkv} D={D}: need Hkv | Hq, Hq/Hkv <= 16, even D <= 128")
    pmax = page_ids.shape[1] if page_ids.dim() == 2 else -1
    if page_ids.shape != (N, pmax) or slot_pos.shape != (N, pmax, page):
        raise ValueError(f"page_ids {tuple(page_ids.shape)} / slot_pos {tuple(slot_pos.shape)}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside 0..{L - 1}")
    if N > 65535 or Hkv > 65535:
        raise ValueError(f"N={N} Hkv={Hkv}: at most 65535 each (grid limit)")
    if P * page * L * Hkv >= 2 ** 31:
        raise ValueError(f"arena of {P * page * L * Hkv} rows: the kernel indexes fewer "
                         "than 2^31")
    for name, t in (("q", q), ("arena_k", arena_k), ("arena_v", arena_v)):
        K.check_cuda_operand(name, t)
    for name, t in (("page_ids", page_ids), ("slot_pos", slot_pos)):
        K.check_cuda_operand(name, t, (torch.int32,))
    pk, pv = arena_k.data_ptr(), arena_v.data_ptr()
    if pk % 4 or pv % 4:
        raise ValueError("arenas must be 4-byte aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    pps, splits = split_pages(N, Hkv, pmax, page, K.sm_count(q.device))
    stream = K.stream_of(q)
    ws_acc = ws_ml = tickets = None
    if splits > 1:
        n_acc = N * Hq * splits * D
        ws, tk = _workspace(n_acc + 2 * N * Hq * splits, N * Hkv, q.device, stream)
        ws_acc, tickets = ws.data_ptr(), tk.data_ptr()
        ws_ml = ws_acc + 4 * n_acc
    vec16 = int((D * arena_k.element_size()) % 16 == 0 and pk % 16 == 0 and pv % 16 == 0)
    freqs = device_freqs(D, rope_theta, q.device)
    lib = _build.library("paged_decode", _SIGNATURES)
    with K.on_device(q):
        err = lib.rt_paged_decode(
            K.ptr(q), pk, pv, K.ptr(page_ids), K.ptr(slot_pos), K.ptr(freqs), K.ptr(out),
            ws_acc, ws_ml, tickets, N, Hq, Hkv, D, page, L, int(layer), pmax, pps, splits,
            1.0 / D ** 0.5, K.dtype_code("q", q), K.dtype_code("arena", arena_k),
            vec16, stream)
    _build.check(lib, err, "paged_decode")
    paged_decode_mha.launches += 1
    paged_decode_mha.last_splits = (pps, splits)
    return out


paged_decode_mha.launches = 0
paged_decode_mha.last_splits = None
