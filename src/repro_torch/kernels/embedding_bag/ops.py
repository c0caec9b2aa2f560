"""Embedding-bag wrappers: fixed-fanout bag sums, (B, F) row ids into a
(rows, d) table -> (B, d), accumulated in fp32 (`bag_sum`, kernel B5),
and their gradient with respect to the table (`bag_backward`, kernel
K7).

A CPU tensor runs the plain version (`ref.py`); a CUDA tensor launches
the hand-written kernel (`bag.cu`) or raises.  `bag_sum.launches` and
`bag_backward.launches` count kernel launches and nothing else.  The
bag sum's kernel gathers tiles of bags through shared memory at the
geometry `staged_geometry` chooses.

Both take a row window: `row0`, the global id of the table's first row,
where the table is one rank's block of a table split by rows (a recsys
table over a mesh).  Ids are global; one outside the window is skipped
(the sum adds the window's rows, the gradient issues nothing for it).
With ``row0 = 0`` and the whole table they are the unwindowed calls."""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch import kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels.embedding_bag.ref import bag_backward_ref, embedding_bag_ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"rt_embedding_bag": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                     _P],
               "rt_bag_backward": [_P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _P]}


BAG_THREADS = 256           # bag.cu kThreads
TILE_BAGS = 32              # bags of a tile at most (the fastest at serve_bulk, PERF.md §6)
STAGE_BYTES = 48 * 1024     # bag.cu kStageBytes: a tile's gathered rows


class Geometry(NamedTuple):
    lgP: int     # a bag's vectors over P = 2^lgP lanes
    TB: int      # bags of a tile
    FC: int      # fields of a chunk
    S: int       # odd field stride of the tile in shared memory


def staged_geometry(B: int, F: int, d: int, elt: int, vec: bool, sms: int) -> Geometry:
    """The staged kernel's launch for B bags of F fields, rows of d
    elements of `elt` bytes read as 16-byte vectors (`vec`) or one element
    at a time, on a card of `sms` SMs.  A bag's cols = d / V vectors take P
    lanes (the power of two >= cols, at most BAG_THREADS); a tile holds at
    most TILE_BAGS bags and BAG_THREADS / P, and in a small batch no more
    than make two tiles an SM; a chunk holds as many fields as fit
    STAGE_BYTES, at an odd stride S (the sum phase's reads then fall in
    distinct banks).  `bag.cu:launch_staged` checks the same limits."""
    if min(B, d, elt, sms) < 1 or F < 0:
        raise ValueError(f"B={B} F={F} d={d} elt={elt} sms={sms}")
    V = 16 // elt if vec else 1
    if d % V:
        raise ValueError(f"d={d} is not a multiple of the {V}-element vector")
    cols = d // V
    lgP = 0
    while (1 << lgP) < min(cols, BAG_THREADS):
        lgP += 1
    P = 1 << lgP
    TB = max(1, min(BAG_THREADS // P, TILE_BAGS, -(-B // (2 * sms))))
    room = STAGE_BYTES // (TB * P * V * elt)
    FC = max(1, min(F, room))
    S = FC | 1
    if S > room:
        FC -= 1
        S = FC | 1
    return Geometry(lgP, TB, FC, S)


def bag_sum(table: torch.Tensor, ids: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """table: (rows, d) fp32 or bf16, global rows row0 .. row0 + rows - 1;
    ids: (B, F) int32 global row ids.  -> (B, d) in the table's dtype:
    each bag's rows that lie in the window summed in fp32 in field order
    and rounded once (other ids skipped)."""
    if K.shape_only(table, ids):
        # ids read once, each bag's rows read once, the sums written once
        rows = ids.numel() * table.shape[1]
        out = table.new_empty((ids.shape[0], table.shape[1]))
        K.record_work("bag_sum", rows, K.nbytes(ids, out) + rows * table.element_size())
        return out
    if not K.on_cuda(table, ids):
        return embedding_bag_ref(table, ids, row0)
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"table {tuple(table.shape)} / ids {tuple(ids.shape)}: "
                         "need (rows, d) / (B, F)")
    K.check_cuda_operand("table", table)
    K.check_cuda_operand("ids", ids, (torch.int32,))
    (B, F), d = ids.shape, table.shape[1]
    if max(B, F, d, row0 + table.shape[0]) >= 2 ** 31 or row0 < 0 or table.shape[0] < 1:
        raise ValueError(f"ids {tuple(ids.shape)}, d {d}, rows {row0}..+{table.shape[0]}: "
                         "need B, F, d and the window below 2^31, a window of >= 1 row")
    out = torch.empty((B, d), dtype=table.dtype, device=table.device)
    if B == 0 or d == 0:
        return out
    elt = table.element_size()
    vec = d % (16 // elt) == 0 and table.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    g = staged_geometry(B, F, d, elt, vec, K.sm_count(table.device))
    lib = _build.library("embedding_bag", _SIGNATURES)
    with K.on_device(table):
        err = lib.rt_embedding_bag(K.ptr(table), K.ptr(ids), K.ptr(out), B, F, d,
                                   K.dtype_code("table", table), int(vec), *g, int(row0),
                                   table.shape[0], K.stream_of(table))
    _build.check(lib, err, "embedding_bag")
    bag_sum.launches += 1
    return out


bag_sum.launches = 0


def bag_backward(ids: torch.Tensor, d_out: torch.Tensor, rows: int,
                 row0: int = 0) -> torch.Tensor:
    """The gradient of `bag_sum` with respect to its (rows, d) table of
    global rows row0 .. row0 + rows - 1: ids (B, F) int32 global row ids
    (those outside the window add nothing); d_out (B, d) in the table's
    dtype (fp32 or bf16).  -> (rows, d) in d_out's dtype, summed in fp32
    (atomics on the card: the order of a row's sums varies from run to
    run) and rounded once."""
    if K.shape_only(ids, d_out):
        # ids and d_out read once, the (rows, d) fp32 gradient written once
        K.record_work("bag_backward", ids.numel() * d_out.shape[1],
                      K.nbytes(ids, d_out) + rows * d_out.shape[1] * 4)
        return d_out.new_empty((rows, d_out.shape[1]))
    if not K.on_cuda(ids, d_out):
        return bag_backward_ref(ids, d_out, rows, row0)
    if ids.dim() != 2 or d_out.dim() != 2 or d_out.shape[0] != ids.shape[0]:
        raise ValueError(f"ids {tuple(ids.shape)} / d_out {tuple(d_out.shape)}: "
                         "need (B, F) / (B, d)")
    K.check_cuda_operand("ids", ids, (torch.int32,))
    K.check_cuda_operand("d_out", d_out)
    (B, F), d = ids.shape, d_out.shape[1]
    if max(B, F, d) >= 2 ** 31 or rows < 1 or row0 < 0:
        raise ValueError(f"ids {tuple(ids.shape)}, d {d}, rows {row0}..+{rows}: need B, F, "
                         "d below 2^31, rows >= 1 and row0 >= 0")
    code = K.dtype_code("d_out", d_out)
    grad = torch.zeros((rows, d), dtype=torch.float32, device=d_out.device)
    out = grad if d_out.dtype == torch.float32 else torch.empty(
        (rows, d), dtype=d_out.dtype, device=d_out.device)
    if B == 0 or F == 0:
        return out.zero_()
    lib = _build.library("embedding_bag", _SIGNATURES)
    with K.on_device(d_out):
        err = lib.rt_bag_backward(K.ptr(ids), K.ptr(d_out), K.ptr(grad), K.ptr(out), B, F,
                                  d, rows, int(row0), code, K.stream_of(d_out))
    _build.check(lib, err, "bag_backward")
    bag_backward.launches += 1
    return out


bag_backward.launches = 0
