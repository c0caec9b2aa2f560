"""Embedding-bag wrappers: fixed-fanout bag sums, (B, F) row ids into a
(rows, d) table -> (B, d), accumulated in fp32 (`bag_sum`, kernel B5),
and their gradient with respect to the table (`bag_backward`, kernel
K7).

A CPU tensor runs the plain version (`ref.py`); a CUDA tensor launches
the hand-written kernel (`bag.cu`) or raises.  `bag_sum.launches` and
`bag_backward.launches` count kernel launches and nothing else."""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels.embedding_bag.ref import bag_backward_ref, embedding_bag_ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"rt_embedding_bag": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
               "rt_bag_backward": [_P, _P, _P, _P, _I, _I, _I, _L, _I, _P]}


def bag_sum(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table: (rows, d) fp32 or bf16; ids: (B, F) int32 global row ids,
    each in [0, rows).  -> (B, d) in the table's dtype: each bag's rows
    summed in fp32 in field order and rounded once."""
    if not K.on_cuda(table, ids):
        return embedding_bag_ref(table, ids)
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"table {tuple(table.shape)} / ids {tuple(ids.shape)}: "
                         "need (rows, d) / (B, F)")
    K.check_cuda_operand("table", table)
    K.check_cuda_operand("ids", ids, (torch.int32,))
    (B, F), d = ids.shape, table.shape[1]
    if max(B, F, d) >= 2 ** 31:
        raise ValueError(f"ids {tuple(ids.shape)}, d {d}: need B, F and d below 2^31")
    out = torch.empty((B, d), dtype=table.dtype, device=table.device)
    if B == 0 or d == 0:
        return out
    n = 16 // table.element_size()
    vec = int(d % n == 0 and table.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    lib = _build.library("embedding_bag", _SIGNATURES)
    with K.on_device(table):
        err = lib.rt_embedding_bag(K.ptr(table), K.ptr(ids), K.ptr(out), B, F, d,
                                   K.dtype_code("table", table), vec,
                                   K.stream_of(table))
    _build.check(lib, err, "embedding_bag")
    bag_sum.launches += 1
    return out


bag_sum.launches = 0


def bag_backward(ids: torch.Tensor, d_out: torch.Tensor, rows: int) -> torch.Tensor:
    """The gradient of `bag_sum` with respect to its (rows, d) table:
    ids (B, F) int32 global row ids, each in [0, rows); d_out (B, d) in
    the table's dtype (fp32 or bf16).  -> (rows, d) in d_out's dtype,
    summed in fp32 (atomics on the card: the order of a row's sums varies
    from run to run) and rounded once."""
    if not K.on_cuda(ids, d_out):
        return bag_backward_ref(ids, d_out, rows)
    if ids.dim() != 2 or d_out.dim() != 2 or d_out.shape[0] != ids.shape[0]:
        raise ValueError(f"ids {tuple(ids.shape)} / d_out {tuple(d_out.shape)}: "
                         "need (B, F) / (B, d)")
    K.check_cuda_operand("ids", ids, (torch.int32,))
    K.check_cuda_operand("d_out", d_out)
    (B, F), d = ids.shape, d_out.shape[1]
    if max(B, F, d) >= 2 ** 31 or rows < 1:
        raise ValueError(f"ids {tuple(ids.shape)}, d {d}, rows {rows}: need B, F, d "
                         "below 2^31 and rows >= 1")
    code = K.dtype_code("d_out", d_out)
    grad = torch.zeros((rows, d), dtype=torch.float32, device=d_out.device)
    out = grad if d_out.dtype == torch.float32 else torch.empty(
        (rows, d), dtype=d_out.dtype, device=d_out.device)
    if B == 0 or F == 0:
        return out.zero_()
    lib = _build.library("embedding_bag", _SIGNATURES)
    with K.on_device(d_out):
        err = lib.rt_bag_backward(K.ptr(ids), K.ptr(d_out), K.ptr(grad), K.ptr(out), B, F,
                                  d, rows, code, K.stream_of(d_out))
    _build.check(lib, err, "bag_backward")
    bag_backward.launches += 1
    return out


bag_backward.launches = 0
