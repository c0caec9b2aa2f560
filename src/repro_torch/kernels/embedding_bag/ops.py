"""Embedding-bag wrapper: fixed-fanout bag sums, (B, F) row ids into a
(rows, d) table -> (B, d), accumulated in fp32.

A CPU tensor runs the plain version (`ref.embedding_bag_ref`); a CUDA
tensor launches the hand-written kernel (`bag.cu`) or raises.
`bag_sum.launches` counts kernel launches and nothing else."""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"rt_embedding_bag": [_P, _P, _P, _I, _I, _I, _I, _I, _P]}


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
