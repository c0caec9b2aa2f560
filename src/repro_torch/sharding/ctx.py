"""The mesh context of a rank, and the collectives the rank-local forward
and the serving loop use — the counterpart of the JAX package's
`sharding/ctx.py`.

Model and serving code stay mesh-agnostic: they call `all_reduce`,
`gather_vocab`, `decide` and `check`, which act on the tensor-parallel
(``model``) group of the mesh made current by ``with axes(mesh):``.
Outside any mesh, or on a mesh whose model axis has one rank, each is the
identity, so unit tests and single-device runs stay bitwise what they
were.  `resolve` keeps the reference's logical-axis names.  The
reference's `hint` (a sharding constraint) has no counterpart: a rank
holds its own shard of every tensor.

Logical axes:  "dp" -> ("pod", "data") / ("data",)   "mp" -> "model"
"""
from __future__ import annotations

import contextlib
import contextvars
import hashlib
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import data_axes
from repro_torch.sharding.specs import P

_CTX: contextvars.ContextVar = contextvars.ContextVar("mesh_ctx", default=None)


@contextlib.contextmanager
def axes(mesh):
    """Make `mesh` this rank's current mesh inside the block."""
    token = _CTX.set((mesh, data_axes(mesh), "model"))
    try:
        yield
    finally:
        _CTX.reset(token)


def current():
    """The current mesh, or None."""
    ctx = _CTX.get()
    return None if ctx is None else ctx[0]


def resolve(*logical) -> Optional[P]:
    ctx = _CTX.get()
    if ctx is None:
        return None
    _, dax, m = ctx
    out = []
    for ax in logical:
        if ax == "dp":
            out.append(tuple(dax))
        elif ax == "mp":
            out.append(m)
        elif ax == "dp+mp":
            out.append(tuple(dax) + (m,))
        else:
            out.append(None)
    return P(*out)


def _tp():
    """(mesh, its model-axis group) when the current mesh splits the
    model over more than one rank, else None."""
    mesh = current()
    if mesh is None or mesh.shape["model"] == 1:
        return None
    return mesh, mesh.groups["model"]


def tp_size() -> int:
    mesh = current()
    return 1 if mesh is None else mesh.shape["model"]


def all_reduce(x: torch.Tensor) -> torch.Tensor:
    """Sum `x` over the ranks of the model axis (in place; returns it):
    the partial products of a rank's heads or MLP columns become the
    layer's output."""
    tp = _tp()
    if tp is not None:
        dist.all_reduce(x, group=tp[1])
    return x


def mean_over_tp(x: torch.Tensor) -> torch.Tensor:
    """Mean over the model axis of per-rank means over equal head counts:
    the mean over every head."""
    tp = _tp()
    if tp is None:
        return x
    return all_reduce(x) / tp[0].shape["model"]


def gather_vocab(x: torch.Tensor, vocab: int) -> torch.Tensor:
    """The whole vocabulary's logits (..., vocab), fp32, from each rank's
    contiguous slice (..., vocab / tp): every rank writes its slice into a
    zeroed buffer and the buffers are summed, which is exact (one rank
    holds each entry) and needs only the all-reduce every backend
    offers."""
    tp = _tp()
    if tp is None:
        return x
    mesh, group = tp
    n = x.shape[-1]
    out = x.new_zeros(x.shape[:-1] + (vocab,), dtype=torch.float32)
    out[..., mesh.coords["model"] * n:(mesh.coords["model"] + 1) * n] = x
    dist.all_reduce(out, group=group)
    return out


def decide(value):
    """`value` as the model axis's first rank has it: a host value that
    could differ between the ranks' processes (a measured time) is
    decided once and shared, so every rank plans the same next step."""
    tp = _tp()
    if tp is None:
        return value
    mesh, group = tp
    box = [value]
    dist.broadcast_object_list(box, src=mesh.axis_ranks("model")[0], group=group)
    return box[0]


def digest(value) -> str:
    """A stable digest of nested tuples / lists / dicts of numbers,
    strings and arrays."""
    h = hashlib.blake2b(digest_size=12)

    def feed(v):
        if isinstance(v, (np.ndarray, torch.Tensor)):
            a = np.ascontiguousarray(v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                                     else v)
            h.update(f"{a.dtype}{a.shape}".encode())
            h.update(a.tobytes())
        elif isinstance(v, dict):
            for k in sorted(v):
                feed(k)
                feed(v[k])
        elif isinstance(v, (list, tuple)):
            h.update(f"[{len(v)}".encode())
            for x in v:
                feed(x)
        else:
            h.update(repr(v).encode())
    feed(value)
    return h.hexdigest()


def check(tag: str, value) -> None:
    """With the current mesh's ``check`` on: compare `value`'s digest
    across the ranks of the model axis, record it in the mesh's log, and
    raise on every rank at the first difference (before the ranks' next
    collectives part).  Off, or outside a split model axis: nothing."""
    tp = _tp()
    if tp is None or not tp[0].check:
        return
    mesh, group = tp
    mine = digest(value)
    got = [None] * mesh.shape["model"]
    dist.all_gather_object(got, mine, group=group)
    mesh.log.append((tag, mine))
    if len(set(got)) != 1:
        raise RuntimeError(f"ranks {mesh.axis_ranks('model')} disagree on {tag} "
                           f"(entry {len(mesh.log)} of this rank's log): digests {got}")
