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

The training path needs collectives that autograd sees, Megatron's pair
on the model axis: `copy_to_tp` where a column-parallel block is entered
(forward the identity, backward an all-reduce of the gradient) and
`all_reduce` after ``wo`` / ``w_down`` (forward an all-reduce, backward
the identity; on a tensor that takes no gradient it stays the in-place
reduction of the forward-only paths).  On the data axis: `mean_over_dp`
(a global mean whose backward passes the gradient through, so that the
gradient mean over the data axis afterwards counts each rank's share
once), `grad_mean_dp`, `all_gather` over either axis and
`exclusive_cumsum_dp` (the MoE's per-expert offsets).  Every helper is
the identity outside a mesh, or where its axis has one rank.

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

from repro_torch.launch.mesh import axis_size, data_axes
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


def _dp():
    """(mesh, its data-axis group, the data axis's size) when the current
    mesh has more than one data-parallel rank, else None."""
    ctx = _CTX.get()
    if ctx is None:
        return None
    mesh, dax, _ = ctx
    n = axis_size(mesh, dax)
    if n == 1:
        return None
    if tuple(dax) != ("data",):
        raise ValueError(f"data parallelism over the axes {dax}: the port reduces over one "
                         "'data' axis (a pod axis waits for more than one host)")
    return mesh, mesh.groups["data"], n


def dp_size() -> int:
    dp = _dp()
    return 1 if dp is None else dp[2]


def dp_rank() -> int:
    dp = _dp()
    return 0 if dp is None else dp[0].coords["data"]


def _axis(axis: str):
    """(group, size) of `axis` ("model" or "data") when it splits over more
    than one rank, else None."""
    if axis == "model":
        tp = _tp()
        return None if tp is None else (tp[1], tp[0].shape["model"])
    dp = _dp()
    return None if dp is None else (dp[1], dp[2])


class _ReduceTP(torch.autograd.Function):
    """Forward: the sum over the model axis; backward: the identity (each
    rank's partial product gets the whole output's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToTP(torch.autograd.Function):
    """Forward: the identity; backward: the gradient summed over the model
    axis (each rank's heads or columns add their share of the input's
    gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _MeanOverDP(torch.autograd.Function):
    """Forward: the mean over the data axis; backward: the identity, since
    the gradient mean over the data axis that follows divides by its
    size once."""

    @staticmethod
    def forward(ctx, x, group, n):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y / n

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def all_reduce(x: torch.Tensor) -> torch.Tensor:
    """Sum `x` over the ranks of the model axis: the partial products of a
    rank's heads or MLP columns become the layer's output.  In place (and
    returned) on a tensor that takes no gradient; out of place, with the
    identity for its backward, on one that does."""
    tp = _tp()
    if tp is None:
        return x
    if _tracked(x):
        return _ReduceTP.apply(x, tp[1])
    dist.all_reduce(x, group=tp[1])
    return x


def copy_to_tp(x: torch.Tensor) -> torch.Tensor:
    """Where a column-parallel block is entered: `x` itself, whose
    gradient is summed over the model axis."""
    tp = _tp()
    if tp is None or not _tracked(x):
        return x
    return _CopyToTP.apply(x, tp[1])


def max_over_tp(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over the model axis (in place; no gradient)."""
    tp = _tp()
    if tp is not None:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=tp[1])
    return x


def reduce_(x: torch.Tensor, axis: str, op=None) -> torch.Tensor:
    """`x` summed (or reduced by `op`) over `axis` in place, no gradient."""
    ax = _axis(axis)
    if ax is not None:
        dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=ax[0])
    return x


def broadcast_(x: torch.Tensor, axis: str, src: int) -> torch.Tensor:
    """`x` as the rank at coordinate `src` of `axis` holds it (in place)."""
    ax = _axis(axis)
    if ax is not None:
        dist.broadcast(x, src=current().axis_ranks(axis)[src], group=ax[0])
    return x


def mean_over_dp(x: torch.Tensor) -> torch.Tensor:
    """The mean of `x` over the data axis (equal shards of a batch: the
    global mean), differentiable (`_MeanOverDP`)."""
    dp = _dp()
    if dp is None:
        return x
    return _MeanOverDP.apply(x, dp[1], dp[2])


def grad_mean_dp(tensors) -> None:
    """Each tensor replaced in place by its mean over the data axis."""
    dp = _dp()
    if dp is None:
        return
    for g in tensors:
        dist.all_reduce(g, group=dp[1])
        g.div_(dp[2])


def all_gather(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """The ranks' blocks of `axis` concatenated along `dim`, in coordinate
    order (every rank's block has `x`'s shape)."""
    ax = _axis(axis)
    if ax is None:
        return x
    parts = [torch.empty_like(x) for _ in range(ax[1])]
    dist.all_gather(parts, x.contiguous(), group=ax[0])
    return torch.cat(parts, dim=dim)


def exclusive_cumsum_dp(counts: torch.Tensor) -> torch.Tensor:
    """Per entry, the sum of `counts` over the data-axis ranks before this
    one (zeros on the first, or outside a data-parallel mesh)."""
    dp = _dp()
    if dp is None:
        return torch.zeros_like(counts)
    mesh, group, n = dp
    parts = [torch.empty_like(counts) for _ in range(n)]
    dist.all_gather(parts, counts.contiguous(), group=group)
    r = mesh.coords["data"]
    return torch.stack(parts[:r]).sum(0) if r else torch.zeros_like(counts)


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
