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

Over a named group of axes (one axis, or every axis of the mesh: the
world's group): `copy_to_tp` / `all_reduce` with ``axes``, the same
Megatron pair for an edge-parallel region (SchNet's messages);
`block_of`, a rank's block of a dimension split over them;
`sum_lookups`, the sum of the ranks' partial lookups of a table split by
rows over every axis, each data rank keeping its rows (a reduce-scatter,
done as one all-reduce over every axis and the rank's slice);
`gather_last`, an all-gather over ``model`` on the last dimension whose
backward is the reduce-scatter (a kv head's Dh cut); `gather_data`, its
twin over the data axes on any dimension (a parameter cut over the data
axis, gathered where it is used); `merge_attention`, the log-sum-exp
merge of partial attention ``(max, sum, unnormalised output)`` over the
ranks that split a cache's sequence.

The axis name ``"data"`` given to a collective means the mesh's data
axes: ``("data",)``, or ``("pod", "data")`` on a pod mesh, whose ranks
have a group of their own (`launch.mesh.make_production_mesh`).

With `count_collectives` on (the dry run, `launch.dryrun`), every
collective here adds its output's bytes to a counter per op type,
weighted as the reference's roofline weights them (`launch.roofline.
COLL_OPS`: an all-reduce moves about twice its buffer); broadcasts and
object collectives are counted apart.  Off, nothing is counted.

Logical axes:  "dp" -> ("pod", "data") / ("data",)   "mp" -> "model"
"""
from __future__ import annotations

import contextlib
import contextvars
import hashlib
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import axis_size, data_axes
from repro_torch.sharding.specs import P, block_index

_CTX: contextvars.ContextVar = contextvars.ContextVar("mesh_ctx", default=None)

# the dry run's collective counter (a module global, not a context
# variable: a backward runs its collectives on autograd's threads)
_COUNTS: Optional[dict] = None


@contextlib.contextmanager
def count_collectives():
    """Count every collective issued while the block runs (the module
    docstring) -> the counter, a dict filled in place: ``per_op_bytes``
    and ``counts`` per op type (wire-weighted bytes), ``total_bytes``,
    and ``other`` (broadcasts and object collectives, unweighted)."""
    from repro_torch.launch.roofline import COLL_OPS

    global _COUNTS
    prev = _COUNTS
    _COUNTS = {"per_op_bytes": {k: 0.0 for k in COLL_OPS}, "counts": {k: 0 for k in COLL_OPS},
               "total_bytes": 0.0, "other": {"broadcast": {"bytes": 0.0, "count": 0},
                                             "object": {"count": 0}}}
    try:
        yield _COUNTS
    finally:
        _COUNTS = prev


def _count(op: str, *outs: torch.Tensor) -> None:
    """Add a collective's output bytes to the counter (when it is on)."""
    if _COUNTS is None:
        return
    n = float(sum(t.numel() * t.element_size() for t in outs))
    if op == "broadcast":
        _COUNTS["other"]["broadcast"]["bytes"] += n
        _COUNTS["other"]["broadcast"]["count"] += 1
        return
    if op == "object":
        _COUNTS["other"]["object"]["count"] += 1
        return
    from repro_torch.launch.roofline import COLL_OPS

    _COUNTS["per_op_bytes"][op] += n * COLL_OPS[op]
    _COUNTS["counts"][op] += 1
    _COUNTS["total_bytes"] += n * COLL_OPS[op]


def _all_reduce(x: torch.Tensor, group, op=None) -> None:
    dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=group)
    _count("all-reduce", x)


def _all_gather(parts, x: torch.Tensor, group) -> None:
    dist.all_gather(parts, x, group=group)
    _count("all-gather", *parts)


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
    return mesh, group_of(("data",))[0], n


def dp_size() -> int:
    dp = _dp()
    return 1 if dp is None else dp[2]


def dp_rank() -> int:
    """This rank's block index over the data axes."""
    dp = _dp()
    return 0 if dp is None else block_index(dp[0], data_axes(dp[0]))[1]


class _ReduceTP(torch.autograd.Function):
    """Forward: the sum over a group (the model axis); backward: the
    identity (each rank's partial product gets the whole output's
    gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        _all_reduce(y, group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToTP(torch.autograd.Function):
    """Forward: the identity; backward: the gradient summed over a group
    (the model axis: each rank's heads or columns add their share of the
    input's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _all_reduce(g, ctx.group)
        return g, None


class _MeanOverDP(torch.autograd.Function):
    """Forward: the mean over the data axis; backward: the identity, since
    the gradient mean over the data axis that follows divides by its
    size once."""

    @staticmethod
    def forward(ctx, x, group, n):
        y = x.clone()
        _all_reduce(y, group)
        return y / n

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def all_reduce(x: torch.Tensor, axes=("model",)) -> torch.Tensor:
    """Sum `x` over the ranks of `axes` (`group_of`; the model axis: the
    partial products of a rank's heads or MLP columns become the layer's
    output).  In place (and returned) on a tensor that takes no gradient;
    out of place, with the identity for its backward, on one that does."""
    g = group_of(axes)
    if g is None:
        return x
    if _tracked(x):
        return _ReduceTP.apply(x, g[0])
    _all_reduce(x, g[0])
    return x


def copy_to_tp(x: torch.Tensor, axes=("model",)) -> torch.Tensor:
    """Where a block split over `axes` is entered (the model axis: a
    column-parallel block): `x` itself, whose gradient is summed over
    those ranks."""
    g = group_of(axes)
    if g is None or not _tracked(x):
        return x
    return _CopyToTP.apply(x, g[0])


def max_over_tp(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over the model axis (in place; no gradient)."""
    return reduce_(x, "model", dist.ReduceOp.MAX)


def reduce_(x: torch.Tensor, axis: str, op=None) -> torch.Tensor:
    """`x` summed (or reduced by `op`) over `axis` in place, no gradient."""
    g = group_of((axis,))
    if g is not None:
        _all_reduce(x, g[0], op)
    return x


def broadcast_(x: torch.Tensor, axis: str, src: int) -> torch.Tensor:
    """`x` as the rank at coordinate `src` of `axis` holds it (in place;
    ``"data"``: block `src` of the data axes)."""
    g = group_of((axis,))
    if g is not None:
        dist.broadcast(x, src=current().axis_ranks(_names(current(), (axis,)))[src],
                       group=g[0])
        _count("broadcast", x)
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
        _all_reduce(g, dp[1])
        g.div_(dp[2])


def all_gather(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """The ranks' blocks of `axis` (one axis name, or the axes of
    `group_of`) concatenated along `dim`, in coordinate order (every
    rank's block has `x`'s shape)."""
    g = group_of((axis,) if isinstance(axis, str) else axis)
    if g is None:
        return x
    parts = [torch.empty_like(x) for _ in range(g[1])]
    _all_gather(parts, x.contiguous(), g[0])
    return torch.cat(parts, dim=dim)


def _names(mesh, axes) -> tuple:
    """`axes` in mesh order, ``"data"`` standing for every data axis."""
    axes = tuple(axes)
    if "data" in axes:
        axes = axes + tuple(data_axes(mesh))
    return tuple(a for a in mesh.axis_names if a in axes)


def group_of(axes):
    """(process group, size, this rank's coordinate) of the ranks that
    differ from this one only along `axes` (names, ``"data"`` for the
    data axes; a coordinate counts the axes in mesh order, the last
    fastest), or None where they are this rank alone.  `axes` is one
    axis, the data axes or every axis of the mesh."""
    mesh = current()
    if mesh is None:
        return None
    axes = _names(mesh, axes)
    n, c = block_index(mesh, axes)
    if n == 1:
        return None
    if len(axes) == 1:
        return mesh.groups[axes[0]], n, c
    if set(axes) == set(mesh.axis_names):
        return dist.group.WORLD, n, c
    if axes == tuple(data_axes(mesh)):
        return mesh.groups[axes], n, c
    raise ValueError(f"a collective over {axes} of a mesh {mesh.axis_names}: the port "
                     "reduces over one axis, the data axes or every axis")


def block_of(axes) -> Tuple[int, int]:
    """(blocks, this rank's block) of a dimension split over `axes`
    (`group_of`; (1, 0) where they are this rank alone)."""
    g = group_of(axes)
    return (1, 0) if g is None else (g[1], g[2])


def every_axis() -> tuple:
    """The current mesh's axis names (() outside a mesh)."""
    mesh = current()
    return () if mesh is None else tuple(mesh.axis_names)


class _SumLookups(torch.autograd.Function):
    """Forward: the sum of every rank's partial lookups (each row of a
    row-split table lives on one rank, zeros elsewhere), of which a rank
    keeps its data rank's block of rows (`rows`) or every row.  Backward:
    each data rank's loss is the mean over its rows and the objective is
    their mean (`mean_over_dp`), so a rank's partial takes the data
    group's gradients gathered over the data axis (`rows`) or their mean
    over it, divided by the data axis's size; the model axis's ranks
    share one loss and add nothing."""

    @staticmethod
    def forward(ctx, x, rows):
        every, data = group_of(every_axis()), group_of(("data",))
        ctx.rows, ctx.data = rows, data
        y = x.clone()
        if every is not None:
            _all_reduce(y, every[0])
        if rows and data is not None:
            step = y.shape[0] // data[1]
            y = y.narrow(0, data[2] * step, step).contiguous()
        return y

    @staticmethod
    def backward(ctx, g):
        data = ctx.data
        if data is None:
            return g, None
        group, n, _ = data
        g = g.contiguous()
        if ctx.rows:
            parts = [torch.empty_like(g) for _ in range(n)]
            _all_gather(parts, g, group)
            return torch.cat(parts, 0) / n, None
        g = g.clone()
        _all_reduce(g, group)
        return g / n, None


def sum_lookups(x: torch.Tensor, rows: bool) -> torch.Tensor:
    """The ranks' partial lookups (..., zeros outside each rank's rows of a
    table split over every axis) summed.  `rows`: `x` covers the data
    group's rows (the ids gathered over the data axis) and each data rank
    keeps its block of dim 0; else every rank looked up the same ids and
    keeps them all (`_SumLookups`)."""
    if group_of(every_axis()) is None:
        return x
    return _SumLookups.apply(x, rows)


class _GatherLast(torch.autograd.Function):
    """Forward: the model axis's blocks of the last dimension concatenated;
    backward: the gradient summed over the model axis and this rank's
    block kept (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, n, c):
        ctx.group, ctx.n, ctx.c, ctx.w = group, n, c, x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(n)]
        _all_gather(parts, x.contiguous(), group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _all_reduce(g, ctx.group)
        return g.narrow(-1, ctx.c * ctx.w, ctx.w).contiguous(), None, None, None


def gather_last(x: torch.Tensor) -> torch.Tensor:
    """The model axis's blocks of `x`'s last dimension, in coordinate order
    (a kv head's Dh columns), with the reduce-scatter for a backward."""
    g = group_of(("model",))
    return x if g is None else _GatherLast.apply(x, *g)


class _GatherData(torch.autograd.Function):
    """Forward: the data axes' blocks of dimension `dim` concatenated (a
    parameter cut over the data axis, whole where it is used).  Backward:
    the gradient of the data axes' mean objective with respect to this
    rank's block: the whole weight's gradient from each rank's rows summed
    over the data axes, this rank's block kept (a reduce-scatter, done as
    an all-reduce and the rank's slice, which every backend offers), and
    divided by the data axes' size, as each data rank's loss is the mean
    over its rows and the objective their mean (`sum_lookups` does the
    same).  The parameter is its own data block (`specs.ParamLayout.
    data_cut`), so `grad_mean_dp` leaves its gradient alone."""

    @staticmethod
    def forward(ctx, x, dim, group, n, c):
        ctx.dim, ctx.group, ctx.n, ctx.c, ctx.w = dim, group, n, c, x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(n)]
        _all_gather(parts, x.contiguous(), group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _all_reduce(g, ctx.group)
        g = g.narrow(ctx.dim, ctx.c * ctx.w, ctx.w) / ctx.n
        return g.contiguous(), None, None, None, None


def gather_data(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The data axes' blocks of `x`'s dimension `dim`, in block order (a
    parameter the specs cut over the data axis, whole for its use), with
    the reduce-scatter of the mean objective's gradient for a backward
    (`_GatherData`).  The identity where the data axes have one rank."""
    g = group_of(("data",))
    if g is None:
        return x
    return _GatherData.apply(x, dim % x.dim(), *g)


def merge_attention(m: torch.Tensor, s: torch.Tensor, o: torch.Tensor,
                    axes) -> torch.Tensor:
    """Attention over a sequence split across the ranks of `axes`, from each
    rank's partial: m (...,) its block's max score, s (...,) the sum of
    exp(score - m) over its live keys, o (..., D) the unnormalised sum of
    those weights times V (s = 0 and o = 0 for a block with no live key).
    -> o / s over every block, fp32 (no gradient)."""
    g = group_of(axes)
    if g is not None:
        top = m.clone()
        _all_reduce(top, g[0], dist.ReduceOp.MAX)
        w = torch.exp(m - top)
        s, o = s * w, o * w[..., None]
        _all_reduce(s, g[0])
        _all_reduce(o, g[0])
    return o / s[..., None]


def exclusive_cumsum_dp(counts: torch.Tensor) -> torch.Tensor:
    """Per entry, the sum of `counts` over the data-axis ranks before this
    one (zeros on the first, or outside a data-parallel mesh)."""
    dp = _dp()
    if dp is None:
        return torch.zeros_like(counts)
    _, group, n = dp
    parts = [torch.empty_like(counts) for _ in range(n)]
    _all_gather(parts, counts.contiguous(), group)
    r = dp_rank()
    return torch.stack(parts[:r]).sum(0) if r else torch.zeros_like(counts)


def mean_over_tp(x: torch.Tensor) -> torch.Tensor:
    """Mean over the model axis of per-rank means over equal head counts:
    the mean over every head."""
    g = group_of(("model",))
    if g is None:
        return x
    return all_reduce(x) / g[1]


def gather_vocab(x: torch.Tensor, vocab: int) -> torch.Tensor:
    """The whole vocabulary's logits (..., vocab), fp32, from each rank's
    contiguous slice (..., vocab / tp): every rank writes its slice into a
    zeroed buffer and the buffers are summed, which is exact (one rank
    holds each entry) and needs only the all-reduce every backend
    offers."""
    g = group_of(("model",))
    if g is None:
        return x
    group, _, c = g
    n = x.shape[-1]
    out = x.new_zeros(x.shape[:-1] + (vocab,), dtype=torch.float32)
    out[..., c * n:(c + 1) * n] = x
    _all_reduce(out, group)
    return out


def decide(value):
    """`value` as the model axis's first rank has it: a host value that
    could differ between the ranks' processes (a measured time) is
    decided once and shared, so every rank plans the same next step."""
    g = group_of(("model",))
    if g is None:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=current().axis_ranks("model")[0], group=g[0])
    _count("object")
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
    g, mesh = group_of(("model",)), current()
    if g is None or not mesh.check:
        return
    group = g[0]
    mine = digest(value)
    got = [None] * mesh.shape["model"]
    dist.all_gather_object(got, mine, group=group)
    _count("object")
    mesh.log.append((tag, mine))
    if len(set(got)) != 1:
        raise RuntimeError(f"ranks {mesh.axis_ranks('model')} disagree on {tag} "
                           f"(entry {len(mesh.log)} of this rank's log): digests {got}")
