"""Optimizers of the port: AdamW, Adafactor (factored second moments) and
SGD, each clipping the gradients by their global norm first, with the
JAX package's formulas (`repro/training/optimizer.py`).

Each rule is a `torch.optim.Optimizer` over a model's parameters, given
as `(name, tensor)` pairs (`model.named_parameters()`) or as tensors.
`step()` reads every parameter's `.grad` (a parameter without one counts
as a zero gradient, as the reference's full gradient tree has zeros
there), clips them by `min(1, max_norm / max(norm, 1e-9))`, updates the
parameters in place in fp32 and casts back to each parameter's dtype,
and returns the pre-clip global norm.  `opt_state()` /
`load_opt_state()` give and take the reference's `OptState(step,
inner)`, with `inner` keyed by parameter name.

AdamW and SGD are elementwise, so a parameter above `CHUNK` elements is
updated in row blocks: the fp32 temporaries of a 256,000 x 6,144
embedding would otherwise take 6.3 GB each.

On a mesh (built and stepped inside ``sharding.ctx.axes(mesh)``, with a
`layout` per parameter from `sharding.specs.train_layout`) each rank
holds its shard of every parameter, and the gradients are already the
data axis's mean.  The global norm counts each element of the whole
model once: the squares of model-cut parameters are summed over the
model axis, replicated ones (norms, the router) counted once, and the
squares of the data-axis blocks the moments live on (or that a
parameter itself is, a recsys table's rows) summed over the data axis.
AdamW keeps its moments on the rank's ZeRO block (`ParamLayout`),
updates that block of the parameter and all-gathers
the parameter over the data axis; a parameter that is itself cut over
the data axes (``data_cut``: an MoE's expert-ff blocks) keeps its moments
with it and needs no gather.  Adafactor keeps ``vr`` / ``vc`` on the
parameter's own layout; its factored means along a dimension cut over the
model axis (or the data axes), and the update's RMS clip and the
parameter's RMS over the whole tensor, are reduced over those axes.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Callable, Dict, Iterable, Iterator, List, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.sharding import ctx as CTX

CHUNK = 1 << 26


class OptState(NamedTuple):
    step: int
    inner: Dict[str, Dict[str, torch.Tensor]]   # parameter name -> its moments


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over tensors of their fp32 sums of squares."""
    sq = [torch.linalg.vector_norm(g, dtype=torch.float32).square() for g in grads]
    return torch.sqrt(torch.stack(sq).sum())


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / max(norm, 1e-9))."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: List[torch.Tensor],
                        max_norm: float) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """(each gradient in fp32 times `clip_scale`, the norm).  The rules
    apply the scale inside their update instead, without the copies."""
    norm = global_norm(grads)
    scale = clip_scale(norm, max_norm)
    return [g.float() * scale for g in grads], norm


def _rows(t: torch.Tensor) -> Iterator[torch.Tensor]:
    """`t` as views of at most ~CHUNK elements, split along dim 0."""
    if t.numel() <= CHUNK or t.dim() == 0:
        yield t
        return
    step = max(1, CHUNK // max(1, t[0].numel()))
    for i in range(0, t.shape[0], step):
        yield t[i:i + step]


Params = Union[Iterable[torch.Tensor], Iterable[Tuple[str, torch.Tensor]]]


def data_block(t: torch.Tensor, layout) -> torch.Tensor:
    """This rank's block of `t` over the data axis under `layout` (a
    `specs.ParamLayout`, or None: whole): the slice of its ``data_dim``,
    the whole tensor on the ``data_owner`` rank and an empty view on the
    others, or `t` itself."""
    n = CTX.dp_size()
    if layout is None or n == 1 or not layout.data_split:
        return t
    c = CTX.dp_rank()
    if layout.data_dim is not None:
        step = t.shape[layout.data_dim] // n
        return t.narrow(layout.data_dim, c * step, step)
    return t if c == layout.data_owner else t.narrow(0, 0, 0)


def gather_data_block(t: torch.Tensor, layout) -> None:
    """Every data rank's updated block of `t` written back into `t` (the
    inverse of `data_block`, over the data axis)."""
    if layout is None or CTX.dp_size() == 1 or not layout.data_split:
        return
    if layout.data_dim is not None:
        t.copy_(CTX.all_gather(data_block(t, layout).contiguous(), "data", layout.data_dim))
    else:
        CTX.broadcast_(t, "data", layout.data_owner)


def state_layout(layout, key: str, nd: int):
    """The layout of a parameter's state entry `key` (the parameter's
    `layout`, `nd` dims): Adafactor's ``vr`` drops the last dim and
    ``vc`` the second-to-last, so a model cut along a dim a factor drops
    leaves that factor whole (its mean was reduced over the axis)."""
    if layout is None or key not in ("vr", "vc"):
        return layout
    def drop(dims):
        if key == "vr":
            return tuple(d for d in dims if d < nd - 1)
        return tuple(d if d < nd - 2 else nd - 2 for d in dims if d != nd - 2)
    return dataclasses.replace(layout, model_dims=drop(layout.model_dims), data_dim=None,
                               data_owner=None, data_dims=drop(layout.data_dims))


def _sq(t: torch.Tensor) -> torch.Tensor:
    if t.device.type == "cpu":
        # a strided block (a ZeRO cut off dim 0) takes the CPU's plain
        # reduction loop: 2.6e-4 relative on one thread at 1293 x 512
        t = t.contiguous()
    return torch.linalg.vector_norm(t, dtype=torch.float32).square()


def sharded_norm(grads: List[torch.Tensor], layouts) -> torch.Tensor:
    """The global norm of gradients held as shards (the module docstring):
    each element of the whole model counted once."""
    dev = grads[0].device
    # (model-cut, replicated) x (data block, whole over the data axis)
    sums = torch.zeros(4, dtype=torch.float32, device=dev)
    for g, lay in zip(grads, layouts):
        split = (lay.data_split or lay.data_cut) and CTX.dp_size() > 1
        sums[(0 if lay.model_dims and CTX.tp_size() > 1 else 1) + (0 if split else 2)] += \
            _sq(data_block(g, lay))
    cut = torch.stack([sums[0], sums[2]])
    CTX.reduce_(cut, "model")
    blocks = cut[0] + sums[1]
    CTX.reduce_(blocks, "data")
    return torch.sqrt(blocks + cut[1] + sums[3])


class ClippedOptimizer(torch.optim.Optimizer):
    """The rules' common part: named parameters, the global-norm clip and
    the step count.  A subclass implements `_init_state(p, layout)` and
    `_update(p, g, state, t, scale, layout)` (g is the raw gradient,
    `scale` the clip factor, a 0-d fp32 tensor, `layout` the parameter's
    `specs.ParamLayout` on a mesh, else None).  A rule whose state lives
    on the data block (``zero = True``) gets that block in
    `_init_state`."""

    zero = False

    def __init__(self, params: Params, defaults: Dict, grad_clip: float,
                 layout: Optional[Dict[str, object]] = None):
        items = list(params)
        if items and isinstance(items[0], tuple):
            self.names = [n for n, _ in items]
            tensors = [p for _, p in items]
        else:
            self.names = [str(i) for i in range(len(items))]
            tensors = items
        super().__init__(tensors, dict(defaults, grad_clip=grad_clip))
        self.layouts = None if layout is None else [layout[n] for n in self.names]
        self.t = 0
        self.last_gnorm = None
        for i, p in enumerate(tensors):
            lay = None if self.layouts is None else self.layouts[i]
            self.state[p] = self._init_state(data_block(p, lay) if self.zero else p, lay)

    def _params(self) -> List[torch.Tensor]:
        return [p for group in self.param_groups for p in group["params"]]

    @torch.no_grad()
    def step(self, closure: Callable = None) -> torch.Tensor:
        if closure is not None:
            with torch.enable_grad():
                closure()
        params = self._params()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        layouts = self.layouts or [None] * len(params)
        split = self.layouts is not None and (CTX.tp_size() > 1 or CTX.dp_size() > 1)
        gnorm = sharded_norm(grads, layouts) if split else global_norm(grads)
        scale = clip_scale(gnorm, self.defaults["grad_clip"])
        self.t += 1
        for p, g, lay in zip(params, grads, layouts):
            self._update(p, g, self.state[p], self.t, scale, lay)
        self.last_gnorm = gnorm
        return gnorm

    def opt_state(self) -> OptState:
        return OptState(step=self.t, inner={n: dict(self.state[p])
                                            for n, p in zip(self.names, self._params())})

    @torch.no_grad()
    def load_opt_state(self, state: OptState) -> None:
        self.t = int(state.step)
        for n, p in zip(self.names, self._params()):
            for k, v in state.inner[n].items():
                self.state[p][k].copy_(v)


class AdamW(ClippedOptimizer):
    """m = b1 m + (1-b1) g; v = b2 v + (1-b2) g^2; p <- p - lr (m_hat /
    (sqrt(v_hat) + eps) + wd p), with the bias corrections 1 - b^t in
    fp32 and the moments in fp32."""

    zero = True

    def __init__(self, params: Params, lr: float = 1e-4, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.01, grad_clip: float = 1.0,
                 layout: Optional[Dict[str, object]] = None):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay), grad_clip, layout)

    def _init_state(self, p, layout=None):
        return {"m": torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                "v": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}

    def _update(self, p, g, state, t, scale, layout=None):
        d = self.defaults
        b1, b2 = d["b1"], d["b2"]
        tt = torch.tensor(float(t), dtype=torch.float32, device=p.device)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=p.device) ** tt
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=p.device) ** tt
        whole = p
        p, g = data_block(p, layout), data_block(g, layout)
        for pc, gc, m, v in zip(_rows(p), _rows(g), _rows(state["m"]), _rows(state["v"])):
            gf = gc.float() * scale
            m.mul_(b1).add_(gf, alpha=1 - b1)
            v.mul_(b2).add_((1 - b2) * gf * gf)
            del gf
            upd = (m / bc1).div_(torch.sqrt(v / bc2).add_(d["eps"]))
            pf = pc.float()
            upd.add_(pf, alpha=d["weight_decay"])
            pc.copy_(pf.sub_(upd, alpha=d["lr"]))
        gather_data_block(whole, layout)


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def whole_shape(p: torch.Tensor, layout) -> Tuple[int, ...]:
    """The whole parameter's shape of which `p` is a rank's shard."""
    shape = list(p.shape)
    if layout is not None:
        for d in layout.model_dims:
            shape[d] *= CTX.tp_size()
        for d in layout.data_dims:
            shape[d] *= CTX.dp_size()
    return tuple(shape)


def cut_axes(layout, nd: int) -> Dict[int, Tuple[str, ...]]:
    """Per dimension of a rank's `nd`-dim shard, the axes it is cut over
    (``"model"``, ``"data"``) where they have more than one rank."""
    cut: Dict[int, Tuple[str, ...]] = {}
    if layout is None:
        return cut
    for dims, axis, n in ((layout.model_dims, "model", CTX.tp_size()),
                          (layout.data_dims, "data", CTX.dp_size())):
        if n > 1:
            for d in dims:
                cut[d % nd] = cut.get(d % nd, ()) + (axis,)
    return cut


def _axes_size(axes) -> int:
    n = 1
    for a in axes:
        n *= CTX.tp_size() if a == "model" else CTX.dp_size()
    return n


def _reduce_over(x: torch.Tensor, axes) -> torch.Tensor:
    for a in axes:
        CTX.reduce_(x, a)
    return x


class Adafactor(ClippedOptimizer):
    """Shazeer & Stern (arXiv:1804.04235), momentum-free: beta = 1 -
    (t+1)^-decay; a matrix keeps row and column means of g^2 + eps1
    (`vr` (..., rows), `vc` (..., cols)), anything else the full `v`; the
    update is RMS-clipped at `clip_threshold` and scaled by max(eps2,
    rms(p))."""

    def __init__(self, params: Params, lr: float = 1e-3, decay: float = 0.8,
                 eps1: float = 1e-30, eps2: float = 1e-3, clip_threshold: float = 1.0,
                 grad_clip: float = 1.0, layout: Optional[Dict[str, object]] = None):
        super().__init__(params, dict(lr=lr, decay=decay, eps1=eps1, eps2=eps2,
                                      clip_threshold=clip_threshold), grad_clip, layout)

    def _init_state(self, p, layout=None):
        # factored or not as the whole parameter is (a shard of 2 kv heads
        # holds 1)
        kw = dict(dtype=torch.float32, device=p.device)
        if _factored(whole_shape(p, layout)):
            return {"vr": torch.zeros(p.shape[:-1], **kw),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **kw)}
        return {"v": torch.zeros(p.shape, **kw)}

    def _update(self, p, g, state, t, scale, layout=None):
        d = self.defaults
        eps1 = d["eps1"]
        beta = 1.0 - (torch.tensor(float(t), dtype=torch.float32, device=p.device) + 1.0) \
            ** -d["decay"]
        nd = p.dim()
        cut = cut_axes(layout, nd)
        every = tuple(sorted({a for axes in cut.values() for a in axes}))

        def mean(x, dim, along, keepdim=False):
            # x's mean along `dim`, the whole dimension's where `along` (a
            # dim of p) is cut over the model axis or the data axes
            if along not in cut:
                return x.mean(dim=dim, keepdim=keepdim)
            return _reduce_over(x.sum(dim=dim, keepdim=keepdim), cut[along]) / \
                (x.shape[dim] * _axes_size(cut[along]))

        def mean_all(x):
            if not cut:
                return torch.mean(x)
            return _reduce_over(x.sum(), every) / (x.numel() * _axes_size(every))

        g = g.float() * scale
        g2 = g * g + eps1
        if "vr" in state:
            vr = beta * state["vr"] + (1 - beta) * mean(g2, -1, nd - 1)
            vc = beta * state["vc"] + (1 - beta) * mean(g2, -2, nd - 2)
            denom = torch.clamp(mean(vr, -1, nd - 2, keepdim=True), min=eps1)
            u = g * torch.rsqrt(vr[..., None] / denom[..., None]) * torch.rsqrt(vc[..., None, :])
            state["vr"].copy_(vr)
            state["vc"].copy_(vc)
        else:
            v = beta * state["v"] + (1 - beta) * g2
            u = g * torch.rsqrt(v)
            state["v"].copy_(v)
        rms_u = torch.sqrt(mean_all(u * u) + eps1)
        u = u / torch.clamp(rms_u / d["clip_threshold"], min=1.0)
        pf = p.float()
        pscale = torch.clamp(torch.sqrt(mean_all(pf * pf)), min=d["eps2"])
        p.copy_(pf - d["lr"] * pscale * u)


class SGD(ClippedOptimizer):
    """p <- p - lr g (clipped), in fp32."""

    def __init__(self, params: Params, lr: float = 1e-2, grad_clip: float = 1.0,
                 layout: Optional[Dict[str, object]] = None):
        super().__init__(params, dict(lr=lr), grad_clip, layout)

    def _init_state(self, p, layout=None):
        return {}

    def _update(self, p, g, state, t, scale, layout=None):
        for pc, gc in zip(_rows(p), _rows(g)):
            pc.copy_(pc.float() - self.defaults["lr"] * (gc.float() * scale))


RULES = {"adamw": AdamW, "adafactor": Adafactor, "sgd": SGD}


def get(name: str, params: Params, **kw) -> ClippedOptimizer:
    """The rule `name` (adamw | adafactor | sgd) over `params`."""
    return RULES[name](params, **kw)


def _shape_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _shape_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def abstract_opt_state(name: str, params_abstract) -> OptState:
    """The state of rule `name` for a parameter tree with ``.shape``
    leaves, in the reference's layout (`optimizer.abstract_opt_state` of
    its ``init``): AdamW ``{"m": tree, "v": tree}``, Adafactor a
    ``{"vr", "vc"}`` or ``{"v"}`` dict per leaf, SGD ``()``; leaves are
    shapes only."""
    shape = lambda *s: SimpleNamespace(shape=tuple(s))
    if name == "sgd":
        inner = ()
    elif name == "adamw":
        same = lambda p: shape(*p.shape)
        inner = {"m": _shape_map(same, params_abstract), "v": _shape_map(same, params_abstract)}
    elif name == "adafactor":
        def one(p):
            if _factored(p.shape):
                return {"vr": shape(*p.shape[:-1]), "vc": shape(*(p.shape[:-2] + p.shape[-1:]))}
            return {"v": shape(*p.shape)}
        inner = _shape_map(one, params_abstract)
    else:
        raise KeyError(name)
    return OptState(step=shape(), inner=inner)
