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
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Iterator, List, NamedTuple, Tuple, Union

import torch

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


class ClippedOptimizer(torch.optim.Optimizer):
    """The rules' common part: named parameters, the global-norm clip and
    the step count.  A subclass implements `_init_state(p)` and
    `_update(p, g, state, t, scale)` (g is the raw gradient, `scale` the
    clip factor, a 0-d fp32 tensor)."""

    def __init__(self, params: Params, defaults: Dict, grad_clip: float):
        items = list(params)
        if items and isinstance(items[0], tuple):
            self.names = [n for n, _ in items]
            tensors = [p for _, p in items]
        else:
            self.names = [str(i) for i in range(len(items))]
            tensors = items
        super().__init__(tensors, dict(defaults, grad_clip=grad_clip))
        self.t = 0
        self.last_gnorm = None
        for p in tensors:
            self.state[p] = self._init_state(p)

    def _params(self) -> List[torch.Tensor]:
        return [p for group in self.param_groups for p in group["params"]]

    @torch.no_grad()
    def step(self, closure: Callable = None) -> torch.Tensor:
        if closure is not None:
            with torch.enable_grad():
                closure()
        params = self._params()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        gnorm = global_norm(grads)
        scale = clip_scale(gnorm, self.defaults["grad_clip"])
        self.t += 1
        for p, g in zip(params, grads):
            self._update(p, g, self.state[p], self.t, scale)
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

    def __init__(self, params: Params, lr: float = 1e-4, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.01, grad_clip: float = 1.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay), grad_clip)

    def _init_state(self, p):
        return {"m": torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                "v": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}

    def _update(self, p, g, state, t, scale):
        d = self.defaults
        b1, b2 = d["b1"], d["b2"]
        tt = torch.tensor(float(t), dtype=torch.float32, device=p.device)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=p.device) ** tt
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=p.device) ** tt
        for pc, gc, m, v in zip(_rows(p), _rows(g), _rows(state["m"]), _rows(state["v"])):
            gf = gc.float() * scale
            m.mul_(b1).add_(gf, alpha=1 - b1)
            v.mul_(b2).add_((1 - b2) * gf * gf)
            del gf
            upd = (m / bc1).div_(torch.sqrt(v / bc2).add_(d["eps"]))
            pf = pc.float()
            upd.add_(pf, alpha=d["weight_decay"])
            pc.copy_(pf.sub_(upd, alpha=d["lr"]))


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


class Adafactor(ClippedOptimizer):
    """Shazeer & Stern (arXiv:1804.04235), momentum-free: beta = 1 -
    (t+1)^-decay; a matrix keeps row and column means of g^2 + eps1
    (`vr` (..., rows), `vc` (..., cols)), anything else the full `v`; the
    update is RMS-clipped at `clip_threshold` and scaled by max(eps2,
    rms(p))."""

    def __init__(self, params: Params, lr: float = 1e-3, decay: float = 0.8,
                 eps1: float = 1e-30, eps2: float = 1e-3, clip_threshold: float = 1.0,
                 grad_clip: float = 1.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps1=eps1, eps2=eps2,
                                      clip_threshold=clip_threshold), grad_clip)

    def _init_state(self, p):
        kw = dict(dtype=torch.float32, device=p.device)
        if _factored(p.shape):
            return {"vr": torch.zeros(p.shape[:-1], **kw),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **kw)}
        return {"v": torch.zeros(p.shape, **kw)}

    def _update(self, p, g, state, t, scale):
        d = self.defaults
        eps1 = d["eps1"]
        beta = 1.0 - (torch.tensor(float(t), dtype=torch.float32, device=p.device) + 1.0) \
            ** -d["decay"]
        g = g.float() * scale
        g2 = g * g + eps1
        if _factored(p.shape):
            vr = beta * state["vr"] + (1 - beta) * g2.mean(dim=-1)
            vc = beta * state["vc"] + (1 - beta) * g2.mean(dim=-2)
            denom = torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps1)
            u = g * torch.rsqrt(vr[..., None] / denom[..., None]) * torch.rsqrt(vc[..., None, :])
            state["vr"].copy_(vr)
            state["vc"].copy_(vc)
        else:
            v = beta * state["v"] + (1 - beta) * g2
            u = g * torch.rsqrt(v)
            state["v"].copy_(v)
        rms_u = torch.sqrt(torch.mean(u * u) + eps1)
        u = u / torch.clamp(rms_u / d["clip_threshold"], min=1.0)
        pf = p.float()
        pscale = torch.clamp(torch.sqrt(torch.mean(pf * pf)), min=d["eps2"])
        p.copy_(pf - d["lr"] * pscale * u)


class SGD(ClippedOptimizer):
    """p <- p - lr g (clipped), in fp32."""

    def __init__(self, params: Params, lr: float = 1e-2, grad_clip: float = 1.0):
        super().__init__(params, dict(lr=lr), grad_clip)

    def _init_state(self, p):
        return {}

    def _update(self, p, g, state, t, scale):
        for pc, gc in zip(_rows(p), _rows(g)):
            pc.copy_(pc.float() - self.defaults["lr"] * (gc.float() * scale))


RULES = {"adamw": AdamW, "adafactor": Adafactor, "sgd": SGD}


def get(name: str, params: Params, **kw) -> ClippedOptimizer:
    """The rule `name` (adamw | adafactor | sgd) over `params`."""
    return RULES[name](params, **kw)
