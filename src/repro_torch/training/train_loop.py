"""Fault-tolerant training loop of the port (the JAX package's
`training/train_loop.py`):

  * microbatch gradient accumulation: the sum of the microbatches'
    gradients divided by their count;
  * checkpoint / restart: asynchronous checkpoints every `ckpt_every`
    steps, auto-resume from the latest on (re)start, a failing step
    retried up to `max_retries` times and then the latest checkpoint
    restored (the single-process analogue of a node-failure restart);
  * gradient compression (int8, or top-k with error feedback);
  * the loss and gradient-norm history.

A model is an `nn.Module` updated in place; a loss function takes
(model, batch) and returns a scalar tensor.  Its parameters take
gradients only inside `trainable`, so the serving paths' frozen
parameters stay frozen.

On a mesh (the loop run inside ``sharding.ctx.axes(mesh)`` on every
rank, each with its shard of the model, its rows of each batch and a
`layout` per parameter from `sharding.specs.train_layout`), the
gradients are averaged over the data axis before compression, as the
reference compresses the already-reduced gradient; int8's scale is the
max over every shard of a tensor and top-k's threshold the k-th largest
magnitude of the whole tensor (its error feedback stays with the shard);
the loss reported is the data axis's mean.  A checkpoint holds the whole
model and optimizer state, gathered from the ranks and written by rank
0 in the single-device layout; a restore cuts every rank's block out of
it, so a checkpoint written at one mesh restores at another.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.checkpoint import checkpoint as CKPT
from repro_torch.sharding import ctx as CTX
from repro_torch.training import optimizer as OPT


@dataclass
class TrainConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep_ckpts: int = 3
    optimizer: str = "adamw"
    lr: float = 1e-3
    microbatches: int = 1
    max_retries: int = 3
    grad_compression: Optional[str] = None   # None | int8 | topk
    topk_frac: float = 0.05


@contextlib.contextmanager
def trainable(model: nn.Module):
    """Gradients on for every parameter of `model` while the block runs ->
    its named parameters; on exit each parameter's flag is restored and
    its gradient dropped."""
    named = list(model.named_parameters())
    before = [p.requires_grad for _, p in named]
    for _, p in named:
        p.requires_grad_(True)
    try:
        yield named
    finally:
        for (_, p), flag in zip(named, before):
            p.requires_grad_(flag)
            p.grad = None


# --------------------------- gradient compression ---------------------------
def compress_int8(g: torch.Tensor) -> torch.Tensor:
    """Simulated int8 all-reduce payload: per-tensor scale max|g| / 127,
    round half to even, clip to +-127, dequantise."""
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.to(g.dtype) * scale


def compress_topk(g: torch.Tensor, frac: float,
                  err: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k sparsification with error feedback: send the entries of
    g + err whose magnitude reaches the k-th largest (k = max(1, frac *
    size)); what is not sent becomes the next error."""
    flat = (g + err).reshape(-1)
    k = max(1, int(frac * flat.shape[0]))
    thresh = torch.topk(flat.abs(), k).values[-1]
    sent = torch.where(flat.abs() >= thresh, flat, torch.zeros_like(flat))
    return sent.reshape(g.shape), (flat - sent).reshape(g.shape)


def _cut_over(layout, nd: int) -> Tuple[str, ...]:
    """The axes (``"model"``, ``"data"``) a shard of `nd` dims is cut over."""
    return tuple(sorted({a for axes in OPT.cut_axes(layout, nd).values() for a in axes}))


def compress_int8_sharded(g: torch.Tensor, layout) -> torch.Tensor:
    """`compress_int8` of a shard, with the whole tensor's scale (the max
    over the axes where `layout` cuts it)."""
    axes = _cut_over(layout, g.dim())
    if not axes:
        return compress_int8(g)
    amax = g.abs().max()
    for a in axes:
        CTX.reduce_(amax, a, dist.ReduceOp.MAX)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.to(g.dtype) * scale


def compress_topk_sharded(g: torch.Tensor, frac: float, err: torch.Tensor,
                          layout) -> Tuple[torch.Tensor, torch.Tensor]:
    """`compress_topk` of a shard: k and the threshold from the whole
    tensor's magnitudes (gathered over the axes where `layout` cuts it),
    the error feedback this shard's."""
    axes = _cut_over(layout, g.dim())
    if not axes:
        return compress_topk(g, frac, err)
    flat = (g + err).reshape(-1)
    mags = flat.abs()
    for a in axes:
        mags = CTX.all_gather(mags, a, 0)
    k = max(1, int(frac * mags.shape[0]))
    thresh = torch.topk(mags, k).values[-1]
    sent = torch.where(flat.abs() >= thresh, flat, torch.zeros_like(flat))
    return sent.reshape(g.shape), (flat - sent).reshape(g.shape)


def apply_compression(params: List[torch.Tensor], cfg: TrainConfig,
                      err_state: Optional[List[torch.Tensor]], layouts=None) -> None:
    """Compress every parameter's `.grad` in place (top-k also advances
    `err_state`, one fp32 tensor per parameter); `layouts`: the
    parameters' `specs.ParamLayout`s on a mesh."""
    if cfg.grad_compression is None:
        return
    if cfg.grad_compression not in ("int8", "topk"):
        raise ValueError(cfg.grad_compression)
    layouts = layouts or [None] * len(params)
    for i, (p, lay) in enumerate(zip(params, layouts)):
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        if cfg.grad_compression == "int8":
            p.grad = compress_int8_sharded(g, lay)
        else:
            sent, err_state[i] = compress_topk_sharded(g, cfg.topk_frac, err_state[i], lay)
            p.grad = sent.to(g.dtype)


# --------------------------------- loop -------------------------------------
def to_device(batch: Dict, device) -> Dict:
    """A batch's numpy arrays and tensors on `device` (other values as
    they are)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = v.to(device) if isinstance(v, torch.Tensor) else v
    return out


def _microbatches(batch: Dict, n: int) -> List[Dict]:
    """The reference's split: every array reshaped to (n, B / n, ...)."""
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"{k}: batch {v.shape[0]} not divisible by {n} microbatches")
    return [{k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))[i]
             for k, v in batch.items()} for i in range(n)]


def make_train_step(loss_fn: Callable, cfg: TrainConfig, model: nn.Module,
                    optimizer: OPT.ClippedOptimizer,
                    err_state: Optional[List[torch.Tensor]] = None,
                    data_mean: bool = True) -> Callable:
    """-> step(batch) -> {"loss", "gnorm"} (0-d tensors): gradients of
    `loss_fn(model, batch)` (summed over `cfg.microbatches` microbatches
    and divided by their count; the loss is their mean), compressed,
    then one optimizer update in place.  The model's parameters must take
    gradients (`trainable`).  Under data parallelism the loss and the
    gradients are averaged over the data axis (`data_mean`: each data
    rank's loss is the mean over its rows), but a parameter that is its
    own block over the data axis (``layout.data_cut``), whose gradient
    is already its share; without `data_mean` every rank computes the
    whole loss (a graph cut by edges) and nothing is averaged."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    device = params[0].device

    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        batch = to_device(batch, device)
        for p in params:
            p.grad = None
        if cfg.microbatches > 1:
            losses = []
            for mb in _microbatches(batch, cfg.microbatches):
                loss = loss_fn(model, mb)
                loss.backward()
                losses.append(loss.detach())
            with torch.no_grad():
                for p in params:
                    if p.grad is not None:
                        p.grad.div_(cfg.microbatches)
            loss = torch.stack(losses).mean()
        else:
            loss = loss_fn(model, batch)
            loss.backward()
            loss = loss.detach()
        if CTX.dp_size() > 1 and data_mean:
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            layouts = optimizer.layouts or [None] * len(params)
            CTX.grad_mean_dp([p.grad for p, lay in zip(params, layouts)
                              if lay is None or not lay.data_cut])
            loss = CTX.mean_over_dp(loss)
        apply_compression(params, cfg, err_state, optimizer.layouts)
        gnorm = optimizer.step()
        return {"loss": loss, "gnorm": gnorm}

    return step


def _state(model: nn.Module, optimizer: OPT.ClippedOptimizer) -> Dict:
    return {"params": dict(model.named_parameters()), "opt": optimizer.opt_state()}


def _sharded(optimizer: OPT.ClippedOptimizer) -> bool:
    return optimizer.layouts is not None and (CTX.tp_size() > 1 or CTX.dp_size() > 1)


def _whole(t: torch.Tensor, layout, moment: Optional[torch.Size] = None) -> torch.Tensor:
    """The whole tensor of which `t` is this rank's block: a moment's
    (`moment`: the rank's parameter's shape) ZeRO block gathered over the
    data axis first, then the data-axis cut of a parameter (and of the
    state that lies with it), then the model cut."""
    if moment is not None and layout.data_split and CTX.dp_size() > 1:
        if layout.data_dim is not None:
            t = CTX.all_gather(t.contiguous(), "data", layout.data_dim)
        else:
            mine = CTX.dp_rank() == layout.data_owner
            full = t.clone() if mine else torch.zeros(moment, dtype=t.dtype, device=t.device)
            t = CTX.broadcast_(full, "data", layout.data_owner)
    for d in (layout.data_dims if CTX.dp_size() > 1 else ()):
        t = CTX.all_gather(t.contiguous(), "data", d)
    for d in (layout.model_dims if CTX.tp_size() > 1 else ()):
        t = CTX.all_gather(t.contiguous(), "model", d)
    return t


def _block(whole: torch.Tensor, layout, moment: bool) -> torch.Tensor:
    """This rank's block of a whole tensor (the inverse of `_whole`)."""
    t = whole
    for d in (layout.model_dims if CTX.tp_size() > 1 else ()):
        step = t.shape[d] // CTX.tp_size()
        t = t.narrow(d, CTX.current().coords["model"] * step, step)
    for d in (layout.data_dims if CTX.dp_size() > 1 else ()):
        step = t.shape[d] // CTX.dp_size()
        t = t.narrow(d, CTX.dp_rank() * step, step)
    return OPT.data_block(t, layout) if moment else t


def whole_state(model: nn.Module, optimizer: OPT.ClippedOptimizer) -> Dict:
    """The checkpointed state of the whole model: its parameters and the
    optimizer's, gathered from the ranks on a mesh (a collective: every
    rank calls it)."""
    if not _sharded(optimizer):
        return _state(model, optimizer)
    lays = dict(zip(optimizer.names, optimizer.layouts))
    shapes = {n: p.shape for n, p in model.named_parameters()}
    st = optimizer.opt_state()
    return {"params": {n: _whole(p.detach(), lays[n]) for n, p in model.named_parameters()},
            "opt": OPT.OptState(step=st.step, inner={
                n: {k: _whole(v, OPT.state_layout(lays[n], k, len(shapes[n])),
                              shapes[n] if optimizer.zero else None)
                    for k, v in moments.items()}
                for n, moments in st.inner.items()})}


@torch.no_grad()
def _load(model: nn.Module, optimizer: OPT.ClippedOptimizer, state: Dict) -> None:
    if _sharded(optimizer):
        lays = dict(zip(optimizer.names, optimizer.layouts))
        nd = {n: t.dim() for n, t in state["params"].items()}
        state = {"params": {n: _block(t, lays[n], False) for n, t in state["params"].items()},
                 "opt": OPT.OptState(step=state["opt"].step, inner={
                     n: {k: _block(v, OPT.state_layout(lays[n], k, nd[n]), optimizer.zero)
                         for k, v in m.items()}
                     for n, m in state["opt"].inner.items()})}
    for name, p in model.named_parameters():
        p.copy_(state["params"][name])
    optimizer.load_opt_state(state["opt"])


def _restore(model, optimizer, ckpt_dir: str, step: int) -> None:
    like = _state(model, optimizer)
    _load(model, optimizer, CKPT.restore(ckpt_dir, step, like))


def _writer() -> bool:
    """Whether this process writes the checkpoints: rank 0 of a launched
    run, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _published(ckpt) -> None:
    """Every pending write finished (rank 0), and every rank past that
    point, so each reads the same latest step."""
    if ckpt is not None:
        ckpt.wait()
    if dist.is_initialized() and CTX.current() is not None:
        dist.barrier()


def _save(ckpt, step: int, model, optimizer) -> None:
    state = whole_state(model, optimizer)      # every rank: a collective
    if ckpt is not None:
        ckpt.save_async(step, state)


def train(model: nn.Module, loss_fn: Callable, data_iter: Iterator, cfg: TrainConfig,
          fail_injector: Optional[Callable[[int], None]] = None, layout=None
          ) -> Tuple[nn.Module, OPT.ClippedOptimizer, List[Dict[str, float]]]:
    """Run the loop to `cfg.steps`; auto-resume from the latest checkpoint
    in `cfg.ckpt_dir`; a step that raises RuntimeError (or whose
    `fail_injector(step)` does) is retried, and after `max_retries`
    failures the latest checkpoint is restored and the loop goes on from
    it.  `layout`: the parameters' `specs.ParamLayout`s when `model` is a
    rank's shard on the current mesh (the module docstring).  -> (model,
    optimizer, one {"loss", "gnorm"} per step run)."""
    with trainable(model) as named:
        optimizer = OPT.get(cfg.optimizer, named, lr=cfg.lr, layout=layout)
        params = [p for _, p in named]
        err_state = ([torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                      for p in params] if cfg.grad_compression == "topk" else None)
        ckpt = None
        step = 0
        if cfg.ckpt_dir:
            if _writer():
                ckpt = CKPT.AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep_ckpts)
            last = CKPT.latest_step(cfg.ckpt_dir)
            if last is not None:
                _restore(model, optimizer, cfg.ckpt_dir, last)
                step = last
        step_fn = make_train_step(loss_fn, cfg, model, optimizer, err_state)
        history = []
        try:
            while step < cfg.steps:
                batch = next(data_iter)
                retries = 0
                while True:
                    try:
                        if fail_injector is not None:
                            fail_injector(step)      # may raise (simulated failure)
                        metrics = step_fn(batch)
                        break
                    except RuntimeError:
                        retries += 1
                        if retries <= cfg.max_retries:
                            continue
                        # unrecoverable on this "node": resume from checkpoint
                        if not cfg.ckpt_dir:
                            raise
                        _published(ckpt)
                        last = CKPT.latest_step(cfg.ckpt_dir)
                        if last is None:
                            raise
                        _restore(model, optimizer, cfg.ckpt_dir, last)
                        step = last
                        retries = 0
                history.append({k: float(v) for k, v in metrics.items()})
                step += 1
                if cfg.ckpt_dir and step % cfg.ckpt_every == 0:
                    _save(ckpt, step, model, optimizer)
            if cfg.ckpt_dir:
                _save(ckpt, cfg.steps, model, optimizer)
        finally:
            if ckpt is not None:
                ckpt.close()
    return model, optimizer, history
