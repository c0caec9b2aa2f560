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
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.checkpoint import checkpoint as CKPT
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


def apply_compression(params: List[torch.Tensor], cfg: TrainConfig,
                      err_state: Optional[List[torch.Tensor]]) -> None:
    """Compress every parameter's `.grad` in place (top-k also advances
    `err_state`, one fp32 tensor per parameter)."""
    if cfg.grad_compression is None:
        return
    if cfg.grad_compression not in ("int8", "topk"):
        raise ValueError(cfg.grad_compression)
    for i, p in enumerate(params):
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        if cfg.grad_compression == "int8":
            p.grad = compress_int8(g)
        else:
            sent, err_state[i] = compress_topk(g, cfg.topk_frac, err_state[i])
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
                    err_state: Optional[List[torch.Tensor]] = None) -> Callable:
    """-> step(batch) -> {"loss", "gnorm"} (0-d tensors): gradients of
    `loss_fn(model, batch)` (summed over `cfg.microbatches` microbatches
    and divided by their count; the loss is their mean), compressed,
    then one optimizer update in place.  The model's parameters must take
    gradients (`trainable`)."""
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
        apply_compression(params, cfg, err_state)
        gnorm = optimizer.step()
        return {"loss": loss, "gnorm": gnorm}

    return step


def _state(model: nn.Module, optimizer: OPT.ClippedOptimizer) -> Dict:
    return {"params": dict(model.named_parameters()), "opt": optimizer.opt_state()}


@torch.no_grad()
def _load(model: nn.Module, optimizer: OPT.ClippedOptimizer, state: Dict) -> None:
    for name, p in model.named_parameters():
        p.copy_(state["params"][name])
    optimizer.load_opt_state(state["opt"])


def _restore(model, optimizer, ckpt_dir: str, step: int) -> None:
    _load(model, optimizer, CKPT.restore(ckpt_dir, step, _state(model, optimizer)))


def train(model: nn.Module, loss_fn: Callable, data_iter: Iterator, cfg: TrainConfig,
          fail_injector: Optional[Callable[[int], None]] = None
          ) -> Tuple[nn.Module, OPT.ClippedOptimizer, List[Dict[str, float]]]:
    """Run the loop to `cfg.steps`; auto-resume from the latest checkpoint
    in `cfg.ckpt_dir`; a step that raises RuntimeError (or whose
    `fail_injector(step)` does) is retried, and after `max_retries`
    failures the latest checkpoint is restored and the loop goes on from
    it.  -> (model, optimizer, one {"loss", "gnorm"} per step run)."""
    with trainable(model) as named:
        optimizer = OPT.get(cfg.optimizer, named, lr=cfg.lr)
        params = [p for _, p in named]
        err_state = ([torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                      for p in params] if cfg.grad_compression == "topk" else None)
        ckpt = None
        step = 0
        if cfg.ckpt_dir:
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
                        if ckpt is None:
                            raise
                        ckpt.wait()
                        last = CKPT.latest_step(cfg.ckpt_dir)
                        if last is None:
                            raise
                        _restore(model, optimizer, cfg.ckpt_dir, last)
                        step = last
                        retries = 0
                history.append({k: float(v) for k, v in metrics.items()})
                step += 1
                if ckpt is not None and step % cfg.ckpt_every == 0:
                    ckpt.save_async(step, _state(model, optimizer))
            if ckpt is not None:
                ckpt.save_async(cfg.steps, _state(model, optimizer))
        finally:
            if ckpt is not None:
                ckpt.close()
    return model, optimizer, history
