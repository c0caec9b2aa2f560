"""Planted-preference training for the accuracy protocol (the JAX
package's `core/ranker_training.py`).

Creates a learnable ranking task: each request has a gold candidate whose
evidence is planted in the user's history (the user "reviewed" tokens
from the gold item), and the LM is trained to emit the gold candidate's
slot token after RANK_QUERY.  This gives Table III-style metrics teeth:
an untrained model ranks at random, so approximation error would be
invisible.  `make_planted_trace` and `_batchify` are numpy and give the
reference's arrays for the same seed; `train_ranker` trains the port's
model in place (AdamW, no weight decay), its attention gradient through
kernel K6 on the card.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.data import synth as SY
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as OPT
from repro_torch.training.train_loop import trainable


def make_planted_trace(catalog: SY.Catalog, pool: SY.ReviewPool,
                       profile: SY.DatasetProfile, n_requests: int,
                       n_candidates: int = 8, n_users: int = 50,
                       evidence_tokens: int = 12, seed: int = 11
                       ) -> Tuple[List[SY.Request], np.ndarray]:
    """Trace whose gold candidate is recoverable from the history: the
    first `evidence_tokens` tokens of the gold item appended to each
    user's history after a REVIEW_SEP.  -> (requests, gold slot per
    request)."""
    rng = np.random.default_rng(seed)
    # low cluster bias -> candidates span clusters, so the planted evidence
    # (gold-item tokens in the history) identifies a unique candidate
    base = SY.make_trace(catalog, pool, profile, n_requests=n_requests,
                         qps=10.0, n_users=n_users,
                         n_candidates=n_candidates, reviews_per_user=2,
                         seed=seed, cluster_bias=0.15)
    gold = np.zeros(len(base), np.int64)
    out = []
    for i, r in enumerate(base):
        g = int(rng.integers(0, n_candidates))
        gold[i] = g
        ev = catalog.item_tokens[int(r.candidate_items[g])][:evidence_tokens]
        hist = np.concatenate([r.history_tokens, [SY.REVIEW_SEP], ev]).astype(np.int32)
        mark = np.concatenate([r.history_marker_mask, [True], np.zeros(len(ev), bool)])
        out.append(dataclasses.replace(r, history_tokens=hist, history_marker_mask=mark))
    return out, gold


def _batchify(requests, gold, catalog, instruction, pad_to: int):
    """-> (tokens (N, pad_to) zero-padded, last prompt position (N,), gold
    slot token (N,)), int32."""
    toks, lastpos, labels = [], [], []
    for r, g in zip(requests, gold):
        t, _, _ = r.prompt_segments(catalog, instruction)
        t = t[:pad_to]
        lastpos.append(len(t) - 1)
        toks.append(np.pad(t, (0, pad_to - len(t))))
        labels.append(SY.SLOT_BASE + int(g))
    return (np.stack(toks).astype(np.int32), np.asarray(lastpos, np.int32),
            np.asarray(labels, np.int32))


def ranker_loss(model: T.Transformer, toks: torch.Tensor, lastpos: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy of the gold slot token at each prompt's last
    position (the logits there, in fp32)."""
    sel = T.forward_train(model, toks, rows=lastpos.long())[0].float()      # (B, V)
    gold = torch.gather(sel, 1, labels.long()[:, None])[:, 0]
    return (torch.logsumexp(sel, dim=-1) - gold).mean()


def train_ranker(model: T.Transformer, cfg: LMConfig, catalog: SY.Catalog,
                 instruction: np.ndarray, requests, gold: np.ndarray,
                 steps: int = 200, batch_size: int = 8, lr: float = 3e-3,
                 seed: int = 0, log_every: int = 50):
    """Train `model` in place to rank (CE on the gold slot token after
    RANK_QUERY), `steps` AdamW updates (weight decay 0) on batches of
    `batch_size` requests drawn without replacement from a numpy
    generator seeded with `seed`, as the reference.  Prompts are padded
    to a multiple of 64.  -> (model, [(step, loss)] every `log_every`
    steps and at the last); the parameters are frozen again on return."""
    pad_to = max(len(r.prompt_segments(catalog, instruction)[0]) for r in requests)
    pad_to = ((pad_to + 63) // 64) * 64
    toks_all, last_all, lab_all = _batchify(requests, gold, catalog, instruction, pad_to)
    dev = model.device
    toks_d, last_d, lab_d = (torch.from_numpy(a).to(dev) for a in (toks_all, last_all, lab_all))
    rng = np.random.default_rng(seed)
    history = []
    with trainable(model) as named:
        opt = OPT.get("adamw", named, lr=lr, weight_decay=0.0)
        for s in range(steps):
            idx = torch.from_numpy(rng.choice(len(requests), batch_size,
                                              replace=False)).to(dev)
            for _, p in named:
                p.grad = None
            loss = ranker_loss(model, toks_d[idx], last_d[idx], lab_d[idx])
            loss.backward()
            opt.step()
            if s % log_every == 0 or s == steps - 1:
                history.append((s, float(loss.detach())))
    return model, history
