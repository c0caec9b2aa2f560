"""The reference's own assembly of a prompt (numpy): which cached rows
each token reads, rebuilt from the benchmark's inputs.

A frozen copy of the RcLLM paper's two offline pools as the port builds
them (`core/semantic_cache.py`, `core/assembly.py`): every candidate
item's block is cached (coverage 1), keyed by item id with its tokens at
canonical positions 0..; each history token takes the prototype of its
(position bucket, LSH code) of a position-aware token embedding, when
one exists and its centroid is within cosine 0.85; the review separator
never reuses.  The prototype's rows are its representative token's
(the first corpus token with that key) in its corpus document."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

N_BITS = 12
POS_BUCKET = 64
MAX_POSITION = 4096
MIN_COUNT = 2
N_FEAT = 8
MIN_SIM = 0.85

RECOMPUTE, FROM_ITEM, FROM_SEMANTIC = 0, 1, 2


def position_features(positions: np.ndarray, n_feat: int = N_FEAT,
                      base: float = 10_000.0) -> np.ndarray:
    freqs = 1.0 / base ** (np.arange(n_feat // 2) / (n_feat // 2))
    ang = positions[:, None] * freqs[None, :] * 0.02
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)


def lsh_codes(x: np.ndarray, planes: np.ndarray) -> np.ndarray:
    bits = (x @ planes) > 0
    weights = (1 << np.arange(bits.shape[1], dtype=np.uint64))
    return (bits.astype(np.uint64) * weights).sum(axis=1)


@dataclass
class Prototypes:
    planes: np.ndarray
    key_to_pid: Dict[Tuple[int, int], int]
    centroid: np.ndarray          # (P, d + N_FEAT)
    doc: np.ndarray               # (P,) the representative's corpus document
    offset: np.ndarray            # (P,) its position there
    pos_buckets: int


def build_prototypes(corpus: List[np.ndarray], embed: np.ndarray, seed: int) -> Prototypes:
    """`embed`: the token embedding rows (fp32) of every id the corpus and
    the prompts use."""
    d = embed.shape[1]
    planes = np.random.default_rng(seed).normal(size=(d + N_FEAT, N_BITS)).astype(np.float32)
    pos_buckets = max(1, MAX_POSITION // POS_BUCKET)
    sums, counts, rep = {}, {}, {}
    for doc_id, toks in enumerate(corpus):
        pos = np.arange(len(toks))
        emb = np.concatenate([embed[toks], position_features(pos)], axis=-1)
        pb = np.minimum(pos // POS_BUCKET, pos_buckets - 1)
        codes = lsh_codes(emb, planes)
        for i in range(len(toks)):
            key = (int(pb[i]), int(codes[i]))
            if key not in sums:
                sums[key], counts[key], rep[key] = emb[i].copy(), 1, (doc_id, int(pos[i]))
            else:
                sums[key] += emb[i]
                counts[key] += 1
    keys = [k for k, c in counts.items() if c >= MIN_COUNT]
    centroid = (np.stack([sums[k] / counts[k] for k in keys]).astype(np.float32) if keys
                else np.zeros((0, d + N_FEAT), np.float32))
    return Prototypes(planes, {k: i for i, k in enumerate(keys)}, centroid,
                      np.asarray([rep[k][0] for k in keys], np.int64),
                      np.asarray([rep[k][1] for k in keys], np.int64), pos_buckets)


@dataclass
class Plan:
    tokens: np.ndarray
    seg_kind: np.ndarray
    source: np.ndarray            # RECOMPUTE / FROM_ITEM / FROM_SEMANTIC
    item: np.ndarray              # item id of FROM_ITEM tokens, else -1
    offset: np.ndarray            # position in the item's block
    proto: np.ndarray             # prototype id of FROM_SEMANTIC tokens, else -1

    @property
    def n(self) -> int:
        return len(self.tokens)

    @property
    def have(self) -> np.ndarray:
        return self.source != RECOMPUTE


def plan(request, catalog, instruction: np.ndarray, protos: Prototypes,
         embed: np.ndarray) -> Plan:
    tokens, kind, seg_id = request.prompt_segments(catalog, instruction)
    n = len(tokens)
    source = np.zeros(n, np.int32)
    item = np.full(n, -1, np.int64)
    offset = np.zeros(n, np.int64)
    proto = np.full(n, -1, np.int64)
    for it in np.unique(seg_id[kind == 2]):
        pos = np.where((kind == 2) & (seg_id == it))[0]
        source[pos], item[pos], offset[pos] = FROM_ITEM, it, np.arange(len(pos))
    hist = np.where(kind == 1)[0]
    if len(hist) and len(protos.centroid):
        rel = (hist - hist[0]).astype(np.int64)
        emb = np.concatenate([embed[tokens[hist]], position_features(rel)], axis=-1)
        pb = np.minimum(rel // POS_BUCKET, protos.pos_buckets - 1)
        codes = lsh_codes(emb, protos.planes)
        reusable = ~np.asarray(request.history_marker_mask[:len(hist)], bool)
        for j in range(len(hist)):
            p = protos.key_to_pid.get((int(pb[j]), int(codes[j])), -1)
            if p < 0 or not reusable[j]:
                continue
            a, b = emb[j], protos.centroid[p]
            sim = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))
            if sim >= MIN_SIM:
                source[hist[j]], proto[hist[j]] = FROM_SEMANTIC, p
    return Plan(tokens, kind, source, item, offset, proto)


def select(plan: Plan, attn_mass: np.ndarray, div: np.ndarray, r_item: float,
           r_rev: float, lam: float = 0.5, window: int = 32) -> np.ndarray:
    """Eq. 3 of the RcLLM paper, S = (1 - lam) A / max A + lam D / max D
    over cached tokens, and the recompute set: every token without cached
    rows, the trailing `window`, and the top `ceil(r * class)` scores of
    the item and the history tokens left.  -> (n,) bool."""
    n = plan.n
    have = plan.have
    a = attn_mass / max(attn_mass.max(), 1e-9)
    d = div * have.astype(np.float32)
    d = d / max(d.max(), 1e-9)
    score = (1.0 - lam) * a + lam * d
    rec = ~have.copy()
    rec[max(0, n - window):] = True
    for kind, budget in ((2, r_item), (1, r_rev)):
        cls = np.where((plan.seg_kind == kind) & ~rec)[0]
        if len(cls):
            top = cls[np.argsort(-score[cls])[:int(np.ceil(budget * len(cls)))]]
            rec[top] = True
    return rec
