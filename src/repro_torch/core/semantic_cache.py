"""Semantic-history KV pool (§III-B, first pool).

Three-stage offline pipeline:
  1. Position-aware embedding  e_{t,p} = token_embed[t] ⊕ pos_features(p)
  2. LSH clustering (random-hyperplane signs) → bounded prototype set
  3. KV materialization: each prototype's representative token keeps its
     layer-wise KV states from a real corpus context.

The pool is compact (paper: ~1e5 prototypes ≈ 30 GB for Qwen3-8B, CPU-
resident, replicated on every node — here scaled with the synthetic corpus).
At inference each history token retrieves its nearest prototype; >93% of
tokens in new reviews match near-identically (Insight 1 / Fig. 3b).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.cache_rows import CacheRows


def position_features(positions: np.ndarray, n_feat: int = 8,
                      base: float = 10_000.0) -> np.ndarray:
    """Low-dim sinusoidal position encoding used for position-aware hashing
    (coarse: nearby positions hash together, distant ones do not)."""
    freqs = 1.0 / base ** (np.arange(n_feat // 2) / (n_feat // 2))
    ang = positions[:, None] * freqs[None, :] * 0.02
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)


@dataclass
class LSH:
    planes: np.ndarray                      # (d, n_bits)

    @staticmethod
    def make(d: int, n_bits: int, seed: int = 0) -> "LSH":
        rng = np.random.default_rng(seed)
        return LSH(planes=rng.normal(size=(d, n_bits)).astype(np.float32))

    def codes(self, x: np.ndarray) -> np.ndarray:
        bits = (x @ self.planes) > 0
        weights = (1 << np.arange(bits.shape[1], dtype=np.uint64))
        return (bits.astype(np.uint64) * weights).sum(axis=1)


@dataclass
class SemanticCache:
    lsh: LSH
    pos_buckets: int
    bucket_to_proto: Dict[Tuple[int, int], int]   # (pos_bucket, code) -> pid
    proto_embed: np.ndarray                 # (P, d) centroid embeddings
    proto_token: np.ndarray                 # (P,) representative token id
    proto_position: np.ndarray              # (P,) canonical position
    # layer-wise KV of representatives: (P, L, Hkv, Dh), pre-RoPE keys
    proto_k: Optional[np.ndarray] = None
    proto_v: Optional[np.ndarray] = None
    proto_row: int = -1                     # first row in the device pool

    def size_bytes(self) -> int:
        """Bytes of the prototypes' layer-wise KV (host copies)."""
        return sum(a.nbytes for a in (self.proto_k, self.proto_v) if a is not None)

    @property
    def n_prototypes(self) -> int:
        return len(self.proto_token)

    def match(self, tokens: np.ndarray, positions: np.ndarray,
              embed: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """-> (proto_id or -1, cosine sim) per token."""
        pb = np.minimum(positions // self.bucket_size, self.pos_buckets - 1)
        codes = self.lsh.codes(embed)
        pid = np.full(len(tokens), -1, np.int64)
        sim = np.zeros(len(tokens))
        for i in range(len(tokens)):
            p = self.bucket_to_proto.get((int(pb[i]), int(codes[i])), -1)
            pid[i] = p
            if p >= 0:
                a, b = embed[i], self.proto_embed[p]
                sim[i] = float(a @ b /
                               (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))
        return pid, sim

    bucket_size: int = 64


def build_semantic_cache(
    corpus_tokens: List[np.ndarray],
    token_embed: np.ndarray,                # (V, d) model embedding table
    n_bits: int = 12,
    pos_bucket: int = 64,
    max_position: int = 4096,
    min_count: int = 2,
    seed: int = 0,
) -> SemanticCache:
    """Stages 1–2: position-aware embedding + LSH clustering."""
    d = token_embed.shape[1]
    nf = 8
    lsh = LSH.make(d + nf, n_bits, seed)
    pos_buckets = max(1, max_position // pos_bucket)

    sums: Dict[Tuple[int, int], np.ndarray] = {}
    counts: Dict[Tuple[int, int], int] = {}
    rep: Dict[Tuple[int, int], Tuple[int, int, int]] = {}  # (tok, pos, doc)
    for doc_id, toks in enumerate(corpus_tokens):
        pos = np.arange(len(toks))
        emb = np.concatenate([token_embed[toks],
                              position_features(pos, nf)], axis=-1)
        pb = np.minimum(pos // pos_bucket, pos_buckets - 1)
        codes = lsh.codes(emb)
        for i in range(len(toks)):
            key = (int(pb[i]), int(codes[i]))
            if key not in sums:
                sums[key] = emb[i].copy()
                counts[key] = 1
                rep[key] = (int(toks[i]), int(pos[i]), doc_id)
            else:
                sums[key] += emb[i]
                counts[key] += 1

    keys = [k for k, c in counts.items() if c >= min_count]
    bucket_to_proto = {k: i for i, k in enumerate(keys)}
    proto_embed = np.stack([sums[k] / counts[k] for k in keys]) \
        if keys else np.zeros((0, d + nf), np.float32)
    proto_token = np.asarray([rep[k][0] for k in keys], np.int32)
    proto_position = np.asarray([rep[k][1] for k in keys], np.int32)
    cache = SemanticCache(lsh=lsh, pos_buckets=pos_buckets,
                          bucket_to_proto=bucket_to_proto,
                          proto_embed=proto_embed.astype(np.float32),
                          proto_token=proto_token,
                          proto_position=proto_position)
    cache.bucket_size = pos_bucket
    cache._rep_docs = [rep[k][2] for k in keys]     # for KV materialization
    cache._rep_offsets = [rep[k][1] for k in keys]
    return cache


def materialize_kv(cache: SemanticCache, corpus_tokens: List[np.ndarray],
                   kv_of_sequence: Optional[Callable] = None,
                   kv_by_doc: Optional[Callable[[int], Tuple[np.ndarray, np.ndarray]]] = None,
                   rows: Optional[CacheRows] = None) -> None:
    """Stage 3: run the model over each representative's original review and
    keep the representative token's per-layer (pre-RoPE) K/V.

    Pass either `kv_of_sequence(tokens)` or a precomputed `kv_by_doc(idx)`.
    With `rows`, the prototypes also register their rows (prototype p at
    row `proto_row + p`) for the device pool.
    """
    ks, vs = [], []
    doc_cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for pid in range(cache.n_prototypes):
        doc = cache._rep_docs[pid]
        off = cache._rep_offsets[pid]
        if doc not in doc_cache:
            doc_cache[doc] = kv_by_doc(doc) if kv_by_doc is not None \
                else kv_of_sequence(corpus_tokens[doc])
        k_all, v_all = doc_cache[doc]        # (S, L, Hkv, Dh)
        ks.append(k_all[off])
        vs.append(v_all[off])
    cache.proto_k = np.stack(ks) if ks else None
    cache.proto_v = np.stack(vs) if vs else None
    if rows is not None and ks:
        cache.proto_row = rows.add(cache.proto_k, cache.proto_v)


def embed_tokens_for_match(tokens: np.ndarray, positions: np.ndarray,
                           token_embed: np.ndarray) -> np.ndarray:
    return np.concatenate([token_embed[tokens],
                           position_features(positions, 8)], axis=-1)
