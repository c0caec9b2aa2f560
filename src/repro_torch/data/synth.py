"""Synthetic recommendation corpus generators.

Shaped to the paper's published statistics (no raw Amazon/Yelp/Goodreads
offline): item token lengths ~87/76/124 (§III-B), Zipf popularity (Fig. 5),
co-occurrence clusters ("books in a series"), reviews drawn from a limited
semantic phrase pool (Insight 1: >93% of history tokens have a near-identical
match in a static pool), 207-token shared system prompt, median prefill
2.2–3.0K tokens with items 66–82% / history 11–26% of the mass (§IV-B).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

# token-id layout for the synthetic vocabulary
PAD, BOS, ITEM_SEP, REVIEW_SEP, RANK_QUERY = 0, 1, 2, 3, 4
SLOT_BASE = 8                 # slot tokens 8..8+64: "answer = candidate #k"
N_SLOTS = 64
N_SPECIAL = SLOT_BASE + N_SLOTS


@dataclass
class Catalog:
    n_items: int
    item_tokens: List[np.ndarray]          # per-item token arrays (immutable)
    popularity: np.ndarray                 # unnormalized access frequency
    cluster_of: np.ndarray                 # co-occurrence cluster id per item
    vocab_size: int

    def item_len(self, i: int) -> int:
        return len(self.item_tokens[i])


@dataclass
class DatasetProfile:
    name: str
    mean_item_tokens: int
    mean_review_tokens: int
    n_items: int
    n_clusters: int
    zipf_a: float = 1.1


PROFILES = {
    "amazon": DatasetProfile("amazon", 87, 80, 20000, 400),
    "yelp": DatasetProfile("yelp", 76, 178, 15000, 300),
    "goodreads": DatasetProfile("goodreads", 124, 95, 18000, 350),
}


def make_catalog(profile: DatasetProfile, vocab_size: int = 8192,
                 seed: int = 0) -> Catalog:
    rng = np.random.default_rng(seed)
    n = profile.n_items
    # each cluster shares a token sub-pool: co-occurring items look alike
    cluster_of = rng.integers(0, profile.n_clusters, n).astype(np.int32)
    lens = np.maximum(8, rng.poisson(profile.mean_item_tokens, n))
    # item tokens live in [N_SPECIAL, vocab/2); reviews own the top half
    item_region = vocab_size // 2 - N_SPECIAL
    pool_per_cluster = min(400, max(32, item_region // 8))
    items = []
    for i in range(n):
        base = N_SPECIAL + (cluster_of[i] * 37) % (item_region - pool_per_cluster)
        toks = base + rng.integers(0, pool_per_cluster, lens[i])
        items.append(toks.astype(np.int32))
    # Zipf popularity over a random item order
    ranks = rng.permutation(n) + 1
    popularity = 1.0 / ranks ** profile.zipf_a
    return Catalog(n_items=n, item_tokens=items, popularity=popularity,
                   cluster_of=cluster_of, vocab_size=vocab_size)


@dataclass
class ReviewPool:
    """Limited semantic phrase pool — reviews are concatenations of shared
    phrases (Insight 1: strong semantic locality in user histories)."""
    phrases: List[np.ndarray]
    sentiment_of: np.ndarray


def make_review_pool(vocab_size: int = 8192, n_phrases: int = 600,
                     seed: int = 1) -> ReviewPool:
    rng = np.random.default_rng(seed)
    phrases, sent = [], []
    band = (vocab_size - vocab_size // 2) // 5     # 5 sentiment bands
    for p in range(n_phrases):
        s = p % 5                                   # 1..5-star sentiment bands
        base = vocab_size // 2 + s * band
        ln = rng.integers(3, 9)
        phrases.append((base + rng.integers(0, max(band - 8, 8), ln))
                       .astype(np.int32))
        sent.append(s)
    return ReviewPool(phrases=phrases, sentiment_of=np.asarray(sent))


def make_review(pool: ReviewPool, mean_tokens: int,
                rng: np.random.Generator) -> np.ndarray:
    toks: List[np.ndarray] = []
    total = 0
    sentiment = rng.integers(0, 5)
    while total < mean_tokens:
        # 80% of phrases drawn from the matching sentiment band
        if rng.random() < 0.8:
            cands = np.where(pool.sentiment_of == sentiment)[0]
        else:
            cands = np.arange(len(pool.phrases))
        ph = pool.phrases[rng.choice(cands)]
        toks.append(ph)
        total += len(ph)
    return np.concatenate(toks)[:int(mean_tokens * 1.5)]


@dataclass
class Request:
    user_id: int
    history_tokens: np.ndarray             # review text (reusable, approx)
    history_marker_mask: np.ndarray        # True at instance-specific tokens
    candidate_items: np.ndarray            # item ids, permuted per request
    arrival_s: float = 0.0

    def prompt_segments(self, catalog: Catalog, instruction: np.ndarray):
        """-> (tokens, seg_kind, seg_id): seg_kind 0=instr 1=history 2=item,
        seg_id = item id for item tokens, -1 otherwise."""
        parts = [instruction]
        kinds = [np.zeros(len(instruction), np.int32)]
        ids = [np.full(len(instruction), -1, np.int32)]
        parts.append(self.history_tokens)
        kinds.append(np.ones(len(self.history_tokens), np.int32))
        ids.append(np.full(len(self.history_tokens), -1, np.int32))
        for slot, it in enumerate(self.candidate_items):
            # slot marker is request-specific (candidates are permuted) →
            # its own segment kind 0: always recomputed, never cached
            parts.append(np.asarray([SLOT_BASE + slot], np.int32))
            kinds.append(np.zeros(1, np.int32))
            ids.append(np.full(1, -1, np.int32))
            toks = np.concatenate([[ITEM_SEP], catalog.item_tokens[it]])
            parts.append(toks.astype(np.int32))
            kinds.append(np.full(len(toks), 2, np.int32))
            ids.append(np.full(len(toks), it, np.int32))
        tail = np.asarray([RANK_QUERY], np.int32)
        parts.append(tail)
        kinds.append(np.zeros(1, np.int32))
        ids.append(np.full(1, -1, np.int32))
        return (np.concatenate(parts), np.concatenate(kinds),
                np.concatenate(ids))


def make_instruction(n_tokens: int = 207, vocab_size: int = 8192,
                     seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([[BOS], N_SPECIAL +
                           rng.integers(0, 200, n_tokens - 1)]).astype(np.int32)


def sample_candidates(catalog: Catalog, n: int, rng: np.random.Generator,
                      cluster_bias: float = 0.7) -> np.ndarray:
    """Candidate sets exhibit co-occurrence: most candidates come from a few
    clusters (this is what similarity-aware placement exploits)."""
    p = catalog.popularity / catalog.popularity.sum()
    anchor = rng.choice(catalog.n_items, p=p)
    anchor_cluster = catalog.cluster_of[anchor]
    out = [anchor]
    while len(out) < n:
        if rng.random() < cluster_bias:
            same = np.where(catalog.cluster_of == anchor_cluster)[0]
            pick = rng.choice(same)
        else:
            pick = rng.choice(catalog.n_items, p=p)
        if pick not in out:
            out.append(int(pick))
    perm = rng.permutation(n)
    return np.asarray(out, np.int32)[perm]


def make_trace(catalog: Catalog, pool: ReviewPool, profile: DatasetProfile,
               n_requests: int, qps: float, n_users: int = 2000,
               n_candidates: int = 20, reviews_per_user: int = 3,
               seed: int = 2, cluster_bias: float = 0.7,
               user_zipf_a: Optional[float] = None,
               long_prompt_frac: float = 0.0,
               long_prompt_reviews: int = 8) -> List[Request]:
    """Synthetic request trace.  `user_zipf_a` switches user sampling
    from uniform to Zipfian (rank r drawn ∝ r^-a): a few heavy repeat
    users dominate the stream — the workload shape where cross-request
    user-history KV reuse pays (serving/workload.zipf_repeat_trace).

    `long_prompt_frac` adds a heavy prompt-length tail: that fraction of
    users carries a lognormal-distributed pile of extra reviews (mean
    `long_prompt_reviews`), so their requests arrive with prompts a few
    times longer than the base population — the long-sequence
    head-of-line interference shape the chunked unified-step scheduler
    targets (serving/workload.heavy_tail_trace).  The default 0.0 draws
    nothing extra from the rng, keeping every pre-existing trace
    byte-identical."""
    rng = np.random.default_rng(seed)
    p_user = None
    if user_zipf_a is not None:
        ranks = np.arange(1, n_users + 1, dtype=np.float64)
        p_user = ranks ** -float(user_zipf_a)
        p_user /= p_user.sum()
    # persistent per-user histories (re-appear across that user's requests)
    user_hist = {}
    for u in range(n_users):
        n_rev = reviews_per_user
        if long_prompt_frac and rng.random() < long_prompt_frac:
            n_rev += max(1, int(rng.lognormal(
                np.log(max(long_prompt_reviews, 1)), 0.5)))
        revs = []
        marks = []
        for _ in range(n_rev):
            r = make_review(pool, profile.mean_review_tokens, rng)
            m = np.zeros(len(r) + 1, bool)
            m[0] = True                       # REVIEW_SEP is instance-specific
            revs.append(np.concatenate([[REVIEW_SEP], r]).astype(np.int32))
            marks.append(m)
        user_hist[u] = (np.concatenate(revs), np.concatenate(marks))

    t = 0.0
    reqs = []
    for _ in range(n_requests):
        t += rng.exponential(1.0 / qps)
        if p_user is None:
            u = int(rng.integers(0, n_users))
        else:
            u = int(rng.choice(n_users, p=p_user))
        hist, mark = user_hist[u]
        reqs.append(Request(
            user_id=u, history_tokens=hist, history_marker_mask=mark,
            candidate_items=sample_candidates(catalog, n_candidates, rng,
                                              cluster_bias=cluster_bias),
            arrival_s=t))
    return reqs
