"""The benchmark's traffic and corpus, made from a seed.

A frozen copy of the port's `data/synth.py` generators (catalog, review
pool, reviews, request traces, the 207-token instruction), kept here so
that a change to the program cannot change the inputs it is measured on.
The token-id layout (`ITEM_SEP`, `SLOT_BASE`, ...) is the serving path's
prompt convention, which the plain reference rebuilds from these inputs.

`world` builds everything one run serves from a traffic file's
parameters and the run's seed.  `due_times` gives an open loop its
schedule: exponential gaps (the distribution's quantiles, so every
schedule offers the same load) in an order drawn from the traffic file's
own `arrival_seed`, so every run replays one arrival trace and runs
differ in what is asked, not in when: in a queue, the order of the gaps
alone moves a tail by more than the bound a cell can hold."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

PAD, BOS, ITEM_SEP, REVIEW_SEP, RANK_QUERY = 0, 1, 2, 3, 4
SLOT_BASE = 8
N_SLOTS = 64
N_SPECIAL = SLOT_BASE + N_SLOTS


@dataclass
class Catalog:
    n_items: int
    item_tokens: List[np.ndarray]
    popularity: np.ndarray
    cluster_of: np.ndarray
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


def make_catalog(profile: DatasetProfile, vocab_size: int = 8192, seed: int = 0) -> Catalog:
    rng = np.random.default_rng(seed)
    n = profile.n_items
    cluster_of = rng.integers(0, profile.n_clusters, n).astype(np.int32)
    lens = np.maximum(8, rng.poisson(profile.mean_item_tokens, n))
    item_region = vocab_size // 2 - N_SPECIAL
    pool_per_cluster = min(400, max(32, item_region // 8))
    items = []
    for i in range(n):
        base = N_SPECIAL + (cluster_of[i] * 37) % (item_region - pool_per_cluster)
        toks = base + rng.integers(0, pool_per_cluster, lens[i])
        items.append(toks.astype(np.int32))
    ranks = rng.permutation(n) + 1
    popularity = 1.0 / ranks ** profile.zipf_a
    return Catalog(n_items=n, item_tokens=items, popularity=popularity,
                   cluster_of=cluster_of, vocab_size=vocab_size)


@dataclass
class ReviewPool:
    phrases: List[np.ndarray]
    sentiment_of: np.ndarray


def make_review_pool(vocab_size: int = 8192, n_phrases: int = 600, seed: int = 1) -> ReviewPool:
    rng = np.random.default_rng(seed)
    phrases, sent = [], []
    band = (vocab_size - vocab_size // 2) // 5
    for p in range(n_phrases):
        s = p % 5
        base = vocab_size // 2 + s * band
        ln = rng.integers(3, 9)
        phrases.append((base + rng.integers(0, max(band - 8, 8), ln)).astype(np.int32))
        sent.append(s)
    return ReviewPool(phrases=phrases, sentiment_of=np.asarray(sent))


def make_review(pool: ReviewPool, mean_tokens: int, rng: np.random.Generator) -> np.ndarray:
    toks: List[np.ndarray] = []
    total = 0
    sentiment = rng.integers(0, 5)
    while total < mean_tokens:
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
    history_tokens: np.ndarray
    history_marker_mask: np.ndarray
    candidate_items: np.ndarray
    arrival_s: float = 0.0

    def prompt_segments(self, catalog: Catalog, instruction: np.ndarray):
        """-> (tokens, seg_kind, seg_id): seg_kind 0 instruction / marker,
        1 history, 2 item; seg_id the item id of item tokens, else -1."""
        parts = [instruction]
        kinds = [np.zeros(len(instruction), np.int32)]
        ids = [np.full(len(instruction), -1, np.int32)]
        parts.append(self.history_tokens)
        kinds.append(np.ones(len(self.history_tokens), np.int32))
        ids.append(np.full(len(self.history_tokens), -1, np.int32))
        for slot, it in enumerate(self.candidate_items):
            parts.append(np.asarray([SLOT_BASE + slot], np.int32))
            kinds.append(np.zeros(1, np.int32))
            ids.append(np.full(1, -1, np.int32))
            toks = np.concatenate([[ITEM_SEP], catalog.item_tokens[it]])
            parts.append(toks.astype(np.int32))
            kinds.append(np.full(len(toks), 2, np.int32))
            ids.append(np.full(len(toks), it, np.int32))
        parts.append(np.asarray([RANK_QUERY], np.int32))
        kinds.append(np.zeros(1, np.int32))
        ids.append(np.full(1, -1, np.int32))
        return np.concatenate(parts), np.concatenate(kinds), np.concatenate(ids)


def make_instruction(n_tokens: int = 207, vocab_size: int = 8192, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([[BOS], N_SPECIAL + rng.integers(0, 200, n_tokens - 1)]).astype(np.int32)


def sample_candidates(catalog: Catalog, n: int, rng: np.random.Generator,
                      cluster_bias: float = 0.7) -> np.ndarray:
    p = catalog.popularity / catalog.popularity.sum()
    anchor = rng.choice(catalog.n_items, p=p)
    anchor_cluster = catalog.cluster_of[anchor]
    out = [anchor]
    while len(out) < n:
        if rng.random() < cluster_bias:
            pick = rng.choice(np.where(catalog.cluster_of == anchor_cluster)[0])
        else:
            pick = rng.choice(catalog.n_items, p=p)
        if pick not in out:
            out.append(int(pick))
    perm = rng.permutation(n)
    return np.asarray(out, np.int32)[perm]


def make_trace(catalog: Catalog, pool: ReviewPool, profile: DatasetProfile,
               n_requests: int, qps: float, n_users: int = 2000,
               n_candidates: int = 20, reviews_per_user: int = 3, seed: int = 2,
               cluster_bias: float = 0.7, user_zipf_a: Optional[float] = None,
               long_prompt_frac: float = 0.0, long_prompt_reviews: int = 8) -> List[Request]:
    rng = np.random.default_rng(seed)
    p_user = None
    if user_zipf_a is not None:
        ranks = np.arange(1, n_users + 1, dtype=np.float64)
        p_user = ranks ** -float(user_zipf_a)
        p_user /= p_user.sum()
    user_hist = {}
    for u in range(n_users):
        n_rev = reviews_per_user
        if long_prompt_frac and rng.random() < long_prompt_frac:
            n_rev += max(1, int(rng.lognormal(np.log(max(long_prompt_reviews, 1)), 0.5)))
        revs, marks = [], []
        for _ in range(n_rev):
            r = make_review(pool, profile.mean_review_tokens, rng)
            m = np.zeros(len(r) + 1, bool)
            m[0] = True
            revs.append(np.concatenate([[REVIEW_SEP], r]).astype(np.int32))
            marks.append(m)
        user_hist[u] = (np.concatenate(revs), np.concatenate(marks))
    t = 0.0
    reqs = []
    for _ in range(n_requests):
        t += rng.exponential(1.0 / qps)
        u = int(rng.integers(0, n_users)) if p_user is None else int(rng.choice(n_users, p=p_user))
        hist, mark = user_hist[u]
        reqs.append(Request(user_id=u, history_tokens=hist, history_marker_mask=mark,
                            candidate_items=sample_candidates(catalog, n_candidates, rng,
                                                              cluster_bias=cluster_bias),
                            arrival_s=t))
    return reqs


# ------------------------------------------------------------------ world
@dataclass
class World:
    """What one run serves: the catalog, the review pool, the history log
    and its corpus (one review history per distinct user: the semantic
    cache's documents), the instruction, and the stream of requests."""
    profile: DatasetProfile
    catalog: Catalog
    pool: ReviewPool
    history: List[Request]
    corpus: List[np.ndarray]
    instruction: np.ndarray
    requests: List[Request]
    lsh_seed: int


def world(traffic: dict, seed: int, n_requests: int) -> World:
    """Every input of one run but the weights, from the traffic file's
    `world` and `requests` parameters and the run's seed.  Sub-streams are
    seeded from `np.random.SeedSequence(seed)`, so any whole number up to
    2**63 works."""
    w, rq = traffic["world"], traffic["requests"]
    s = [int(x) for x in np.random.SeedSequence(int(seed)).generate_state(5, np.uint32)]
    prof = dataclasses.replace(PROFILES[w["profile"]], n_items=w["n_items"],
                               n_clusters=w["n_clusters"])
    catalog = make_catalog(prof, vocab_size=w["vocab_size"], seed=s[0])
    pool = make_review_pool(vocab_size=w["vocab_size"], n_phrases=w["n_phrases"], seed=s[1])
    hist = make_trace(catalog, pool, prof, n_requests=w["history_requests"], qps=10.0,
                      n_users=w["history_users"], n_candidates=rq["n_candidates"],
                      reviews_per_user=rq["reviews_per_user"], seed=s[2],
                      cluster_bias=rq["cluster_bias"])
    corpus, seen = [], set()
    for r in hist:
        if r.user_id not in seen:
            corpus.append(r.history_tokens)
            seen.add(r.user_id)
    reqs = make_trace(catalog, pool, prof, n_requests=n_requests, qps=1.0,
                      n_users=rq["n_users"], n_candidates=rq["n_candidates"],
                      reviews_per_user=rq["reviews_per_user"], seed=s[3],
                      cluster_bias=rq["cluster_bias"])
    instruction = make_instruction(w["instruction_tokens"], w["vocab_size"])
    return World(prof, catalog, pool, hist, corpus, instruction, reqs, s[4] % 2 ** 31)


def arrival_gaps(n: int, rate: float, seed: int) -> np.ndarray:
    """`n` exponential gaps of mean 1/rate: the distribution's quantiles at
    (i + 1/2) / n, in an order drawn from `seed`."""
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    rng = np.random.default_rng(np.random.SeedSequence(int(seed)).generate_state(6, np.uint32)[5])
    return gaps[rng.permutation(n)]


def due_times(seconds: float, rate: float, seed: int) -> np.ndarray:
    """Due times in [0, seconds) of an open loop at `rate` per second."""
    t = np.cumsum(arrival_gaps(max(1, int(round(seconds * rate))), rate, seed))
    return t[t < seconds]
