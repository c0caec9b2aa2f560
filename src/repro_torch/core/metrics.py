"""Ranking metrics: HR@K, MRR, NDCG@K (Table III), and the fidelity of an
approximate ranking to the Full-Recompute one — a numpy copy of the JAX
package's `core/metrics.py`."""
from __future__ import annotations

import numpy as np


def ranks_from_scores(scores: np.ndarray) -> np.ndarray:
    """Higher score = better rank (0 = top)."""
    order = np.argsort(-scores)
    ranks = np.empty_like(order)
    ranks[order] = np.arange(len(scores))
    return ranks


def hr_at_k(rank_of_gold: np.ndarray, k: int) -> float:
    return float((rank_of_gold < k).mean())


def mrr(rank_of_gold: np.ndarray) -> float:
    return float((1.0 / (rank_of_gold + 1)).mean())


def ndcg_at_k(rank_of_gold: np.ndarray, k: int) -> float:
    """Single-relevant-item NDCG (ideal DCG = 1)."""
    gains = np.where(rank_of_gold < k, 1.0 / np.log2(rank_of_gold + 2), 0.0)
    return float(gains.mean())


def table_iii_metrics(rank_of_gold: np.ndarray) -> dict:
    return {
        "HR@1": hr_at_k(rank_of_gold, 1),
        "HR@3": hr_at_k(rank_of_gold, 3),
        "HR@5": hr_at_k(rank_of_gold, 5),
        "HR@10": hr_at_k(rank_of_gold, 10),
        "MRR": mrr(rank_of_gold),
        "NDCG@5": ndcg_at_k(rank_of_gold, 5),
        "NDCG@10": ndcg_at_k(rank_of_gold, 10),
        "NDCG@20": ndcg_at_k(rank_of_gold, 20),
    }


def ranking_agreement_ndcg(ref_scores: np.ndarray, approx_scores: np.ndarray,
                           k: int = 10) -> float:
    """Fidelity of an approximate ranking to the Full-Recompute ranking:
    NDCG@k of the approximate order with the reference order as graded
    truth."""
    n = len(ref_scores)
    ref_rank = ranks_from_scores(ref_scores)
    rel = np.maximum(0.0, np.log2(n) - np.log2(ref_rank + 1))  # graded rel
    order = np.argsort(-approx_scores)
    dcg = sum(rel[order[i]] / np.log2(i + 2) for i in range(min(k, n)))
    ideal_order = np.argsort(-rel)
    idcg = sum(rel[ideal_order[i]] / np.log2(i + 2) for i in range(min(k, n)))
    return float(dcg / max(idcg, 1e-9))
