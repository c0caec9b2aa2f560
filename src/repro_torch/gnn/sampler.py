"""Host-side neighbor sampler for `minibatch_lg` (fanout 15-10): the port's
own numpy copy of the JAX package's `gnn/sampler.py`, which gives the
same arrays for the same seeds.

Builds a CSR adjacency once, then draws uniform fixed-fanout neighbor
samples per seed batch, emitting *padded, fixed-shape* arrays (every
sampled subgraph of one fanout has the same shapes).  Layout of the emitted node array:
  [seeds (B) | hop-1 neighbors (B*f1) | hop-2 neighbors (B*f1*f2)]
and edges connect hop-(i+1) sources to hop-i destinations (local indices).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


class CSRGraph:
    def __init__(self, n_nodes: int, edge_src: np.ndarray, edge_dst: np.ndarray):
        self.n_nodes = n_nodes
        order = np.argsort(edge_dst, kind="stable")
        self.col = edge_src[order].astype(np.int32)
        counts = np.bincount(edge_dst, minlength=n_nodes)
        self.indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    def sample_neighbors(self, nodes: np.ndarray, fanout: int,
                         rng: np.random.Generator) -> np.ndarray:
        """Uniform with-replacement fanout sample: (N,) -> (N, fanout).
        Isolated nodes self-loop."""
        starts = self.indptr[nodes]
        degs = self.indptr[nodes + 1] - starts
        r = rng.integers(0, 1 << 31, size=(len(nodes), fanout))
        safe_deg = np.maximum(degs, 1)
        idx = starts[:, None] + (r % safe_deg[:, None])
        nbrs = self.col[np.minimum(idx, len(self.col) - 1)]
        return np.where(degs[:, None] > 0, nbrs, nodes[:, None]).astype(np.int32)


def sample_subgraph(graph: CSRGraph, seeds: np.ndarray,
                    fanout: Tuple[int, ...],
                    rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """Multi-hop fixed-fanout sample -> padded local-index subgraph."""
    layers = [seeds.astype(np.int32)]
    edge_src_l, edge_dst_l = [], []
    offset = 0
    next_offset = len(seeds)
    frontier = seeds
    for f in fanout:
        nbrs = graph.sample_neighbors(frontier, f, rng)        # (N, f)
        n_new = nbrs.size
        src_local = np.arange(next_offset, next_offset + n_new, dtype=np.int32)
        dst_local = np.repeat(np.arange(offset, offset + len(frontier),
                                        dtype=np.int32), f)
        edge_src_l.append(src_local)
        edge_dst_l.append(dst_local)
        layers.append(nbrs.reshape(-1))
        offset = next_offset
        next_offset += n_new
        frontier = nbrs.reshape(-1)
    nodes = np.concatenate(layers)                             # global ids
    return {"node_ids": nodes,
            "edge_src": np.concatenate(edge_src_l),
            "edge_dst": np.concatenate(edge_dst_l)}


def make_powerlaw_graph(n_nodes: int, n_edges: int,
                        seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic heavy-tailed graph (Zipf-ish degree distribution)."""
    rng = np.random.default_rng(seed)
    # preferential-attachment-flavored sampling without building the graph
    w = 1.0 / np.arange(1, n_nodes + 1) ** 0.75
    w /= w.sum()
    src = rng.choice(n_nodes, size=n_edges, p=w).astype(np.int32)
    dst = rng.integers(0, n_nodes, size=n_edges).astype(np.int32)
    return src, dst
