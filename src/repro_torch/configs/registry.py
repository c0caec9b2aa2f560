"""Architecture registry of the port: the JAX package's LM architectures
(the five assigned and the paper's `rcllm-qwen3-8b`), its four recsys
architectures and SchNet (`configs/registry.py`), their input-shape
cells, and `make_batch`, which fills one cell's inputs (the shapes and
dtypes of the reference's `input_specs`) with seeded random values."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs import (autoint, bert4rec, dien, gemma_7b, kimi_k2_1t_a32b,
                                 moonshot_v1_16b_a3b, nemotron_4_15b, rcllm_qwen3_8b,
                                 schnet, starcoder2_15b, wide_deep)
from repro_torch.configs.base import GNNConfig, LMConfig, RecsysConfig, reduced
from repro_torch.recsys.embedding import mega_table_rows, pad_rows

ARCHS: Dict[str, Union[LMConfig, RecsysConfig, GNNConfig]] = {
    "nemotron-4-15b": nemotron_4_15b.CONFIG,
    "starcoder2-15b": starcoder2_15b.CONFIG,
    "gemma-7b": gemma_7b.CONFIG,
    "kimi-k2-1t-a32b": kimi_k2_1t_a32b.CONFIG,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b.CONFIG,
    "schnet": schnet.CONFIG,
    "dien": dien.CONFIG,
    "wide-deep": wide_deep.CONFIG,
    "autoint": autoint.CONFIG,
    "bert4rec": bert4rec.CONFIG,
    # the paper's own serving model (not one of the assigned cells)
    "rcllm-qwen3-8b": rcllm_qwen3_8b.CONFIG,
}


def family_of(arch: str) -> str:
    cfg = ARCHS[arch]
    if isinstance(cfg, LMConfig):
        return "lm"
    if isinstance(cfg, GNNConfig):
        return "gnn"
    if isinstance(cfg, RecsysConfig):
        return "recsys"
    raise KeyError(arch)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    step: str            # train | prefill | decode | score | retrieval
    dims: Dict[str, int]


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", dict(seq=4096, batch=256)),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", dict(seq=32768, batch=32)),
    "decode_32k": ShapeSpec("decode_32k", "decode", dict(seq=32768, batch=128)),
    "long_500k": ShapeSpec("long_500k", "decode", dict(seq=524288, batch=1)),
}

RECSYS_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "train", dict(batch=65536)),
    "serve_p99": ShapeSpec("serve_p99", "score", dict(batch=512)),
    "serve_bulk": ShapeSpec("serve_bulk", "score", dict(batch=262144)),
    "retrieval_cand": ShapeSpec("retrieval_cand", "retrieval",
                                dict(batch=1, n_candidates=1_000_000)),
}


GNN_SHAPES = {
    "full_graph_sm": ShapeSpec("full_graph_sm", "train",
                               dict(n_nodes=2708, n_edges=10556, d_feat=1433,
                                    n_classes=7)),
    "minibatch_lg": ShapeSpec("minibatch_lg", "train",
                              dict(n_nodes=232_965, n_edges=114_615_892,
                                   batch_nodes=1024, fanout=(15, 10),
                                   d_feat=602, n_classes=41,
                                   # sampled-subgraph padded sizes:
                                   sub_nodes=1024 + 1024 * 15 + 1024 * 15 * 10,
                                   sub_edges=1024 * 15 + 1024 * 15 * 10)),
    "ogb_products": ShapeSpec("ogb_products", "train",
                              dict(n_nodes=2_449_029, n_edges=61_859_140,
                                   d_feat=100, n_classes=47)),
    "molecule": ShapeSpec("molecule", "train",
                          dict(n_nodes=30, n_edges=64, batch=128)),
}

# cells one card cannot hold: ogb_products' radial basis alone is
# (61,859,140 x 300) fp32, 74 GB, before any filter or gradient
MULTI_CARD_CELLS = ("ogb_products",)


def refuse_multi_card(shape_name: str) -> None:
    """Raise for a cell of MULTI_CARD_CELLS."""
    if shape_name in MULTI_CARD_CELLS:
        raise ValueError(f"{shape_name}: waits for the multi-card slice (one card holds "
                         "neither its radial basis nor its gradients)")

# sampled-softmax negatives of BERT4Rec's train cell (the reference's
# input_specs)
BERT4REC_NEGATIVES = 8192

SHAPES = {"lm": LM_SHAPES, "recsys": RECSYS_SHAPES, "gnn": GNN_SHAPES}


def shapes_of(arch: str) -> Dict[str, ShapeSpec]:
    return SHAPES[family_of(arch)]


def get_config(arch: str, smoke: bool = False):
    cfg = ARCHS[arch]
    return reduced(cfg) if smoke else cfg


def lm_kv_cache_shape(cfg: LMConfig, batch: int, seq: int) -> Tuple[int, ...]:
    """Each of the dense cache's k and v: (L, B, S, Hkv, Dh), in cfg.dtype."""
    return (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.resolved_head_dim)


def retrieval_rows(cfg: RecsysConfig) -> int:
    """Rows of the table retrieval scores against: the mega-table for the
    CTR models, the item table for the sequential ones."""
    if cfg.kind == "dien":
        return pad_rows(cfg.n_items)
    if cfg.kind == "bert4rec":
        return pad_rows(cfg.n_items + 2)
    return mega_table_rows(cfg.field_vocabs)


def make_lm_batch(cfg: LMConfig, shape_name: str, generator: torch.Generator,
                  device="cuda", batch: Optional[int] = None,
                  seq: Optional[int] = None) -> Dict:
    """An LM cell's inputs: train `tokens`, `labels (B, S)` (one stream of
    S + 1 tokens shifted by one, as the reference's
    `lm_synthetic_batches`); prefill `tokens (B, S)`; decode `tokens (B,
    1)`, `cache {k, v}` of `lm_kv_cache_shape` and `positions (B,)`.
    Tokens are uniform over the vocabulary, the cache standard normal (the
    reference's decode cell takes an arbitrary cache), positions uniform
    in [S/2, S-8], leaving room for 8 decode steps.  Drawn from
    `generator` on its own device, then moved to `device`."""
    spec = LM_SHAPES[shape_name]
    b = spec.dims["batch"] if batch is None else batch
    s = spec.dims["seq"] if seq is None else seq
    kw = dict(generator=generator, device=generator.device)
    if spec.step == "train":
        toks = torch.randint(0, cfg.vocab_size, (b, s + 1), dtype=torch.int32, **kw)
        return {"tokens": toks[:, :-1].contiguous().to(device),
                "labels": toks[:, 1:].contiguous().to(device)}
    if spec.step == "prefill":
        return {"tokens": torch.randint(0, cfg.vocab_size, (b, s), dtype=torch.int32,
                                        **kw).to(device)}
    shape = lm_kv_cache_shape(cfg, b, s)
    cache = {n: torch.randn(shape, dtype=cfg.torch_dtype, **kw).to(device) for n in "kv"}
    positions = torch.randint(s // 2, max(s // 2, s - 8) + 1, (b,), dtype=torch.int32, **kw)
    return {"tokens": torch.randint(0, cfg.vocab_size, (b, 1), dtype=torch.int32,
                                    **kw).to(device),
            "cache": cache, "positions": positions.to(device)}


def make_gnn_batch(cfg: GNNConfig, shape_name: str, generator: torch.Generator,
                   device="cuda", batch: Optional[int] = None) -> Dict:
    """A SchNet train cell's inputs (`input_specs`' keys, shapes and
    dtypes).  molecule: B molecules of N atoms (types uniform over
    `n_atom_types`, positions normal x 1.5), E edges each between atoms
    of the molecule, the last eighth masked out, targets standard normal.
    full_graph_sm and minibatch_lg: node features standard normal,
    positions normal x 2 (the graphs' synthetic geometry, mostly inside
    the cutoff), edges uniform over the nodes, labels uniform over the
    classes (minibatch_lg: a random graph of the sampled subgraph's
    sizes, the seeds' labels only; `chip_smoke.py` samples the real
    graph through `gnn.sampler`).  `batch` replaces molecule's batch."""
    refuse_multi_card(shape_name)
    d = GNN_SHAPES[shape_name].dims
    kw = dict(generator=generator, device=generator.device)
    if shape_name == "molecule":
        b = d["batch"] if batch is None else batch
        n, e = d["n_nodes"], d["n_edges"]
        mask = torch.ones((b, e), dtype=torch.bool, device=generator.device)
        mask[:, e - e // 8:] = False
        out = {"atom_types": torch.randint(0, cfg.n_atom_types, (b, n), dtype=torch.int32, **kw),
               "positions": torch.randn(b, n, 3, **kw) * 1.5,
               "edge_src": torch.randint(0, n, (b, e), dtype=torch.int32, **kw),
               "edge_dst": torch.randint(0, n, (b, e), dtype=torch.int32, **kw),
               "edge_mask": mask, "targets": torch.randn(b, **kw)}
    else:
        sub = shape_name == "minibatch_lg"
        n, e = (d["sub_nodes"], d["sub_edges"]) if sub else (d["n_nodes"], d["n_edges"])
        out = {"node_feat": torch.randn(n, d["d_feat"], **kw),
               "positions": torch.randn(n, 3, **kw) * 2.0,
               "edge_src": torch.randint(0, n, (e,), dtype=torch.int32, **kw),
               "edge_dst": torch.randint(0, n, (e,), dtype=torch.int32, **kw)}
        labels = torch.randint(0, d["n_classes"], (d["batch_nodes"] if sub else n,),
                               dtype=torch.int32, **kw)
        out["seed_labels" if sub else "labels"] = labels
    return {k: v.to(device) for k, v in out.items()}


def make_batch(cfg, shape_name: str, generator: torch.Generator, device="cuda",
               batch: Optional[int] = None, seq: Optional[int] = None) -> Dict:
    """One cell's inputs, drawn from `generator` on its own device and
    moved to `device`.  LM cells: `make_lm_batch`; GNN cells:
    `make_gnn_batch`.  Recsys cells: ids uniform over each field's
    vocabulary (or over the items and categories), ragged valid lengths
    of at least one position, candidates uniform over the retrieval
    table's rows; train_batch adds labels uniform over {0, 1} or, for
    BERT4Rec, seq_len // 10 masked positions per row with their item
    labels and 8,192 shared negative items (the reference's sampled
    softmax).  `batch` (and, for an LM cell, `seq`) replaces the cell's
    dimension; nothing else changes."""
    if isinstance(cfg, LMConfig):
        return make_lm_batch(cfg, shape_name, generator, device, batch, seq)
    if isinstance(cfg, GNNConfig):
        return make_gnn_batch(cfg, shape_name, generator, device, batch)
    spec = RECSYS_SHAPES[shape_name]
    b = spec.dims["batch"] if batch is None else batch
    kw = dict(generator=generator, device=generator.device)

    def ids(high: int, *shape: int) -> torch.Tensor:
        return torch.randint(0, high, shape, dtype=torch.int32, **kw)

    def prefix_mask(T: int) -> torch.Tensor:
        lens = torch.randint(1, T + 1, (b, 1), **kw)
        return torch.arange(T, device=generator.device)[None] < lens

    out: Dict[str, torch.Tensor] = {}
    if cfg.kind in ("wide_deep", "autoint"):
        out["dense"] = torch.randn(b, cfg.n_dense, **kw)
        out["sparse_ids"] = torch.stack([ids(v, b) for v in cfg.field_vocabs], dim=1)
    elif cfg.kind == "dien":
        T = cfg.seq_len
        out.update(hist_items=ids(cfg.n_items, b, T), hist_cates=ids(cfg.n_cates, b, T),
                   hist_mask=prefix_mask(T), target_item=ids(cfg.n_items, b),
                   target_cate=ids(cfg.n_cates, b))
    elif cfg.kind == "bert4rec":
        out.update(item_seq=ids(cfg.n_items, b, cfg.seq_len),
                   seq_mask=prefix_mask(cfg.seq_len))
    else:
        raise ValueError(cfg.kind)
    if spec.step == "retrieval":
        out["candidate_ids"] = ids(retrieval_rows(cfg), spec.dims["n_candidates"])
    if spec.step == "train":
        if cfg.kind == "bert4rec":
            n_mask = max(1, cfg.seq_len // 10)
            out.update(mlm_positions=ids(cfg.seq_len, b, n_mask),
                       mlm_labels=ids(cfg.n_items, b, n_mask),
                       neg_samples=ids(cfg.n_items, BERT4REC_NEGATIVES))
        else:
            out["labels"] = torch.randint(0, 2, (b,), **kw).float()
    return {k: v.to(device) for k, v in out.items()}
